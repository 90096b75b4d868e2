"""Evaluation layer ported so far: greeks, error metrics and prediction
sampling. The rest of the JAX package's ``evals`` is listed in ROADMAP.md,
Queue 1."""

from dnnpde_tpu_torch.evals.greeks import compute_greeks, heston_greeks, learned_price_surface
from dnnpde_tpu_torch.evals.metrics import (
    ConvergenceAnalysis,
    error_stats,
    relative_l2_error,
    squared_errors,
)
from dnnpde_tpu_torch.evals.predictions import PredictionGenerator, PredictionResult

__all__ = [
    "ConvergenceAnalysis",
    "error_stats",
    "relative_l2_error",
    "squared_errors",
    "PredictionGenerator",
    "PredictionResult",
    "compute_greeks",
    "heston_greeks",
    "learned_price_surface",
]
