"""Evaluation layer: greeks, error metrics, prediction sampling, the policy
value of optimal-stopping nets, the neural control variate, the plots, the
results reports, the stability analysis, the hyperparameter sensitivity
analysis and the correlation-sensitivity analysis of basket prices."""

from dnnpde_tpu_torch.evals.control_variate import (
    NeuralCVValue,
    neural_cv_from_trainer,
    neural_cv_value,
)
from dnnpde_tpu_torch.evals.correlation_analysis import (
    RandomCorrelationSensitivityAnalysis,
    equicorrelation_sensitivity,
)
from dnnpde_tpu_torch.evals.greeks import compute_greeks, heston_greeks, learned_price_surface
from dnnpde_tpu_torch.evals.metrics import (
    ConvergenceAnalysis,
    error_stats,
    relative_l2_error,
    squared_errors,
)
from dnnpde_tpu_torch.evals.policy_value import (
    PolicyValue,
    policy_value,
    policy_value_from_trainer,
)
from dnnpde_tpu_torch.evals.plots import TrainingPlot, figsize
from dnnpde_tpu_torch.evals.predictions import PredictionGenerator, PredictionResult
from dnnpde_tpu_torch.evals.reports import RESULT_COLUMNS, ResultsReport, quality_row
from dnnpde_tpu_torch.evals.sensitivity import (
    FastSensitivityAnalysis,
    SensitivityAnalyzer,
    hsic_rbf,
    permutation_importance,
    sample_hyperparameters,
    simulate_performance,
    spearman_rank_correlation,
)
from dnnpde_tpu_torch.evals.stability import StabilityCheck

__all__ = [
    "NeuralCVValue",
    "neural_cv_from_trainer",
    "neural_cv_value",
    "TrainingPlot",
    "figsize",
    "ConvergenceAnalysis",
    "error_stats",
    "relative_l2_error",
    "squared_errors",
    "PredictionGenerator",
    "PredictionResult",
    "RESULT_COLUMNS",
    "ResultsReport",
    "quality_row",
    "StabilityCheck",
    "FastSensitivityAnalysis",
    "SensitivityAnalyzer",
    "hsic_rbf",
    "permutation_importance",
    "sample_hyperparameters",
    "simulate_performance",
    "spearman_rank_correlation",
    "RandomCorrelationSensitivityAnalysis",
    "equicorrelation_sensitivity",
    "compute_greeks",
    "heston_greeks",
    "learned_price_surface",
    "PolicyValue",
    "policy_value",
    "policy_value_from_trainer",
]
