"""Error metrics and convergence analysis (NumPy), a copy of
``dnnpde_tpu/evals/metrics.py``: squared-error mean/std and RMSE, the
relative L2 error, and L1/L2/L∞ errors per epoch.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def squared_errors(pred: np.ndarray, exact: np.ndarray) -> np.ndarray:
    return (np.asarray(pred) - np.asarray(exact)) ** 2


def error_stats(pred: np.ndarray, exact: np.ndarray) -> dict[str, float]:
    """Mean/std of squared error + RMSE (the reference's CSV columns)."""
    se = squared_errors(pred, exact)
    return {
        "mean_error": float(se.mean()),
        "std_error": float(se.std()),
        "rmse": float(np.sqrt(se.mean())),
    }


def relative_l2_error(pred: np.ndarray, exact: np.ndarray, axis=None) -> np.ndarray:
    """‖pred − exact‖₂ / ‖exact‖₂ (the reference's per-time L2 error curve)."""
    pred, exact = np.asarray(pred), np.asarray(exact)
    num = np.sqrt(np.sum((pred - exact) ** 2, axis=axis))
    den = np.sqrt(np.sum(exact**2, axis=axis))
    return num / np.maximum(den, 1e-12)


@dataclasses.dataclass
class ConvergenceAnalysis:
    """L1/L2/L∞ errors per epoch (reference ``ConvergenceAnalysis``,
    ``with_corr_high_dimension_pde.py:1054-1100``).

    ``predictions``: sequence of per-epoch predicted arrays; ``exact``: the
    target array (broadcast against each prediction).
    """

    predictions: list[np.ndarray]
    exact: np.ndarray

    def calculate_errors(self) -> dict[str, np.ndarray]:
        l1, l2, linf = [], [], []
        ex = np.asarray(self.exact)
        for p in self.predictions:
            d = np.abs(np.asarray(p) - ex)
            l1.append(d.mean())
            l2.append(np.sqrt((d**2).mean()))
            linf.append(d.max())
        return {
            "L1": np.asarray(l1),
            "L2": np.asarray(l2),
            "Linf": np.asarray(linf),
        }
