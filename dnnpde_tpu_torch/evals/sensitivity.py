"""Hyperparameter sensitivity analysis: HSIC, rank correlation, permutation
importance, and the sampling and simulation around them, the counterpart of
``dnnpde_tpu/evals/sensitivity.py``.

- :func:`hsic_rbf`: HSIC with RBF kernels, median-heuristic bandwidths and
  centered Gram matrices, in float32 on the device. The median of the n²
  distances is the mean of the two middle values when n² is even, as
  ``jnp.median`` takes it (``torch.median`` returns the lower one), so it is
  taken with ``torch.quantile``.
- :func:`sample_hyperparameters`, :func:`simulate_performance`,
  :func:`spearman_rank_correlation`: numpy, as in the reference.
- :func:`permutation_importance` imports scikit-learn when it is called.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dnnpde_tpu_torch.runtime import default_device


def hsic_rbf(x, y, device=None) -> float:
    """Biased HSIC estimate with RBF kernels and median-heuristic
    bandwidths: HSIC = Σᵢⱼ (HK_XH)ᵢⱼ(HK_YH)ᵢⱼ / n². ``device``: None = the
    first CUDA card (raises without one); "cpu" computes on the CPU."""
    dev = default_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev).reshape(-1, 1)
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev).reshape(-1, 1)
    n = x.shape[0]

    def gram(v):
        d = torch.abs(v - v.T)
        med = torch.quantile(d.reshape(-1), 0.5)
        med = torch.where(med <= 0, torch.ones_like(med), med)
        return torch.exp(-(d**2) / (2 * med**2))

    kx, ky = gram(x), gram(y)
    h = torch.eye(n, device=dev) - torch.ones((n, n), device=dev) / n
    kxc = h @ kx @ h
    kyc = h @ ky @ h
    return float(torch.sum(kxc * kyc) / n**2)


def spearman_rank_correlation(x: np.ndarray, y: np.ndarray) -> float:
    """Rank-correlation sensitivity proxy (the reference
    ``FastSensitivityExecutor``'s "HSIC")."""
    rx = np.argsort(np.argsort(x)).astype(np.float64)
    ry = np.argsort(np.argsort(y)).astype(np.float64)
    rx = (rx - rx.mean()) / (rx.std() + 1e-12)
    ry = (ry - ry.mean()) / (ry.std() + 1e-12)
    return float(np.mean(rx * ry))


def permutation_importance(
    hyperparams: dict[str, np.ndarray],
    performance: np.ndarray,
    n_repeats: int = 10,
    seed: int = 0,
) -> dict[str, float]:
    """Permutation importance against a random-forest surrogate of the
    performance surface (needs scikit-learn, imported here)."""
    from sklearn.ensemble import RandomForestRegressor
    from sklearn.inspection import permutation_importance as sk_pi

    names = list(hyperparams)
    X = np.stack([np.asarray(hyperparams[k], np.float64) for k in names], axis=1)
    y = np.asarray(performance, np.float64)
    model = RandomForestRegressor(n_estimators=50, random_state=seed).fit(X, y)
    result = sk_pi(model, X, y, n_repeats=n_repeats, random_state=seed)
    return dict(zip(names, result.importances_mean.tolist()))


def sample_hyperparameters(rng: np.random.Generator) -> dict[str, float]:
    """Log-uniform learning rates, uniform iteration counts."""
    def logu(lo, hi):
        return float(10 ** rng.uniform(np.log10(lo), np.log10(hi)))

    return {
        "initial_lr": logu(1e-6, 1e-2),
        "fine_tuning_lr": logu(1e-7, 1e-3),
        "initial_n_iter": int(rng.integers(5000, 30000)),
        "fine_tuning_n_iter": int(rng.integers(1000, 6000)),
    }


def simulate_performance(hyperparams: dict[str, np.ndarray], rng: np.random.Generator) -> np.ndarray:
    """Synthetic performance model: quadratic bowls in log-lr, log gains in
    the iteration counts and N(0, 2) noise; lower is better."""
    perf = (
        -20 * (np.log10(hyperparams["initial_lr"]) + 4) ** 2
        + -10 * (np.log10(hyperparams["fine_tuning_lr"]) + 5) ** 2
        + np.log(hyperparams["initial_n_iter"]) * 2
        + np.log(hyperparams["fine_tuning_n_iter"])
    )
    return -(perf + rng.normal(0, 2, np.shape(perf)))


@dataclasses.dataclass
class SensitivityAnalyzer:
    """HSIC scores per hyperparameter, on ``device`` (None: the first CUDA
    card)."""

    device: object = None

    def calculate_hsic(self, hyperparams: dict[str, np.ndarray],
                       performance: np.ndarray) -> dict[str, float]:
        return {k: hsic_rbf(v, performance, self.device) for k, v in hyperparams.items()}

    def analyze(self, results: list[dict]) -> tuple[dict[str, float], dict[str, np.ndarray],
                                                    np.ndarray]:
        hyperparams = {k: np.array([r["hyperparams"][k] for r in results])
                       for k in results[0]["hyperparams"]}
        performance = np.array([r["performance"] for r in results])
        return self.calculate_hsic(hyperparams, performance), hyperparams, performance


@dataclasses.dataclass
class FastSensitivityAnalysis:
    """Synthetic-model sensitivity sweep: draw samples, score them with the
    synthetic performance model, report HSIC (on ``device``), rank
    correlation and permutation importance."""

    num_samples: int = 1000
    seed: int = 0
    device: object = None

    def run(self) -> dict[str, dict[str, float]]:
        dev = default_device(self.device)
        rng = np.random.default_rng(self.seed)
        initial_lr = rng.uniform(1e-6, 1e-2, self.num_samples)
        hp = {
            "initial_lr": initial_lr,
            "fine_tuning_lr": initial_lr * rng.uniform(0.1, 0.5, self.num_samples),
            "initial_n_iter": rng.integers(20000, 100000, self.num_samples).astype(float),
            "fine_tuning_n_iter": rng.integers(5000, 20000, self.num_samples).astype(float),
        }
        perf = simulate_performance(hp, rng)
        return {
            "hsic": {k: hsic_rbf(v, perf, dev) for k, v in hp.items()},
            "rank_correlation": {k: spearman_rank_correlation(v, perf) for k, v in hp.items()},
            "permutation_importance": permutation_importance(hp, perf),
        }
