"""Correlation-sensitivity analysis of basket prices, the counterpart of
``dnnpde_tpu/evals/correlation_analysis.py``:

- :class:`RandomCorrelationSensitivityAnalysis`: the basket priced under
  many random correlation matrices, then a PCA of the flattened matrices
  against the prices;
- :func:`equicorrelation_sensitivity`: the price curve over a uniform
  pairwise correlation ρ.

Every scenario is priced on one common (num_paths, D) normal draw (common
random numbers across scenarios, as ``_priced_under_chol`` prices them), in
one batched evaluation on the device, from a ``torch.Generator`` seeded with
``seed``. The matrices come from the port's ``sim/correlation.py``.
scikit-learn (the PCA) and matplotlib (the plot; without it the plot's
arrays go to an ``.npz``) are imported when they are used.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from dnnpde_tpu_torch.runtime import default_device
from dnnpde_tpu_torch.sim.correlation import cholesky_factor, generate_correlation_matrix

Tensor = torch.Tensor


def _priced_under_chol(generator: torch.Generator, S0, K: float, T: float, r: float, sigma,
                       chols: np.ndarray, num_paths: int) -> Tensor:
    """(num_scenarios,) basket-call prices under the Cholesky factors
    ``chols`` (S, D, D), all on one normal draw (num_paths, D) from
    ``generator``, on its device."""
    dev = generator.device
    S0 = torch.atleast_1d(torch.as_tensor(np.asarray(S0, np.float32))).to(dev)
    D = S0.shape[0]
    z = torch.randn((num_paths, D), generator=generator, dtype=torch.float32, device=dev)
    L = torch.as_tensor(np.asarray(chols, np.float32), device=dev)
    zc = torch.einsum("pd,sed->spe", z, L)  # z @ Lᵀ per scenario
    sig = torch.as_tensor(sigma, dtype=torch.float32).to(dev).expand(D)
    ST = S0 * torch.exp((r - 0.5 * sig**2) * T + sig * np.sqrt(T) * zc)
    pay = torch.clamp(torch.mean(ST, dim=-1) - K, min=0.0)
    return np.exp(-r * T) * torch.mean(pay, dim=-1)


@dataclasses.dataclass
class RandomCorrelationSensitivityAnalysis:
    """Price dispersion over random correlation matrices and its PCA
    structure. ``device``: None = the first CUDA card (raises without one);
    "cpu" prices on the CPU."""

    n: int
    r: float = 0.05
    sigma: float = 0.2
    T: float = 1.0
    K: float = 1.0
    S0: Optional[np.ndarray] = None
    device: object = None

    def run_analysis(self, correlation_type: str = "random_correlation",
                     num_simulations: int = 10_000, num_samples: int = 100,
                     seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """(option prices (num_samples,), flattened correlation matrices
        (num_samples, n²)); matrix i is drawn with seed ``seed + i``."""
        S0 = self.S0 if self.S0 is not None else np.ones(self.n)
        mats, chols = [], []
        for i in range(num_samples):
            C = generate_correlation_matrix(self.n, correlation_type, seed=seed + i)
            mats.append(C.flatten())
            chols.append(cholesky_factor(C))
        gen = torch.Generator(device=default_device(self.device)).manual_seed(seed)
        prices = _priced_under_chol(gen, S0, self.K, self.T, self.r, self.sigma,
                                    np.stack(chols), num_simulations)
        return prices.cpu().numpy(), np.stack(mats)

    def pca_components(self, correlation_matrices: np.ndarray,
                       n_components: int = 2) -> tuple[np.ndarray, np.ndarray]:
        """PCA of the flattened matrices: (components (num_samples, k),
        explained variance ratios)."""
        from sklearn.decomposition import PCA

        pca = PCA(n_components=n_components)
        comps = pca.fit_transform(correlation_matrices)
        return comps, pca.explained_variance_ratio_

    def plot_pca_results(self, option_prices, correlation_matrices, save_path: str,
                         n_components: int = 2) -> str:
        """The prices against the principal components, as a PNG at
        ``save_path`` (without matplotlib: the arrays, at its stem +
        ``.npz``). Returns the path written."""
        comps, _ = self.pca_components(correlation_matrices, n_components)
        try:
            import matplotlib
        except ImportError:
            path = os.path.splitext(save_path)[0] + ".npz"
            np.savez(path, components=comps, option_prices=np.asarray(option_prices))
            return path
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(10, 6))
        if n_components == 1:
            plt.scatter(comps[:, 0], option_prices, c="blue", edgecolor="black")
            plt.xlabel("Principal Component 1")
            plt.ylabel("Option Price")
        else:
            sc = plt.scatter(comps[:, 0], comps[:, 1], c=option_prices, cmap="viridis",
                             edgecolor="black")
            plt.colorbar(sc, label="Option Price")
            plt.xlabel("Principal Component 1")
            plt.ylabel("Principal Component 2")
        plt.title(f"PCA: option prices vs correlation structure (n={self.n})")
        plt.grid(True)
        plt.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close()
        return save_path


def equicorrelation_sensitivity(S0, K: float, T: float, r: float, sigma: float,
                                correlation_range: Sequence[float], num_simulations: int = 10_000,
                                seed: int = 0, device=None) -> np.ndarray:
    """Basket price against a uniform pairwise correlation ρ, all ρ priced
    on common random numbers. ``device``: None = the first CUDA card."""
    S0 = np.atleast_1d(np.asarray(S0, np.float32))
    D = S0.shape[0]
    chols = []
    for rho in correlation_range:
        C = np.full((D, D), float(rho))
        np.fill_diagonal(C, 1.0)
        chols.append(cholesky_factor(C))
    gen = torch.Generator(device=default_device(device)).manual_seed(seed)
    return _priced_under_chol(gen, S0, K, T, r, sigma, np.stack(chols),
                              num_simulations).cpu().numpy()
