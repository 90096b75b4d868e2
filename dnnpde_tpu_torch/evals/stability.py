"""Stability analysis: initial-condition perturbations and the spectral
radius of the input Jacobian, the counterpart of
``dnnpde_tpu/evals/stability.py``.

(a) perturb Xi by ε·N(0,1) over a range (default linspace(0, 0.8, 10)) and
    measure the mean relative error of the re-predicted Y paths;
(b) spectral radius of the Jacobian ∂u/∂X at sampled states: for the
    scalar-output net the Jacobian is the row ∇ₓu (the solver's Z), so its
    largest singular value is ‖Z‖₂, from one batched net_u evaluation;
(c) ‖∇ₓu‖ surfaces over a (t, S) grid. JAX evaluates each grid point as a
    batch of one; a stochastic net therefore sees the batch-of-one noise
    row at every point, and so it does here.

The random draws (the perturbations' normals excepted, which are numpy's as
in JAX) come from ``torch.Generator`` objects seeded with ``seed`` on the
trainer's device where JAX takes ``PRNGKey(seed)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from dnnpde_tpu_torch.nets import SDENet


@dataclasses.dataclass
class StabilityCheck:
    """Perturbation and spectral-radius stability analysis of a trained
    model (a :class:`~dnnpde_tpu_torch.train.Trainer`)."""

    trainer: object
    Xi: Optional[np.ndarray] = None
    perturbation_range: Sequence[float] = tuple(np.linspace(0.0, 0.8, 10))
    seed: int = 0
    num_points: int = 100

    def __post_init__(self):
        if self.Xi is None:
            self.Xi = np.asarray(self.trainer.problem.x0)[None, :]
        else:
            self.Xi = np.asarray(self.Xi).reshape(1, -1)

    # ------------------------------------------------------ (a) perturbations
    def generate_perturbations(self) -> list[np.ndarray]:
        """Xi + ε·N(0,1) per ε."""
        rng = np.random.default_rng(self.seed)
        return [self.Xi + eps * rng.standard_normal(self.Xi.shape)
                for eps in self.perturbation_range]

    def evaluate_perturbations(self, perturbations: Sequence[np.ndarray], t_test, W_test
                               ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Re-predict along fixed (t, W) paths from each perturbed start."""
        return [self.trainer.predict(xi, t_test, W_test) for xi in perturbations]

    def calculate_relative_errors(self, predictions, Y_test: np.ndarray) -> list[float]:
        """Mean |Y_pred − Y_test| / |Y_test| per perturbation level."""
        Y_test = np.asarray(Y_test).squeeze()
        out = []
        for _, Y_pred in predictions:
            yp = np.asarray(Y_pred).squeeze()
            out.append(float(np.abs((yp - Y_test) / np.maximum(np.abs(Y_test), 1e-12)).mean()))
        return out

    def run_perturbation_analysis(self, t_test=None, W_test=None) -> list[float]:
        """End-to-end (a): relative errors per ε. Without given paths, one
        minibatch is drawn from a generator seeded ``seed``."""
        if t_test is None or W_test is None:
            gen = torch.Generator(device=self.trainer.device).manual_seed(self.seed)
            t_test, W_test = self.trainer.fetch_minibatch(generator=gen)
        _, Y_base = self.trainer.predict(self.Xi, t_test, W_test)
        preds = self.evaluate_perturbations(self.generate_perturbations(), t_test, W_test)
        return self.calculate_relative_errors(preds, Y_base)

    # ---------------------------------------------------- (b) spectral radius
    def _z_norms(self, t: torch.Tensor, X: torch.Tensor, noise=None) -> np.ndarray:
        with torch.no_grad():
            _, Z = self.trainer.net_u(t, X, noise)
        return torch.linalg.norm(Z, dim=-1).cpu().numpy()

    def spectral_radii(self, X, t: float = 0.0) -> np.ndarray:
        """Spectral radius of ∂u/∂X (= ‖∇ₓu‖₂) at each row of X, in one
        batched evaluation."""
        X = torch.as_tensor(np.asarray(X, np.float32)).to(self.trainer.device)
        return self._z_norms(torch.full((X.shape[0], 1), float(t), device=X.device), X)

    def evaluate_stability(self, t: float = 0.0) -> np.ndarray:
        """Spectral radii at ``num_points`` uniform samples in [−1, 1]^D."""
        dev = self.trainer.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        X = torch.rand((self.num_points, self.trainer.problem.dim), generator=gen,
                       device=dev) * 2.0 - 1.0
        return self.spectral_radii(X.cpu().numpy(), t)

    def stable_percentage(self, radii: Optional[np.ndarray] = None) -> float:
        """% of sampled points with spectral radius < 1."""
        if radii is None:
            radii = self.evaluate_stability()
        return float((np.asarray(radii) < 1.0).mean() * 100.0)

    # ---------------------------------------------------- (c) Jacobian surface
    def jacobian_surface(self, t_values: np.ndarray, s_values: np.ndarray, dim: int = 0
                         ) -> np.ndarray:
        """‖∇ₓu‖ over a (t, S) grid, varying state component ``dim`` with
        the others held at x0. Returns (len(t), len(s))."""
        dev = self.trainer.device
        t = torch.as_tensor(np.asarray(t_values, np.float32)).reshape(-1)
        s = torch.as_tensor(np.asarray(s_values, np.float32)).reshape(-1)
        nt, ns = t.shape[0], s.shape[0]
        X = self.trainer.problem.x0.to(torch.float32).repeat(nt * ns, 1)
        X[:, dim] = s.repeat(nt)
        tcol = t.repeat_interleave(ns)[:, None]
        net = self.trainer.params
        row = net.eval_noise(1, dev) if isinstance(net, SDENet) else None
        noise = None if row is None else [n.expand(nt * ns, -1) for n in row]
        return self._z_norms(tcol.to(dev), X.to(dev), noise).reshape(nt, ns)

    def smoothed_jacobian_surface(
        self, t_values: np.ndarray, s_values: np.ndarray, dim: int = 0, upsample: int = 100,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The reference's presentation of the Jacobian surface: Gaussian
        filter (σ = 2) → cubic ``griddata`` upsample to ``upsample``² →
        light Gaussian (σ = 0.5). Returns (t_new, s_new, Z_new)."""
        from scipy.interpolate import griddata
        from scipy.ndimage import gaussian_filter

        raw = self.jacobian_surface(t_values, s_values, dim=dim)
        smoothed = gaussian_filter(raw, sigma=2)
        S, Tg = np.meshgrid(s_values, t_values)
        s_new = np.linspace(float(s_values[0]), float(s_values[-1]), upsample)
        t_new = np.linspace(float(t_values[0]), float(t_values[-1]), upsample)
        S_new, T_new = np.meshgrid(s_new, t_new)
        Z_new = griddata((S.ravel(), Tg.ravel()), smoothed.ravel(), (S_new, T_new),
                         method="cubic")
        Z_new = gaussian_filter(np.nan_to_num(Z_new), sigma=0.5)
        return t_new, s_new, Z_new
