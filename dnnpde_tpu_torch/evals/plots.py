"""Plotting suite, the counterpart of ``dnnpde_tpu/evals/plots.py``: the
reference's ``TrainingPlot`` methods (training loss, sampled paths,
exact-vs-learned overlays, L2 error, Y0 evolution, Heston surfaces, the IV
smile, the Jacobian surface, stability curves, spectral radii, the error
heatmap, convergence), each saving a PNG named with the reference's
``{kind}_{mode}_{activation}_{optimizer}`` convention.

matplotlib is imported (with the Agg backend) inside the methods, never at
import. Where it is not installed, each method writes the arrays it would
have drawn to an ``.npz`` with the PNG's stem instead and returns that
path: the port's one deliberate deviation from the JAX package here.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np


def figsize(scale: float = 1.0, nplots: int = 1) -> list[float]:
    """Golden-ratio figure size from a 438.17227pt LaTeX column."""
    fig_width_pt = 438.17227
    inches_per_pt = 1.0 / 72.27
    golden_mean = (np.sqrt(5.0) - 1.0) / 2.0
    fig_width = fig_width_pt * inches_per_pt * scale
    return [fig_width, nplots * fig_width * golden_mean]


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class TrainingPlot:
    """Mirror of the reference ``TrainingPlot`` API; every method writes a PNG
    (or, without matplotlib, an ``.npz`` of its arrays) under ``save_path``
    and returns the path."""

    def __init__(self, save_path: str):
        self.save_path = save_path
        os.makedirs(save_path, exist_ok=True)

    @staticmethod
    def have_matplotlib() -> bool:
        return _pyplot() is not None

    def _emit(self, name: str, arrays: dict, draw: Callable) -> str:
        """Draw with ``draw(plt)`` and save ``name`` (a PNG), or save
        ``arrays`` to ``name``'s stem + ``.npz`` without matplotlib."""
        plt = _pyplot()
        path = os.path.join(self.save_path, name)
        if plt is None:
            path = os.path.splitext(path)[0] + ".npz"
            np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
            return path
        draw(plt)
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()
        return path

    def plot_training_loss(self, graph, mode, activation, optimizer) -> str:
        """Loss vs iteration, log-y."""
        graph = np.asarray(graph)

        def draw(plt):
            plt.figure(figsize=figsize(1.0))
            plt.plot(graph[0], graph[1])
            plt.yscale("log")
            plt.xlabel("Iteration")
            plt.ylabel("Training loss")
            plt.title(f"Training loss — {mode}-{activation}, {optimizer}")

        return self._emit(f"TrainingLoss_{mode}_{activation}_{optimizer}.png",
                          {"iteration": graph[0], "loss": graph[1]}, draw)

    def plot_prediction(self, t_test, Y_pred, mode, activation, optimizer,
                        n_paths: int = 8) -> str:
        """Sampled predicted Y paths."""
        t = np.asarray(t_test)[:, :, 0]
        y = np.asarray(Y_pred)[:, :, 0]
        k = min(n_paths, y.shape[0])

        def draw(plt):
            plt.figure(figsize=figsize(1.0))
            for i in range(k):
                plt.plot(t[i], y[i], lw=0.8)
            plt.xlabel("t")
            plt.ylabel("Y(t)")
            plt.title(f"Predicted paths — {mode}-{activation}")

        return self._emit(f"Preds_{mode}_{activation}_{optimizer}.png",
                          {"t": t[:k], "Y": y[:k]}, draw)

    def plot_exact_vs_learned(self, t_test, Y_pred, Y_exact, mode, activation, optimizer,
                              n_paths: int = 5) -> str:
        """Learned vs exact overlays."""
        t = np.asarray(t_test)[:, :, 0]
        yp = np.asarray(Y_pred)[:, :, 0]
        ye = np.asarray(Y_exact).reshape(yp.shape[0], -1)
        k = min(n_paths, yp.shape[0])

        def draw(plt):
            plt.figure(figsize=figsize(1.0))
            for i in range(k):
                plt.plot(t[i], yp[i], "b", lw=0.8, label="learned" if i == 0 else None)
                plt.plot(t[i], ye[i], "r--", lw=0.8, label="exact" if i == 0 else None)
            plt.xlabel("t")
            plt.ylabel("Y(t)")
            plt.legend()
            plt.title(f"Exact vs learned — {mode}-{activation}")

        return self._emit(f"ExactVsLearned_{mode}_{activation}_{optimizer}.png",
                          {"t": t[:k], "Y_learned": yp[:k], "Y_exact": ye[:k]}, draw)

    def plot_l2_error(self, t_grid, rel_errors, mode, activation, optimizer) -> str:
        """Relative L2 error over time, semilog-y."""
        t_grid, rel_errors = np.asarray(t_grid), np.asarray(rel_errors)

        def draw(plt):
            plt.figure(figsize=figsize(1.0))
            plt.semilogy(t_grid, rel_errors)
            plt.xlabel("t")
            plt.ylabel("relative $L_2$ error")
            plt.title(f"L2 error — {mode}-{activation}")

        return self._emit(f"L2Error_{mode}_{activation}_{optimizer}.png",
                          {"t": t_grid, "rel_error": rel_errors}, draw)

    def plot_y0_evolution(self, iterations, y0_values, exact_y0=None, name="Y0") -> str:
        """Y0 estimate per log point, with the exact value as a line."""
        iterations, y0_values = np.asarray(iterations), np.asarray(y0_values)
        arrays = {"iteration": iterations, "y0": y0_values}
        if exact_y0 is not None:
            arrays["exact_y0"] = np.asarray(exact_y0)

        def draw(plt):
            plt.figure(figsize=figsize(1.0))
            plt.plot(iterations, y0_values, label="learned Y0")
            if exact_y0 is not None:
                plt.axhline(exact_y0, color="r", ls="--", label="exact")
            plt.xlabel("Iteration")
            plt.ylabel("$Y_0$")
            plt.legend()

        return self._emit(f"{name}_evolution.png", arrays, draw)

    def plot_heston_surfaces(self, S_values, V_values, price, delta, gamma,
                             name="Heston") -> str:
        """Price/Δ/Γ 3-D surfaces over (S, v)."""
        S_values, V_values = np.asarray(S_values), np.asarray(V_values)
        grids = [np.asarray(g) for g in (price, delta, gamma)]

        def draw(plt):
            _, axs = plt.subplots(1, 3, figsize=(18, 6), subplot_kw={"projection": "3d"})
            S, V = np.meshgrid(S_values, V_values)
            for ax, grid, title in zip(axs, grids, ["Price", "Delta", "Gamma"]):
                ax.plot_surface(S, V, grid.T, cmap="viridis")
                ax.set_xlabel("S")
                ax.set_ylabel("v")
                ax.set_title(title)
                ax.view_init(elev=30, azim=130)

        return self._emit(f"{name}_surfaces.png",
                          {"S": S_values, "v": V_values, "price": grids[0], "delta": grids[1],
                           "gamma": grids[2]}, draw)

    def plot_iv_smile(self, strikes, model_iv, oracle_iv, discrete_iv=None,
                      name="Heston") -> str:
        """Implied-volatility smile: model vs the closed form (and, optionally,
        the exact discrete-N BSDE oracle)."""
        strikes, model_iv, oracle_iv = (np.asarray(a) for a in (strikes, model_iv, oracle_iv))
        arrays = {"strike": strikes, "model_iv": model_iv, "oracle_iv": oracle_iv}
        if discrete_iv is not None:
            arrays["discrete_iv"] = np.asarray(discrete_iv)

        def draw(plt):
            plt.figure(figsize=figsize(1.0))
            plt.plot(strikes, 100 * oracle_iv, "k-", lw=2, label="closed form")
            if discrete_iv is not None:
                plt.plot(strikes, 100 * arrays["discrete_iv"], "k--", lw=1,
                         label="discrete-N oracle")
            plt.plot(strikes, 100 * model_iv, "o-", ms=4, label="model")
            plt.xlabel("Strike K (S0 = 1)")
            plt.ylabel("Implied vol (%)")
            plt.title("IV smile — model vs oracle")
            plt.legend()
            plt.grid(alpha=0.3)

        return self._emit(f"{name}_iv_smile.png", arrays, draw)

    def plot_jacobian_surface(self, t_values, s_values, Z, name="Jacobian",
                              title="‖∇ₓu‖") -> str:
        """3-D Jacobian-norm surface with base contours."""
        t_values, s_values, Z = (np.asarray(a) for a in (t_values, s_values, Z))

        def draw(plt):
            fig = plt.figure(figsize=(8, 6))
            ax = fig.add_subplot(projection="3d")
            S, T = np.meshgrid(s_values, t_values)
            ax.plot_surface(S, T, Z, cmap="viridis", linewidth=0, antialiased=True, alpha=0.8)
            ax.contour(S, T, Z, zdir="z", offset=float(Z.min()), cmap="coolwarm", alpha=0.5)
            ax.set_xlabel("S")
            ax.set_ylabel("t")
            ax.set_title(title)
            ax.view_init(elev=30, azim=130)

        return self._emit(f"{name}_surface.png", {"t": t_values, "S": s_values, "Z": Z}, draw)

    def plot_stability(self, perturbation_range, errors_dict: dict[str, Sequence[float]],
                       optimizer) -> str:
        """Relative error vs perturbation size per (mode, activation)."""
        rng = np.asarray(perturbation_range)
        errors = {k: np.asarray(v) for k, v in errors_dict.items()}

        def draw(plt):
            plt.figure(figsize=(10, 6))
            for key, err in errors.items():
                plt.plot(rng, err, marker="o", ls="--", label=key)
            plt.xlabel("Relative distance to the training initial condition")
            plt.ylabel("Relative error")
            plt.legend()

        return self._emit(f"Stability_{optimizer}.png", {"perturbation": rng, **errors}, draw)

    def plot_spectral_radius(self, radius_dict: dict[str, np.ndarray], optimizer) -> str:
        """Histogram + KDE + polar panels with the < 1 stability threshold."""
        radii = {k: np.asarray(v) for k, v in radius_dict.items()}

        def draw(plt):
            fig = plt.figure(figsize=(18, 5))
            ax1 = fig.add_subplot(131)
            for key, r in radii.items():
                ax1.hist(r, bins=30, alpha=0.6, label=key, edgecolor="black")
            ax1.axvline(1.0, color="r", ls="--", label="stability threshold")
            ax1.set_xlabel("Spectral radius")
            ax1.set_ylabel("Frequency")
            ax1.legend()

            ax2 = fig.add_subplot(132)
            for key, r in radii.items():
                xs = np.linspace(r.min() - 0.1, r.max() + 0.1, 200)
                bw = 1.06 * r.std() * len(r) ** (-1 / 5) + 1e-6  # Silverman KDE
                dens = np.exp(-0.5 * ((xs[:, None] - r[None, :]) / bw) ** 2).mean(1) / (
                    bw * np.sqrt(2 * np.pi))
                ax2.fill_between(xs, dens, alpha=0.4, label=key)
            ax2.axvline(1.0, color="r", ls="--")
            ax2.set_xlabel("Spectral radius")
            ax2.set_ylabel("Density")
            ax2.legend()

            ax3 = fig.add_subplot(133, projection="polar")
            for key, r in radii.items():
                theta = np.linspace(0, 2 * np.pi, len(r))
                ax3.plot(theta, r, "o", ms=4, label=key)
            ax3.plot(np.linspace(0, 2 * np.pi, 100), [1.0] * 100, "r--")
            ax3.set_rmax(max(1.5, max(r.max() for r in radii.values())))
            ax3.legend(loc="upper right", bbox_to_anchor=(1.3, 1.0))

        return self._emit(f"SpectralRadius_{optimizer}.png", radii, draw)

    def plot_error_heatmap(self, errors: np.ndarray, row_labels, col_labels,
                           name="ErrorHeatmap") -> str:
        """Config-sweep error heatmap."""
        errors = np.asarray(errors)

        def draw(plt):
            plt.figure(figsize=(10, 6))
            im = plt.imshow(errors, cmap="coolwarm", aspect="auto")
            plt.colorbar(im)
            plt.xticks(range(len(col_labels)), col_labels, rotation=45)
            plt.yticks(range(len(row_labels)), row_labels)
            plt.title("Error heatmap")

        return self._emit(f"{name}.png", {"errors": errors, "rows": np.asarray(row_labels),
                                          "cols": np.asarray(col_labels)}, draw)

    def plot_spherical_surface(self, radius_dict: dict[str, np.ndarray], optimizer,
                               name="SpectralRadiusSphere") -> str:
        """Spectral radii on a spherical scatter (golden-spiral points on the
        unit sphere, radial coordinate = spectral radius) with the r = 1
        stability sphere."""
        radii = {k: np.asarray(v) for k, v in radius_dict.items()}

        def draw(plt):
            fig = plt.figure(figsize=(10, 8))
            ax = fig.add_subplot(111, projection="3d")
            for key, r in radii.items():
                n = len(r)
                idx = np.arange(n) + 0.5
                phi = np.arccos(1 - 2 * idx / n)
                theta = np.pi * (1 + 5**0.5) * idx
                ax.scatter(r * np.sin(phi) * np.cos(theta), r * np.sin(phi) * np.sin(theta),
                           r * np.cos(phi), s=12, label=key, alpha=0.7)
            u, v = np.mgrid[0: 2 * np.pi: 24j, 0: np.pi: 12j]
            ax.plot_wireframe(np.cos(u) * np.sin(v), np.sin(u) * np.sin(v), np.cos(v),
                              color="r", alpha=0.2, linewidth=0.5)
            ax.set_title(f"Spectral radii (r=1 sphere = stability threshold)\n{optimizer}")
            ax.legend()

        return self._emit(f"{name}_{optimizer}.png", radii, draw)

    def plot_convergence(self, errors: dict[str, np.ndarray], name="Convergence") -> str:
        """L1/L2/L∞ vs epoch, semilog."""
        errors = {k: np.asarray(v) for k, v in errors.items()}

        def draw(plt):
            plt.figure(figsize=figsize(1.0))
            for label, vals in errors.items():
                plt.semilogy(vals, label=label)
            plt.xlabel("Epoch")
            plt.ylabel("Error")
            plt.legend()

        return self._emit(f"{name}.png", errors, draw)
