"""Composition-style API (reference ``refactor_blackpde_dnn.py:144-265``,
``new_dnnpde_code.py:157-290``), the counterpart of ``dnnpde_tpu/compat.py``.

The reference's "refactor" scripts split the FBSNN monolith into
``EulerMaruyamaScheme`` / ``LossFunction`` / ``NeuralNetworkTraining``
composed objects. This module gives the same three-class surface over the
port's internals (``sim.brownian_paths``, ``solver.make_path_loss_fn``,
``train.Trainer``), for users moving code written against that API.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.runtime import default_device
from dnnpde_tpu_torch.sim.brownian import brownian_paths
from dnnpde_tpu_torch.solver.bsde import SolverConfig, make_path_loss_fn
from dnnpde_tpu_torch.train.trainer import Trainer


class EulerMaruyamaScheme:
    """Path simulator with the reference constructor/simulate surface
    (``refactor_blackpde_dnn.py:144-168``): the paths are drawn on
    ``device`` (None: the first CUDA card) from the scheme's own generator,
    whose stream advances with every :meth:`simulate`."""

    def __init__(self, Xi, T: float, M: int, N: int, D: int, seed: int = 0, device=None):
        self.Xi = np.asarray(Xi, np.float32).reshape(-1, D)
        self.T, self.M, self.N, self.D = T, M, N, D
        self.device = default_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def simulate(self) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (t (M, N+1, 1), W (M, N+1, D)) on the scheme's device."""
        return brownian_paths(self.generator, self.M, self.N, self.D, self.T)


class LossFunction:
    """Deep-BSDE objective with the reference ``compute(t, W, Xi)`` surface
    (``refactor_blackpde_dnn.py:171-219``). ``net`` is a port network;
    ``params``, kept for the JAX signature, may be a state dict to load
    into it."""

    def __init__(self, problem: PDEProblem, net: torch.nn.Module, params=None,
                 config: Optional[SolverConfig] = None):
        self.problem = problem
        self.net = net
        if params is not None:
            net.load_state_dict(params)
        self.params = net
        self._fn = make_path_loss_fn(problem, net, config or SolverConfig())

    def compute(self, t, W, Xi):
        """→ (loss, X (M, N+1, D), Y (M, N+1, 1), Y0): floats and host
        numpy arrays."""
        device = next(self.net.parameters()).device
        t, W = (torch.as_tensor(a, dtype=torch.float32).to(device) for a in (t, W))
        with torch.no_grad():
            res = self._fn(self.net, t, W, Xi)
        return float(res.loss), res.X.cpu().numpy(), res.Y.cpu().numpy(), float(res.Y0)


class NeuralNetworkTraining:
    """Trainer with the reference train/predict surface
    (``refactor_blackpde_dnn.py:222-265``): a :class:`Trainer` of the
    simulator's M and N on its device."""

    def __init__(self, problem: PDEProblem, simulator: EulerMaruyamaScheme,
                 layers=None, mode: str = "FC", activation: str = "Sine",
                 seed: int = 42):
        self.simulator = simulator
        self.trainer = Trainer(
            problem, M=simulator.M, N=simulator.N, layers=layers,
            mode=mode, activation=activation, seed=seed, device=simulator.device,
        )

    def train(self, N_Iter: int, learning_rate: float) -> np.ndarray:
        """→ np.stack((iterations, training_loss)) (reference ``:229-259``)."""
        return self.trainer.train(N_Iter, learning_rate, verbose=False).graph

    def predict(self, Xi_star, t_star, W_star):
        return self.trainer.predict(Xi_star, t_star, W_star)

    @property
    def model(self) -> Trainer:
        return self.trainer


def heston_predict(trainer, Xi_star, t_star, W_star):
    """Heston-layout predict: → (S paths, v paths, Y paths), the reference's
    ``HestonFBSNN.predict`` return shape (``heston_dnnpde.py:661-683``)."""
    X, Y = trainer.predict(Xi_star, t_star, W_star)
    return X[:, :, 0:1], X[:, :, 1:2], Y
