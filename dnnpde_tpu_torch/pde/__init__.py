from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.pde.heston import HestonPDE
from dnnpde_tpu_torch.pde.problems import (
    BasketCallOption,
    BlackScholesBarenblatt,
    BSPDETestCase,
    CallOption1D,
    CallOptionND,
    HamiltonJacobiBellman,
)

__all__ = [
    "PDEProblem",
    "BlackScholesBarenblatt",
    "CallOption1D",
    "CallOptionND",
    "BasketCallOption",
    "BSPDETestCase",
    "HamiltonJacobiBellman",
    "HestonPDE",
]
