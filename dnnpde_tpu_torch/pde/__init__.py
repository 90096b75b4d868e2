from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.pde.heston import HestonAmericanPut, HestonPDE
from dnnpde_tpu_torch.pde.problems import (
    AmericanPutOption,
    BasketCallOption,
    BermudanMaxCall,
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
    "AmericanPutOption",
    "BermudanMaxCall",
    "HestonAmericanPut",
]
