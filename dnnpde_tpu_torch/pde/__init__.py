from dnnpde_tpu_torch.pde.base import CallableProblem, PDEProblem, as_callable_problem
from dnnpde_tpu_torch.pde.heston import HestonAmericanPut, HestonPDE
from dnnpde_tpu_torch.pde.problems import (
    AmericanPutOption,
    AsianCallOption,
    BasketCallOption,
    BermudanMaxCall,
    BlackScholesBarenblatt,
    BSPDETestCase,
    CallOption1D,
    CallOptionND,
    HamiltonJacobiBellman,
    LookbackCallOption,
    UpAndOutCall,
)

__all__ = [
    "PDEProblem",
    "as_callable_problem",
    "CallableProblem",
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
    "UpAndOutCall",
    "AsianCallOption",
    "LookbackCallOption",
]
