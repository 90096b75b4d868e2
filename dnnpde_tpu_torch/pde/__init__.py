from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.pde.problems import BlackScholesBarenblatt

__all__ = ["PDEProblem", "BlackScholesBarenblatt"]
