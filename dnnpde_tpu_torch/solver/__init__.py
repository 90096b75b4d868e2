from dnnpde_tpu_torch.solver.bsde import make_net_u

__all__ = ["make_net_u"]
