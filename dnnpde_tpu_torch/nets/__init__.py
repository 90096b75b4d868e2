from dnnpde_tpu_torch.nets.activations import get_activation, relu, sine, tanh
from dnnpde_tpu_torch.nets.initializers import xavier_uniform
from dnnpde_tpu_torch.nets.networks import (
    MLP,
    Dense,
    NaisNet,
    ResNet,
    VerletNet,
    build_network,
)

__all__ = [
    "Dense", "MLP", "NaisNet", "ResNet", "VerletNet", "build_network", "get_activation",
    "relu", "sine", "tanh", "xavier_uniform",
]
