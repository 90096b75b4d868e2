"""Training: optimizer factory and trainer."""

from dnnpde_tpu_torch.train.optimizers import OPTIMIZER_NAMES, build_optimizer, is_lbfgs
from dnnpde_tpu_torch.train.trainer import (
    Trainer,
    TrainingPhases,
    TrainResult,
    default_layers,
    scaled_lr,
)

__all__ = [
    "OPTIMIZER_NAMES",
    "build_optimizer",
    "is_lbfgs",
    "Trainer",
    "TrainingPhases",
    "TrainResult",
    "default_layers",
    "scaled_lr",
]
