"""Training: optimizer factory, schedules, checkpoints and trainer."""

from dnnpde_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from dnnpde_tpu_torch.train.optimizers import OPTIMIZER_NAMES, build_optimizer, is_lbfgs
from dnnpde_tpu_torch.train.schedules import PhaseSpec, TimeStepRefinement, two_phase
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
    "PhaseSpec",
    "TimeStepRefinement",
    "two_phase",
    "save_checkpoint",
    "restore_checkpoint",
    "Trainer",
    "TrainingPhases",
    "TrainResult",
    "default_layers",
    "scaled_lr",
]
