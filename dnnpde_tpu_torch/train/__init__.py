"""Training: optimizer factory, schedules, checkpoints, diagnostics, the
trainer, and the multi-model programs (replicas, ensembles) and Richardson
extrapolation."""

from dnnpde_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    restore_checkpoint_orbax,
    save_checkpoint,
    save_checkpoint_orbax,
)
from dnnpde_tpu_torch.train.diagnostics import (
    StepTimer,
    detect_anomalies,
    device_memory_stats,
    profile_trace,
)
from dnnpde_tpu_torch.train.ensemble import (
    EnsembleResult,
    train_ensemble,
    train_sensitivity_ensemble,
)
from dnnpde_tpu_torch.train.extrapolation import richardson_y0, train_y0
from dnnpde_tpu_torch.train.optimizers import OPTIMIZER_NAMES, build_optimizer, is_lbfgs
from dnnpde_tpu_torch.train.replicas import (
    ReplicaProgram,
    ReplicaResult,
    replica_net,
    replica_values_at,
    train_replicas,
)
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
    "save_checkpoint_orbax",
    "restore_checkpoint_orbax",
    "StepTimer",
    "detect_anomalies",
    "device_memory_stats",
    "profile_trace",
    "Trainer",
    "TrainingPhases",
    "TrainResult",
    "default_layers",
    "scaled_lr",
    "ReplicaProgram",
    "ReplicaResult",
    "replica_net",
    "replica_values_at",
    "train_replicas",
    "EnsembleResult",
    "train_ensemble",
    "train_sensitivity_ensemble",
    "richardson_y0",
    "train_y0",
]
