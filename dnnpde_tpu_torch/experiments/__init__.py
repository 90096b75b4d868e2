"""Experiment drivers (L6): the sweep executors and the Heston surface
executor, producing CSV and plot artifacts."""

from dnnpde_tpu_torch.experiments.executors import (
    CorrExecutor,
    HestonExecutor,
    HestonSurfaceExecutor,
    HJBExecutor,
    SensitivityExecutor,
    SurfaceConfig,
    SweepConfig,
    TestCaseExecutor,
    TrainingExecutor,
)

__all__ = [
    "SweepConfig",
    "SurfaceConfig",
    "TrainingExecutor",
    "CorrExecutor",
    "TestCaseExecutor",
    "HJBExecutor",
    "HestonExecutor",
    "HestonSurfaceExecutor",
    "SensitivityExecutor",
]
