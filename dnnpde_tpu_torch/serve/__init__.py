"""Serving: a self-contained ``torch.export`` artifact of a trained solution."""

from dnnpde_tpu_torch.serve.export import (
    ServedSolution,
    export_solution,
    export_trainer,
    load_solution,
    save_solution,
)

__all__ = [
    "ServedSolution",
    "export_solution",
    "export_trainer",
    "load_solution",
    "save_solution",
]
