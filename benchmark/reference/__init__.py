"""The plain reference that decides ``correct``: PyTorch in float32 with
TF32 off, written from the published equations. It imports neither JAX nor
anything of ``dnnpde_tpu`` or ``dnnpde_tpu_torch``, and takes nothing the
program made: the benchmark hands it the same seeded inputs as the program.

``problem(name, args)`` returns the reference of a configuration's PDE, the
module ``reference/<name>.py``, found by the name in the configuration file.
"""

from __future__ import annotations

import importlib


def problem(name: str, args: dict):
    """The reference PDE ``reference/<name>.py::Problem(**args)``."""
    return importlib.import_module(f"benchmark.reference.{name}").Problem(**args)
