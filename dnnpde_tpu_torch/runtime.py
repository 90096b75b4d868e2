"""Device selection and the kernel cache of the PyTorch port.

Entry points take ``device=None``, which means the current CUDA card (the
first, unless ``parallel.init_distributed`` set this rank's). The CPU is
used only when the caller asks for it by name; there is no silent fallback.

The programs the port compiles are its CUDA kernels (``csrc/*.cu``, built by
``nvcc`` the first time a wrapper launches one, ``ops/_build.py``), cached by
the hash of their sources and flags in a directory: by default
``build/dnnpde_kernels`` at the repo root, or where
:func:`enable_compilation_cache` points it, the counterpart of the JAX
package's persistent XLA cache. A later process that finds a kernel there
loads it and runs no ``nvcc``. Opt in by one call before the first launch::

    from dnnpde_tpu_torch.runtime import enable_compilation_cache
    enable_compilation_cache("~/.cache/dnnpde_tpu_torch_kernels")

or by ``DNNPDE_COMPILATION_CACHE=<dir>``, which the CLI (``python -m
dnnpde_tpu_torch``) honors. A training chunk's CUDA graph is captured anew in
every process: CUDA graphs hold device addresses of one process and cannot be
written to disk.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch


def default_device(device=None) -> torch.device:
    """Resolve ``device``: None → the current CUDA card (``cuda:0`` unless a
    rank of a parallel run set its own); raises if CUDA is absent and the
    caller did not ask for the CPU explicitly."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_of(*xs, device=None) -> torch.device:
    """``device`` when given; else the device of the first tensor among
    ``xs``; else the first CUDA card (as :func:`default_device`). Tensors
    stay where they are; Python numbers and numpy arrays go to the card
    unless the caller names the CPU."""
    if device is None:
        for x in xs:
            if isinstance(x, torch.Tensor):
                return x.device
    return default_device(device)


class OnDevice:
    """A constant CPU tensor (or None) with one copy per device, made at the
    first request for that device. The first request comes from an eager
    call, so that a training iteration captured into a CUDA graph later
    reuses the copy and holds no host-to-device copy."""

    def __init__(self, value):
        self.value = value
        self._by_device: dict = {}

    def on(self, device):
        if self.value is None:
            return None
        if device not in self._by_device:
            self._by_device[device] = self.value.to(device)
        return self._by_device[device]


@contextlib.contextmanager
def full_f32_matmul():
    """Run the block with TF32 off for matmuls and convolutions, restoring
    the caller's settings after it: the counterpart of
    ``jax.default_matmul_precision("highest")``."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def enable_compilation_cache(cache_dir: str, min_compile_time_secs: float = 1.0) -> str:
    """Build and find the CUDA kernels in ``cache_dir`` (created if needed)
    from now on. Safe to call more than once; the last directory wins.
    ``min_compile_time_secs`` is accepted for the JAX signature and has no
    effect: every kernel build takes seconds, so each is kept. Returns the
    resolved directory."""
    from dnnpde_tpu_torch.ops import _build

    path = Path(os.path.expanduser(cache_dir)).resolve()
    path.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = path
    return str(path)


def maybe_enable_compilation_cache_from_env(
    env_var: str = "DNNPDE_COMPILATION_CACHE",
) -> str | None:
    """Enable the cache iff ``env_var`` is set to a directory path."""
    target = os.environ.get(env_var)
    if not target:
        return None
    return enable_compilation_cache(target)
