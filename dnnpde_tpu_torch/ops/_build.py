"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes ``<name>-<hash>.so`` in ``BUILD_DIR``
(``build/dnnpde_kernels`` at the repo root unless
``runtime.enable_compilation_cache`` moved it), where ``<hash>`` covers the
source, the shared headers and the compiler flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing here runs at import time: a wrapper calls :func:`load` the
first time it launches a kernel on a CUDA tensor, and ``chip_smoke.py`` calls
:func:`build_all` to compile every source in parallel up front.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from dnnpde_tpu_torch import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dnnpde_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for ``name`` unless its library is built; returns
    (target, temporary output, process)."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, Path(tmp), proc


def _finish(name: str, started) -> None:
    target, tmp, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    tracing.count("ops.nvcc_builds")


def build_all() -> None:
    """Compile every ``csrc/*.cu`` not built yet, one nvcc each, in parallel."""
    started = {p.stem: _start(p.stem) for p in sorted(CSRC.glob("*.cu"))}
    for n, s in started.items():
        if s is not None:
            with tracing.span("dnnpde.ops.build", kernel=n):  # the wait for its nvcc
                _finish(n, s)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    started = _start(name)
    if started is not None:
        with tracing.span("dnnpde.ops.build", kernel=name):
            _finish(name, started)
    lib = ctypes.CDLL(str(_target(name)))
    lib.dnnpde_error_string.argtypes = [ctypes.c_int]
    lib.dnnpde_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.dnnpde_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def pointer_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)
