"""Tracing, profiling and anomaly detection, the counterpart of
``dnnpde_tpu/train/diagnostics.py``.

- :func:`detect_anomalies`: raise ``FloatingPointError`` on the first NaN
  (or Inf) an op produces, in the forward or the backward pass (JAX's
  ``jax_debug_nans`` / ``jax_debug_infs``).
- :class:`StepTimer`: cumulative wall-clock logs.
- :func:`profile_trace`: a ``torch.profiler`` trace that TensorBoard and
  Perfetto read (``dnnpde_tpu_torch.tracing``, with its lead-in, whose
  constants are re-exported here).
- :func:`device_memory_stats`: live and peak device memory.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from dnnpde_tpu_torch.runtime import default_device
from dnnpde_tpu_torch.tracing import (  # noqa: F401  re-exported
    LEAD_IN_KERNELS,
    LEAD_IN_SPIN_CYCLES,
    TAIL_S,
    lead_in,
    profile_trace,
)

aten = torch.ops.aten

# ops whose output is memory not yet written: its values mean nothing
_UNINITIALIZED = frozenset({aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
                            aten.new_empty_strided})


class _FiniteCheck(TorchDispatchMode):
    """Check every floating output of every ATen op. Autograd runs the
    backward pass's ops under the modes of the thread that called it, so
    the backward is checked too."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNINITIALIZED:
            return out
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor) or not (t.is_floating_point() or t.is_complex()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf produced by {func}")
        return out


def anomalies_checked() -> bool:
    """True inside :func:`detect_anomalies`: the checks read values back to
    the host, which a CUDA-graph capture forbids, so the trainers then run
    their iterations eagerly."""
    return any(isinstance(m, _FiniteCheck) for m in _get_current_dispatch_mode_stack())


@contextlib.contextmanager
def detect_anomalies(nans: bool = True, infs: bool = True) -> Iterator[None]:
    """Raise ``FloatingPointError`` on the first NaN (``nans``) or Inf
    (``infs``) produced by an op in the block, forward or backward; the
    previous state returns on exit. Each op waits for its result (debug
    only, a large slowdown). Inside the block ``Trainer.train`` runs every
    iteration eagerly, never a captured chunk."""
    with _FiniteCheck(nans, infs):
        yield


class StepTimer:
    """Cumulative wall-clock logger (reference ``time_logs``,
    ``hjb_implement.py:388-439``). Call :meth:`lap` at each log point."""

    def __init__(self):
        self.start = time.time()
        self.laps: list[float] = []
        self.cumulative: list[float] = []
        self._last = self.start

    def lap(self) -> float:
        now = time.time()
        lap = now - self._last
        self._last = now
        self.laps.append(lap)
        self.cumulative.append(now - self.start)
        return lap


def device_memory_stats(device=None) -> dict:
    """Live and peak device memory of ``device`` (None: the current CUDA
    card) in bytes, under JAX's keys: PyTorch's allocated bytes now and at
    their peak (since ``torch.cuda.reset_peak_memory_stats``) and the card's
    total memory. Every value is None on the CPU, as JAX's CPU device
    reports."""
    dev = default_device(device)
    keys = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    if dev.type != "cuda":
        return dict.fromkeys(keys)
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }
