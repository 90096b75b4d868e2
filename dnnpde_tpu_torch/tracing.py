"""Spans and counters inside the port, on the profiler's clock, and the
traced window's lead-in and tail.

- :func:`span` ``(name, **ids)``: a context manager around one piece of the
  program's work. While a ``torch.profiler`` is recording, it opens
  ``record_function(name)`` (a ``user_annotation`` range on the Chrome
  trace's timeline, beside the device's records) and keeps a :class:`Span`
  in a bounded in-memory store: its name, its start and end on
  ``time.time_ns()``, the index of the span it opened inside and its ids
  (a request's number, a chunk's first iteration). Otherwise it returns one
  shared no-op context: no clock is read and nothing is kept. A Chrome
  event's ``ts`` (µs) × 1000 + the trace's ``baseTimeNanoseconds`` is on
  ``time.time_ns()``'s clock, so a record joins its event.
- :func:`count` / :func:`counters`: process-wide integer counters, always
  on: the kernel wrappers' calls, nvcc's builds, the trainer's captures,
  replays and eager iterations.
- :func:`spans`, :func:`clear`.
- :func:`profile_trace` writes a trace that TensorBoard and Perfetto read;
  :func:`lead_in` is its opening on a card.

This module imports only torch and the standard library, so that ``ops``,
``serve`` and ``train`` import it without a cycle.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

# spans kept while a profiler records; later ones are counted under
# "tracing.spans_dropped" and not kept
MAX_SPANS = 100_000

# CUPTI can drop the device records of the first few milliseconds of device
# work after a trace starts (up to 67 small kernels, or 4 of K1's launches in
# a replayed graph, on an H100: PERF.md §6): the lead-in takes that place
LEAD_IN_KERNELS = 256
LEAD_IN_SPIN_CYCLES = 20_000_000  # ~10 ms at 1.98 GHz
# the profiler drops device work that ends after its window closes on the
# host's clock, and the device's stamps converted to that clock can put the
# last kernels past a stop that follows a synchronize at once
TAIL_S = 0.2


class Span(NamedTuple):
    """One kept span: ``end_ns`` is None while it is open; ``parent`` is the
    index in :func:`spans` of the span it opened inside, or -1."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    ids: dict


_lock = threading.Lock()
_store: list[Span] = []
_counters: dict[str, int] = {}
_open = threading.local()  # .stack: store indices of this thread's open spans
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "ids", "_index", "_record", "_range")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        stack = _open.__dict__.setdefault("stack", [])
        with _lock:
            if len(_store) < MAX_SPANS:
                self._index = len(_store)
                self._record = Span(self.name, time.time_ns(), None,
                                    stack[-1] if stack else -1, self.ids)
                _store.append(self._record)
            else:
                self._index, self._record = -1, None
                _counters["tracing.spans_dropped"] = _counters.get("tracing.spans_dropped", 0) + 1
        stack.append(self._index)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.stack.pop()
        with _lock:
            i = self._index
            if 0 <= i < len(_store) and _store[i] is self._record:  # not cleared meanwhile
                _store[i] = self._record._replace(end_ns=end)
        self._range.__exit__(*exc)
        return False


def span(name: str, **ids):
    """A context manager for one piece of work named ``name`` (the port's
    are ``dnnpde.*``), kept with ``ids`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, ids)


def spans() -> list[Span]:
    """A copy of the kept spans, in the order they opened."""
    with _lock:
        return list(_store)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of every counter bumped since the process started or the
    last :func:`clear`."""
    with _lock:
        return dict(_counters)


def clear() -> None:
    """Forget the kept spans and set every counter to 0."""
    with _lock:
        _store.clear()
        _counters.clear()


def lead_in() -> None:
    """Small kernels and a ~10 ms spin on the current card, then a
    synchronize, in a ``profile_trace lead-in`` range: the device work of a
    trace's first milliseconds, whose records CUPTI can drop. Call it just
    after a profiler starts."""
    with _profiler.record_function("profile_trace lead-in"):
        x = torch.zeros(1, device=torch.cuda.current_device())
        for _ in range(LEAD_IN_KERNELS):
            x.add_(1.0)
        torch.cuda._sleep(LEAD_IN_SPIN_CYCLES)
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(log_dir: str, host_tracer_level: int = 2) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (the host, and the CUDA
    device when there is one) and write a Chrome-trace JSON file into
    ``log_dir`` (``*.pt.trace.json``) that TensorBoard's profiler plugin and
    Perfetto read. ``host_tracer_level``: 0 records the device's activity
    only (the host's where there is no CUDA device), 1 or 2 also the host's
    ops, 3 also their shapes and Python stacks. On a CUDA device the trace
    opens with :func:`lead_in`, run before the block, since the first device
    records of a trace can be lost; and it closes after the device has
    finished the block's work and a further 0.2 s, so that the trace holds
    all of it. The block's spans are kept (:func:`spans`)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] if host_tracer_level > 0 or not cuda else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    verbose = host_tracer_level >= 3
    with profile(activities=activities, record_shapes=verbose, with_stack=verbose,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        if cuda:
            lead_in()
        yield
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TAIL_S)
