"""The traced window: ``torch.profiler`` over the host and the card, read
into device intervals, kernel times by name and the idle gaps.

The window opens with a lead-in (256 small kernels and a ~10 ms spin), since
CUPTI can drop the device records of the first milliseconds of a trace, and
closes after a synchronize and a further 0.2 s, since the profiler drops
device work that ends after its stop on the host's clock (the lead-in and
tail of ``dnnpde_tpu_torch/train/diagnostics.py::profile_trace``, copied).
The window itself is a host span, ``benchmark window``, around the work and
the synchronize that ends it; only device records inside it are read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import tempfile
import time

import torch

LEAD_IN_KERNELS = 256
LEAD_IN_SPIN_CYCLES = 20_000_000  # ~10 ms at 1.98 GHz
TAIL_S = 0.2
WINDOW = "benchmark window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict  # short kernel name -> [records, device seconds]
    device_ops: list  # [[name, seconds]], the ten that took most time
    idle_gaps: list  # [[what the host was doing, seconds]], the ten longest gaps

    def kernel(self, pattern: str) -> tuple[int, float]:
        """(records, seconds) of the kernels whose name contains ``pattern``."""
        n = s = 0
        for name, (count, sec) in self.kernels.items():
            if pattern in name:
                n, s = n + count, s + sec
        return n, s


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i, c in enumerate(name):  # the first '(' outside template brackets
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut][:160]


def _union(intervals) -> tuple[float, list]:
    """Total length of the union of (start, end) and its merged pieces."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def summarize(events: list) -> Trace:
    """Read a Chrome-trace event list (times in µs) into a :class:`Trace`."""
    windows = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") != "gpu_user_annotation"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW}' spans, expected 1")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device, kernels = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if b <= w0 or a >= w1:
            continue
        a, b = max(a, w0), min(b, w1)
        device.append((a, b))
        name = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        entry = kernels.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) * 1e-6
    if not device:
        raise RuntimeError("the profiler recorded no device activity inside the window")
    busy, merged = _union(device)
    edges = [w0] + [x for piece in merged for x in piece] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and e.get("name") != WINDOW]
    idle = []
    for length, start in gaps:
        mid = start + 0.5 * length
        inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e.get("dur", 0.0)]
        what = min(inside, key=lambda e: e.get("dur", 0.0))["name"] if inside else "(nothing traced)"
        idle.append([str(what)[:160], length * 1e-6])
    ops = sorted(([k, v[1]] for k, v in kernels.items()), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, kernels=kernels,
                 device_ops=ops, idle_gaps=idle)


class Traced:
    """``with Traced() as t: work()``; then ``t.trace`` is the window's
    :class:`Trace`. The Chrome trace is written to a temporary file under
    ``TMPDIR`` and removed once read."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        with record_function("benchmark lead-in"):
            x = torch.zeros(1, device="cuda")
            for _ in range(LEAD_IN_KERNELS):
                x.add_(1.0)
            torch.cuda._sleep(LEAD_IN_SPIN_CYCLES)
            torch.cuda.synchronize()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            torch.cuda.synchronize()
        self._window.__exit__(*exc)
        time.sleep(TAIL_S)
        t = [time.perf_counter()]
        self._prof.__exit__(None, None, None)
        t.append(time.perf_counter())
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            t.append(time.perf_counter())
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        t.append(time.perf_counter())
        self.trace = summarize(events)
        t.append(time.perf_counter())
        cost = ", ".join(f"{k} {b - a:.2f} s" for k, a, b in
                         zip(("stop", "write", "read", "summarize"), t, t[1:]))
        print(f"trace: {len(events)} events; {cost}", file=sys.stderr)
        return False
