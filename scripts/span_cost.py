"""The host cost of the port's spans and counters, in µs a call: a span with
no profiler recording (one flag check and a shared no-op context), a span
while ``torch.profiler`` records the host (and the card, where there is one),
an ungated ``record_function`` for comparison, and a counter's increment.
Each is the mean over a loop of calls, less the same loop's empty cost.

    python3 scripts/span_cost.py [--calls 200000]

Prints one JSON line, with the device it ran beside.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from dnnpde_tpu_torch import tracing  # noqa: E402


def _loop_us(body, n: int) -> float:
    t0 = time.perf_counter()
    for i in range(n):
        body(i)
    return (time.perf_counter() - t0) / n * 1e6


def _span(i):
    with tracing.span("dnnpde.cost", request=i, rows=1):
        pass


def _ungated(i):
    with record_function("dnnpde.cost"):
        pass


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200_000)
    n = ap.parse_args().calls
    n_on = min(n // 10, tracing.MAX_SPANS)  # every span kept
    empty = _loop_us(lambda i: None, n)
    out = {"device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
           "torch": torch.__version__, "calls_off": n, "calls_on": n_on,
           "span_off_us": _loop_us(_span, n) - empty,
           "record_function_off_us": _loop_us(_ungated, n_on) - empty,
           "count_us": _loop_us(lambda i: tracing.count("dnnpde.cost"), n) - empty}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tracing.clear()
    with profile(activities=activities):
        out["span_on_us"] = _loop_us(_span, n_on) - empty
    out["spans_kept"] = len(tracing.spans())
    tracing.clear()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
