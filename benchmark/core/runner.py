"""One run of one cell: set-up, the window (traced or not), the check, and
the result line's fields."""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from types import SimpleNamespace

import torch

from benchmark.core import spec as specs
from benchmark.core.readers import ShortTrace
from benchmark.core.trace import Traced
from benchmark.drivers.common import sync

# modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "dnnpde_tpu")
# a trace that lost device records (CUPTI drops some, now and then) is taken again, at most
# this many times in all; a shortfall in every one fails the run
TRACE_ATTEMPTS = 3


def driver(mix: dict):
    return importlib.import_module(f"benchmark.drivers.{mix['driver']}")


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def check(cfg: dict, mix: dict, limits: dict, program: dict, inp: dict) -> dict:
    """``{number: {"value", "limit"}}`` of the program against the f32 reference."""
    d = driver(mix)
    numbers = d.compare(program, d.reference(cfg, mix, inp, "f32"))
    if set(numbers) != set(limits):
        raise RuntimeError(f"compared {sorted(numbers)}, limits for {sorted(limits)}")
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, cfg: dict | None = None, mix: dict | None = None,
             limits: dict | None = None) -> tuple[dict, dict]:
    """Run ``cell`` once; returns (the result line without its checks, the
    checks). ``cfg``, ``mix`` and ``limits`` replace the cell's files (the
    tests run cells at small sizes on the CPU)."""
    cfg = cfg or specs.data("configs", cell["config"])
    mix = mix or specs.data("traffic", cell["traffic"])
    limits = limits or specs.data("limits", cell["name"])
    d = driver(mix)
    device = torch.device(device)
    cuda = device.type == "cuda"
    imports_s = time.perf_counter() - t_start
    state = d.setup(cfg, mix, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    run = None
    if trace:
        wanted = specs.metrics_of(spec, "per_layer", cell["name"])
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            traced = Traced()
            counts = d.traced_window(state, traced)
            run = SimpleNamespace(cfg=cfg, mix=mix, counts=counts, host=state.host,
                                  trace=traced.trace)
            try:
                metrics = {}
                for m in wanted:
                    value = specs.reader(m["name"])(run)
                    if value is not None:
                        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                break
            except ShortTrace as e:  # the profiler lost records: trace the work again
                if attempt == TRACE_ATTEMPTS:
                    raise
                print(f"trace: {e}; tracing again", file=sys.stderr)
        attempted = counts["iterations"] if "iterations" in counts else counts["requests"]
        failed = counts["failed"]
    else:
        e2e, attempted, failed = d.window(state, seconds)
        e2e["setup_s"] = (setup_s, "s")
        wanted = specs.metrics_of(spec, "end_to_end", cell["name"])
        metrics = {m["name"]: {"value": e2e[m["name"]][0], "unit": m["unit"]} for m in wanted}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    if run is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    program, host = d.outputs(state), state.host
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check(cfg, mix, limits, program, d.inputs(cfg, mix, seed, device))
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    phases = {"setup_s": setup_s, "imports_s": imports_s,
              **{k: v for k, v in host.items() if isinstance(v, float)}}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev, "setup_phases": phases}
    if run is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    return result, checks
