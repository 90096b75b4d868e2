"""The readings a cell's limits are set from, in one process on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1-12 \
        [--control-seeds 1-3] [--fault-seeds 1-3] [--seconds 0]

For each of ``--seeds`` it sets the program up as a run does, runs a window
of ``--seconds`` (0: one chunk or one request, then the sampled requests)
and prints the compared numbers against the f32 reference: the lower
readings. For each of ``--control-seeds`` it puts the reference, computed in
the precision below the configuration's (TF32 for f32, fp8 for bf16), in the
program's place on the same inputs: the control. The precision is the one
the timed path computes in: the configuration's, or the driver's own
``PRECISION`` where it has one (the served artifact is f32). For a training cell and
each of ``--fault-seeds`` it does the same with a planted fault in the
reference: half of the batch (its sum doubled), and the state left
unchanged. One JSON line each, then the largest program reading and the
smallest control and fault readings per number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOWER = {"f32": "tf32", "bf16": "fp8"}


def control_precision(driver, cfg: dict) -> str:
    """The precision below the one the cell's timed path computes in."""
    return LOWER[getattr(driver, "PRECISION", cfg["precision"])]


def _seeds(text: str) -> list[int]:
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]

    import torch

    from benchmark.core import spec as specs
    from benchmark.core.runner import driver
    from dnnpde_tpu_torch.runtime import enable_compilation_cache

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    enable_compilation_cache(str(ROOT / "build" / "dnnpde_kernels"))
    device = torch.device("cuda", 0)
    cell = specs.workload(specs.load_spec(), args.workload)
    cfg, mix = specs.data("configs", cell["config"]), specs.data("traffic", cell["traffic"])
    d = driver(mix)
    worst: dict = {}

    def report(kind: str, seed: int, numbers: dict) -> None:
        print(json.dumps({"kind": kind, "seed": seed, **numbers}), flush=True)
        for k, v in numbers.items():
            key = (kind, k)
            worst[key] = max(worst.get(key, v), v) if kind == "program" else min(
                worst.get(key, v), v)

    for seed in _seeds(args.seeds):
        state = d.setup(cfg, mix, seed, device)
        d.window(state, args.seconds)
        program = d.outputs(state)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        inp = d.inputs(cfg, mix, seed, device)
        report("program", seed, d.compare(program, d.reference(cfg, mix, inp, "f32")))
    for seed in _seeds(args.control_seeds):
        inp = d.inputs(cfg, mix, seed, device)
        f32 = d.reference(cfg, mix, inp, "f32")
        low = d.reference(cfg, mix, inp, control_precision(d, cfg))
        report("control", seed, d.compare(low, f32))
    for seed in _seeds(args.fault_seeds):
        inp = d.inputs(cfg, mix, seed, device)
        f32 = d.reference(cfg, mix, inp, "f32")
        for fault in ("half", "unchanged"):
            report(f"fault {fault}", seed,
                   d.compare(d.reference(cfg, mix, inp, "f32", fault=fault), f32))
    print(json.dumps({"summary": {f"{k} {n}": v for (k, n), v in sorted(worst.items())},
                      "device": torch.cuda.get_device_name(device),
                      "seconds": time.perf_counter() - T_START}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
