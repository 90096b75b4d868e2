"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``dnnpde_tpu_torch/``. It loads
and warms up the cell (``setup_s``), measures for ``--seconds`` (with
``--trace 1`` it traces a fixed amount of the cell's work instead and
reports the per-layer metrics), checks what the program produced against
the plain reference, prints each compared number beside its limit on
standard error, and prints one JSON object on standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "dnnpde_tpu_torch" / "__init__.py").is_file():
        return _fail(f"no dnnpde_tpu_torch/ beside benchmark/ in {ROOT}")
    # every cache the program or PyTorch keeps stays inside the checkout, at fixed paths
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]

    import torch

    from benchmark.core import spec as specs
    from benchmark.core.runner import forbidden_modules, run_cell

    spec = specs.load_spec()
    try:
        cell = specs.workload(spec, args.workload)
    except KeyError as e:
        return _fail(str(e))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                     f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    torch.set_num_threads(2)

    from dnnpde_tpu_torch.ops import _build
    from dnnpde_tpu_torch.runtime import enable_compilation_cache

    enable_compilation_cache(str(ROOT / "build" / "dnnpde_kernels"))
    built = set(_build.BUILD_DIR.glob("*.so"))
    result, checks = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    builds = len(set(_build.BUILD_DIR.glob("*.so")) - built)
    bad = forbidden_modules(sys.modules)
    if bad:
        return _fail(f"these modules are loaded and may not be: {', '.join(bad)}", 3)
    print(f"benchmark: {args.workload} seed {args.seed}: nvcc builds in this run: {builds}; "
          f"set-up phases (s): {json.dumps(result.pop('setup_phases'))}", file=sys.stderr)
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
