#!/usr/bin/env python3
"""Where K4's time goes, for one checkout of this repo, on one NVIDIA GPU:

    python3 scripts/k4_anatomy.py TREE [--products P]

TREE is the root of a checkout (this one, ``.``, or a ``git archive`` of
another commit unpacked under ``build/``). The script

1. compiles the tree's ``dnnpde_tpu_torch/csrc/gbm_terminal.cu`` to a cubin
   with the package's nvcc flags and ``-Xptxas -v``, and prints what ptxas
   says of each kernel (registers, stack frame, spills);
2. disassembles it (``cuobjdump -sass``) and prints, for each kernel, the
   instruction mix of the whole kernel and of its hottest loop (the loop
   body, from a backward branch's target to the branch, with the most
   integer multiplies: the step loop, where Philox runs), by class: integer
   multiplies (IMAD.WIDE / IMAD.HI / other IMAD), LOP3, I2F, MUFU,
   FFMA / FMUL / FADD, shared and local loads and stores, branches;
3. times the tree's ``gbm_terminal`` with CUDA events at M = 131072,
   D = 100 for N = 1, 25 and 50, uncorrelated and correlated (the
   correlation of ``chip_smoke.py``'s K4 check), launched through the C
   entry point on prepared inputs, and from the slope between N = 25 and
   N = 50 the device time of one step of one (path pair, asset
   group) item, in SM cycles at the card's maximum SM clock. With
   ``--products P`` (the 32 x 32 -> 64-bit Philox products a kernel
   evaluates per item and step: 40 for two plain Philox4x32-10 calls, one
   IMAD.WIDE or IMAD.HI each) it also divides the hot
   loop's instruction count down to one item-step and prints the warp
   instructions each SM issued per cycle over the step loop (at most 4).

``ncu`` does not run where the card is, so this is the issue-rate reading:
static SASS counts beside event times. The last line is one JSON object.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

CLASSES = (
    ("IMAD.WIDE", re.compile(r"^IMAD\.WIDE")),
    ("IMAD.HI", re.compile(r"^IMAD\.HI")),
    ("IMAD.MOV", re.compile(r"^IMAD\.(MOV|SHL|IADD)")),
    ("IMAD", re.compile(r"^IMAD")),
    ("IADD3", re.compile(r"^IADD3")),
    ("LOP3", re.compile(r"^LOP3")),
    ("SHF", re.compile(r"^SHF")),
    ("I2F", re.compile(r"^I2F")),
    ("F2I", re.compile(r"^F2I")),
    ("MUFU", re.compile(r"^MUFU")),
    ("FFMA", re.compile(r"^FFMA")),
    ("FMUL", re.compile(r"^FMUL")),
    ("FADD", re.compile(r"^FADD")),
    ("FSETP/FSEL/FMNMX", re.compile(r"^(FSETP|FSEL|FMNMX|FCHK)")),
    ("ISETP/SEL", re.compile(r"^(ISETP|SEL)")),
    ("LDS", re.compile(r"^LDS")),
    ("STS", re.compile(r"^STS")),
    ("LDL", re.compile(r"^LDL")),
    ("STL", re.compile(r"^STL")),
    ("LDG", re.compile(r"^(LDG|LD\b)")),
    ("STG", re.compile(r"^(STG|ST\b)")),
    ("BRA/BSSY/BSYNC", re.compile(r"^(BRA|BSSY|BSYNC|BAR|WARPSYNC|CALL|RET)")),
)
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
FUNC = re.compile(r"Function : (\S+)")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")

M, D = 131072, 100
N_VALUES = (1, 25, 50)


def klass(op: str) -> str:
    for name, pat in CLASSES:
        if pat.match(op):
            return name
    return "other"


def sass(cubin: Path) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return parse_sass(subprocess.run([tool, "-sass", str(cubin)], capture_output=True, text=True,
                                     check=True).stdout)


def parse_sass(text: str) -> dict:
    """{kernel: [(address, opcode, operands)]} from cuobjdump -sass's text."""
    out, name = {}, None
    for line in text.splitlines():
        f = FUNC.search(line)
        if f:
            name = f.group(1)
            out[name] = []
            continue
        m = LINE.search(line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out


def hottest_loop(instrs) -> tuple[list, tuple[int, int]]:
    """The loop body [target, branch] with the most integer multiplies."""
    best, span = [], (0, 0)
    for addr, op, args in instrs:
        if not op.startswith("BRA"):
            continue
        t = re.search(r"0x([0-9a-f]+)", args)
        if not t or int(t.group(1), 16) >= addr:
            continue
        lo = int(t.group(1), 16)
        body = [i for i in instrs if lo <= i[0] <= addr]
        score = sum(1 for i in body if i[1].startswith("IMAD.WIDE") or i[1].startswith("IMAD.HI"))
        if score > sum(1 for i in best if i[1].startswith(("IMAD.WIDE", "IMAD.HI"))):
            best, span = body, (lo, addr)
    return best, span


def mix(instrs) -> dict:
    c = Counter(klass(op) for _, op, _ in instrs)
    mufu = Counter(op for _, op, _ in instrs if op.startswith("MUFU"))
    return {"total": len(instrs), **dict(sorted(c.items())), "mufu_ops": dict(mufu)}


def kernel_of(kernels: dict, variant: str) -> str:
    """The kernel that runs ``variant``: the only one, or the one whose name
    has ``corr`` in it exactly when ``variant`` is correlated."""
    if len(kernels) == 1:
        return next(iter(kernels))
    return next(k for k in kernels if ("corr" in k) == (variant == "correlated"))


def build(tree: Path, out_dir: Path) -> tuple[Path, str]:
    src = tree / "dnnpde_tpu_torch" / "csrc" / "gbm_terminal.cu"
    cubin = out_dir / "gbm_terminal.cubin"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-cubin", "-Xptxas", "-v", "-o", str(cubin), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"k4_anatomy: nvcc failed:\n{res.stdout}{res.stderr}")
    return cubin, res.stdout + res.stderr


def ptxas_lines(text: str) -> list[str]:
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "stack frame" in ln or "Compiling entry" in ln]


def time_k4(device) -> dict:
    """The tree's K4, launched through its C entry point on prepared inputs
    (this checkout's ``chip_smoke.k4_kernel_call``), so that the wrapper's
    host work does not bound the short N = 1 launch."""
    import torch
    from dnnpde_tpu_torch.sim import cholesky_factor, generate_correlation_matrix
    from time_tree import this_chip_smoke

    here = this_chip_smoke()
    L = torch.from_numpy(cholesky_factor(
        generate_correlation_matrix(D, "random_correlation", seed=1))).float().to(device)
    ones = torch.ones(D, device=device)
    out = {}
    for name, chol in (("uncorrelated", None), ("correlated", L)):
        for N in N_VALUES:
            launch = here.k4_kernel_call((0, ones, 0.05, 0.2, 1.0, N, M), chol, device)
            out[f"{name}_N{N}_ms"] = here.time_ms(launch, iters=10 if N > 1 else 50)
    return out


def main() -> int:
    args = sys.argv[1:]
    products = None
    if "--products" in args:
        i = args.index("--products")
        products = int(args[i + 1])
        del args[i:i + 2]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(args[0]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("k4_anatomy: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    clock_hz = float(smi.split(",")[-1]) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        cubin, log = build(tree, Path(tmp))
        print("\n".join(ptxas_lines(log)))
        kernels = sass(cubin)
    report = {"tree": str(tree), "card": smi, "kernels": {}}
    for name, instrs in kernels.items():
        body, span = hottest_loop(instrs)
        report["kernels"][name] = {"kernel": mix(instrs), "hot_loop": mix(body),
                                   "hot_loop_span": [hex(span[0]), hex(span[1])]}
        print(f"{name}: whole kernel {json.dumps(mix(instrs))}")
        print(f"{name}: hot loop {hex(span[0])}-{hex(span[1])} {json.dumps(mix(body))}")

    import dnnpde_tpu_torch

    if not Path(dnnpde_tpu_torch.__file__).resolve().is_relative_to(tree):
        print(f"k4_anatomy: imported {dnnpde_tpu_torch.__file__}, not {tree}", file=sys.stderr)
        return 1
    times = time_k4(torch.device("cuda", 0))
    report["times"] = times
    G = (D + 3) // 4
    item_steps = (M // 2) * G * (N_VALUES[-1] - N_VALUES[1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in ("uncorrelated", "correlated"):
        slope_ms = times[f"{name}_N{N_VALUES[-1]}_ms"] - times[f"{name}_N{N_VALUES[1]}_ms"]
        cycles = slope_ms * 1e-3 * clock_hz * sms / item_steps  # SM cycles per item-step
        report[f"{name}_sm_cycles_per_item_step"] = cycles
        if products is not None:
            hot = report["kernels"][kernel_of(report["kernels"], name)]["hot_loop"]
            mults = hot.get("IMAD.WIDE", 0) + hot.get("IMAD.HI", 0)
            per_item_step = hot["total"] * products / mults if mults else float("nan")
            report[f"{name}_hot_loop_instructions_per_item_step"] = per_item_step
            report[f"{name}_warp_ipc_per_sm"] = per_item_step / 32 / cycles
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
