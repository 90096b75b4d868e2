#!/usr/bin/env python3
"""Which ``torch.profiler`` traces lose device records, and what one served
request costs on the host, on one NVIDIA GPU:

    python3 scripts/trace_probe.py            # writes build/trace_probe.json
    python3 scripts/trace_probe.py --starts   # writes build/trace_probe_starts.json
    python3 scripts/trace_probe.py --starts 40 plain lead_spin lead_burst profile_trace

Traces: one child process per CUPTI setting (none, ``TEARDOWN_CUPTI=0``,
``DISABLE_CUPTI_LAZY_REINIT=1``) traces the BSB-100 kernel-path trainer of
``chip_smoke.py`` (K1 + K2, M = 100, N = 50) several times: 20 replayed
iterations under CUDA-only and under CPU + CUDA activity, 5 eager steps, and
20 iterations of a fresh trainer (eager warm-up, capture, replays) under
``train.profile_trace``. Each trace is read from its Chrome-trace JSON: K1's
and K2's kernels by name (51 a step), the launches whose kernel is missing
(with their time from the trace's first event), per graph launch the K1
kernels it ran, and the least gap from a launch to its kernel's start.

With ``--starts`` it instead traces, in a child process that has already
run one CUDA-only trace, rounds of 64 small eager kernels followed by 5
replayed trainer iterations, under CPU + CUDA activity opened four ways:
at once (``plain``); after a ``schedule`` warm-up step that only
synchronizes (``warm_sync``); after one that also launches 1 or 32 small
kernels (``warm_1``, ``warm_32``), whose records the warm-up discards. It
counts per trace the kernels whose records are missing and K1's. Given a
number of rounds and variants, it instead runs those; the variants also
include a lead-in opened before the work: a ~10 ms spin kernel
(``lead_spin``), 256 small kernels (``lead_burst``), or both inside
``train.profile_trace`` (``profile_trace``), each followed by a synchronize.

Serving: the full-width FC-Sine artifact (``serve.export_solution``) at
B = 1, 100, 4096, host clock to result (the median of 7 rounds, each the
median of 60 requests, the four ways in turn): ``u_and_grad_device``, its
graph alone, the graph as exported (every weight transpose done per request), and
the plain-data path that served before the artifact (``mlp_u_z`` on the
weights), with the graph's op counts.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SETTINGS = {"default": {}, "no_teardown": {"TEARDOWN_CUPTI": "0"},
            "eager_reinit": {"DISABLE_CUPTI_LAZY_REINIT": "1"}}
ITERS, EAGER_STEPS = 20, 5
ROUNDS = 7  # serving: medians of 60 requests, each way in turn
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaGraphLaunch")


def read_trace(path: str, want: int, t_start: float, lead_in: int = 0) -> dict:
    """The diagnostics of one Chrome-trace file (see the module docstring);
    ``want``: K1's and K2's kernels the traced work ran; ``lead_in``: how
    many of the first launches are not the work's."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    timed = [e for e in events if "ts" in e]
    t0 = min(float(e["ts"]) for e in timed)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("name") in LAUNCHES]
    runs, other = dict.fromkeys(cs.K1_K2_KERNELS, 0), Counter()
    by_corr: dict = {}
    for e in kernels:
        m = re.search(r"mlp_u_z_\w+", e.get("name", ""))
        if m:
            if m.group(0) in runs:
                runs[m.group(0)] += 1
            else:
                other[e["name"][:80]] += 1
        c = e.get("args", {}).get("correlation")
        by_corr.setdefault(c, []).append(e)
    launches.sort(key=lambda e: float(e["ts"]))
    missing = [e for e in launches if e.get("args", {}).get("correlation") not in by_corr]
    work_missing = [e for e in launches[lead_in:]
                    if e.get("args", {}).get("correlation") not in by_corr]
    graphs = [e for e in launches if e["name"] == "cudaGraphLaunch"]
    k1_per_graph = [sum("mlp_u_z_fwd" in k["name"]
                        for k in by_corr.get(g.get("args", {}).get("correlation"), []))
                    for g in sorted(graphs, key=lambda e: e["ts"])]
    gaps = [float(by_corr[c][0]["ts"]) - float(e["ts"]) for e in launches
            if e["name"] != "cudaGraphLaunch"
            and (c := e.get("args", {}).get("correlation")) in by_corr]
    first = sorted(kernels, key=lambda e: float(e["ts"]))[:3]
    return {
        "at_s": round(t_start, 1), "runs": runs, "want_each": want,
        "lost": {k: want - v for k, v in runs.items()}, "other_mlp_names": dict(other),
        "kernels": len(kernels), "launches": len(launches),
        "launches_without_kernel": len(missing), "work_launches_without_kernel": len(work_missing),
        "missing_at_ms": [round((float(e["ts"]) - t0) / 1e3, 3) for e in missing[:12]],
        "missing_names": dict(Counter(e["name"] for e in missing)),
        "graph_launches": len(graphs),
        "graphs_short_of_k1": [(i, n) for i, n in enumerate(k1_per_graph) if n != 51],
        "first_kernels_ms": [(e["name"][:40], round((float(e["ts"]) - t0) / 1e3, 3))
                             for e in first],
        "instants": [(e["name"], round((float(e["ts"]) - t0) / 1e3, 3)) for e in events
                     if e.get("ph") == "i"][:4],
        "least_launch_to_kernel_us": round(min(gaps), 2) if gaps else None,
    }


def child(name: str) -> dict:
    """The traces of one CUPTI setting (this process's environment)."""
    from torch.profiler import ProfilerActivity, profile

    from dnnpde_tpu_torch.ops import _build
    from dnnpde_tpu_torch.train import profile_trace

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    t_proc = time.perf_counter()
    tr = cs._kernel_trainer(device, seed=6)
    tr.train(ITERS, 1e-3, log_every=ITERS, verbose=False)  # warm-up and capture

    def replays():
        tr.train(ITERS, 1e-3, log_every=ITERS, verbose=False)

    def eager():
        for _ in range(EAGER_STEPS):
            tr.step(*tr._batch(), "Adam", 1e-3)

    def fresh():
        cs._kernel_trainer(device, seed=7).train(ITERS, 1e-3, log_every=ITERS, verbose=False)

    cpu_cuda = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    noext = torch._C._profiler._ExperimentalConfig(disable_external_correlation=True)
    plan = [("cuda_only", "replays"), ("cpu_cuda", "replays"), ("cpu_cuda", "replays"),
            ("cpu_cuda", "eager"), ("cpu_cuda_noext", "replays"), ("profile_trace", "fresh"),
            ("profile_trace", "fresh"), ("cpu_cuda", "replays"), ("cuda_only", "replays")]
    work = {"replays": (replays, 51 * ITERS), "eager": (eager, 51 * EAGER_STEPS),
            "fresh": (fresh, 51 * ITERS)}
    out = []
    for tracer, what in plan:
        fn, want = work[what]
        at = time.perf_counter() - t_proc
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            if tracer == "profile_trace":
                with profile_trace(tmp):
                    fn()
                    torch.cuda.synchronize()
                path = next(Path(tmp).glob("*.pt.trace.json"))
            else:
                acts = [ProfilerActivity.CUDA] if tracer == "cuda_only" else cpu_cuda
                kw = {"experimental_config": noext} if tracer.endswith("noext") else {}
                with profile(activities=acts, **kw) as prof:
                    fn()
                    torch.cuda.synchronize()
                    time.sleep(0.2)  # as traced_train: the last kernels inside the window
                path = f"{tmp}/trace.json"
                prof.export_chrome_trace(path)
            row = read_trace(str(path), want, at)
        row.update(setting=name, tracer=tracer, work=what)
        out.append(row)
        print(f"{name} {tracer} {what}: lost {row['lost']} launches without kernel "
              f"{row['launches_without_kernel']} at {row['missing_at_ms']} "
              f"{row['missing_names']}; graphs short {row['graphs_short_of_k1'][:4]}; "
              f"least launch->kernel {row['least_launch_to_kernel_us']} us; first "
              f"{row['first_kernels_ms']}", flush=True)
    return {"setting": name, "traces": out}


STARTS = {  # variant: (a schedule warm-up step, small kernels in it, the lead-in)
    "plain": (False, 0, None), "warm_sync": (True, 0, None), "warm_1": (True, 1, None),
    "warm_32": (True, 32, None), "lead_spin": (False, 0, "spin"),
    "lead_burst": (False, 0, "burst"), "profile_trace": (False, 0, "profile_trace")}


def starts(rounds: int, variants: list[str]) -> dict:
    """The ``--starts`` traces (module docstring), in this process."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from dnnpde_tpu_torch.train import diagnostics, profile_trace

    device = torch.device("cuda", 0)
    tr = cs._kernel_trainer(device, seed=6)
    tr.train(5, 1e-3, log_every=5, verbose=False)  # warm-up and capture
    x = torch.zeros(1, device=device)

    def work():
        for _ in range(64):
            x.add_(1.0)
        tr.train(5, 1e-3, log_every=5, verbose=False)
        torch.cuda.synchronize()
        time.sleep(0.2)  # as traced_train: the last kernels inside the window

    with profile(activities=[ProfilerActivity.CUDA]):  # the process's first trace
        work()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out: dict = {k: [] for k in variants}
    for _ in range(rounds):
        for variant in out:
            warm, warm_kernels, lead = STARTS[variant]
            with tempfile.TemporaryDirectory() as tmp:
                torch.cuda.synchronize()
                if lead == "profile_trace":
                    with profile_trace(tmp):
                        work()
                    path = str(next(Path(tmp).glob("*.pt.trace.json")))
                else:
                    kw = {"schedule": schedule(wait=0, warmup=1, active=1),
                          "on_trace_ready": lambda p: None} if warm else {}
                    with profile(activities=acts, **kw) as prof:
                        if warm:
                            for _ in range(warm_kernels):
                                x.add_(0.0)
                            torch.cuda.synchronize()
                            prof.step()
                        if lead == "spin":
                            torch.cuda._sleep(diagnostics.LEAD_IN_SPIN_CYCLES)
                        elif lead == "burst":
                            for _ in range(diagnostics.LEAD_IN_KERNELS):
                                x.add_(0.0)
                        torch.cuda.synchronize()
                        work()
                    path = f"{tmp}/t.json"
                    prof.export_chrome_trace(path)
                lead_in = {"spin": 1, "burst": diagnostics.LEAD_IN_KERNELS,
                           "profile_trace": diagnostics.LEAD_IN_KERNELS + 2}.get(lead, 0)
                row = read_trace(path, 51 * 5, 0.0, lead_in)
            out[variant].append({"launches_lost": row["work_launches_without_kernel"],
                                 "lead_in_lost": (row["launches_without_kernel"]
                                                  - row["work_launches_without_kernel"]),
                                 "k1_lost": row["lost"]["mlp_u_z_fwd_kernel"],
                                 "lost_at_ms": row["missing_at_ms"][:4]})
    summary = {k: {"traces": len(v), "traces_losing": sum(r["launches_lost"] + r["k1_lost"] > 0
                                                          for r in v),
                   "launches_lost": [r["launches_lost"] for r in v],
                   "lead_in_lost": [r["lead_in_lost"] for r in v],
                   "k1_lost": [r["k1_lost"] for r in v]} for k, v in out.items()}
    return {"summary": summary, "traces": out}


def serving(device) -> dict:
    """Host ms of one request at each batch, four ways (module docstring)."""
    from torch.export.graph_signature import InputKind

    from dnnpde_tpu_torch.ops.fused_net_u import mlp_u_z
    from dnnpde_tpu_torch.serve import export_solution, load_solution

    net = cs.make_net(device)
    Ws, bs = cs.weights(net)
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/a.pt2", "wb") as f:
            f.write(export_solution(net, cs.D))
        sol = load_solution(f"{tmp}/a.pt2", device=device)
    program = sol.program
    args, slots = [], []
    for spec in program.graph_signature.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            slots.append(len(args))
            args.append(None)
        else:
            args.append(program.state_dict[spec.target])
    exported = program.graph_module
    exported.recompile()

    def as_exported(t, X):
        request = list(args)
        request[slots[0]], request[slots[1]] = t, X
        return exported(*request)

    def plain(t, X):
        u, z = mlp_u_z(Ws, bs, torch.cat([t, X], dim=1), "sine")
        return u, z[:, 1:]

    def ops(graph):
        return sum(n.op == "call_function" for n in graph.nodes)

    out = {"ops_exported": ops(exported.graph), "ops_bound": ops(sol._call.__self__.graph)}
    ways = {"u_and_grad_device_ms": lambda t, X: sol.u_and_grad_device(t, X),
            "bound_graph_ms": sol._call, "exported_graph_ms": as_exported,
            "plain_data_path_ms": plain}
    for B in cs.SERVE_BATCHES:
        t, X = cs.requests(B, device, seed=100 + B)
        with torch.no_grad():
            a, b, c = sol._call(t, X), as_exported(t, X), plain(t, X)
            rounds = {k: [] for k in ways}
            for _ in range(ROUNDS):  # the four ways in turn, so host noise falls on each
                for k, fn in ways.items():
                    rounds[k].append(cs.host_ms(lambda: fn(t, X), 60))
        out[f"B{B}"] = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}
        out[f"B{B}"].update(
            bound_equals_exported=all(torch.equal(x, y) for x, y in zip(a, b)),
            vs_plain_max_abs=max(float((x - y).abs().max()) for x, y in zip(a, c)))
    return out


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print("CHILD " + json.dumps(child(sys.argv[2])))
        return 0
    if sys.argv[1:2] == ["--starts-child"]:
        print("CHILD " + json.dumps(starts(int(sys.argv[2]), sys.argv[3:])))
        return 0
    if not torch.cuda.is_available():
        print("trace_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from dnnpde_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, f"torch {torch.__version__}", flush=True)
    _build.build_all()
    if sys.argv[1:2] == ["--starts"]:
        rounds, variants = (sys.argv[2], sys.argv[3:]) if sys.argv[2:] else (
            "12", ["plain", "warm_sync", "warm_1", "warm_32"])
        proc = subprocess.run([sys.executable, __file__, "--starts-child", rounds, *variants],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-3000:])
            return 1
        res = json.loads(next(ln for ln in proc.stdout.splitlines() if ln.startswith("CHILD "))[6:])
        print("starts: " + json.dumps(res["summary"]))
        if not sys.argv[2:]:
            res["serving"] = serving(torch.device("cuda", 0))
            print("serving: " + json.dumps(res["serving"]))
        os.makedirs(HERE / "build", exist_ok=True)
        with open(HERE / "build" / f"trace_probe_starts{'_' + rounds if sys.argv[2:] else ''}"
                  ".json", "w") as f:
            json.dump({"card": smi, **res}, f, indent=1)
        return 0
    result = {"card": smi, "children": []}
    for name, env in SETTINGS.items():
        proc = subprocess.run([sys.executable, __file__, "--child", name],
                              env={**os.environ, **env}, capture_output=True, text=True,
                              timeout=240)
        print("\n".join(ln for ln in proc.stdout.splitlines() if not ln.startswith("CHILD ")))
        if proc.returncode != 0:
            print(proc.stderr[-3000:])
            result["children"].append({"setting": name, "rc": proc.returncode})
            continue
        result["children"].append(json.loads(next(
            ln for ln in proc.stdout.splitlines() if ln.startswith("CHILD "))[6:]))
    result["serving"] = serving(torch.device("cuda", 0))
    print("serving: " + json.dumps(result["serving"]))
    os.makedirs(HERE / "build", exist_ok=True)
    with open(HERE / "build" / "trace_probe.json", "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
