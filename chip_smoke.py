#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Run from the repo root on a machine with a CUDA card, ``nvcc`` and PyTorch
built for CUDA. It

1. prints the card (``nvidia-smi`` name and power limit) and the torch and
   nvcc versions;
2. builds every kernel under ``dnnpde_tpu_torch/csrc/`` (one nvcc each, in
   parallel) and prints the build time;
3. holds K1 (``mlp_u_z_fwd``) against its plain PyTorch version at the full
   FC-Sine width [101, 256 x 4, 1] for B in {1, 100, 4096, 13056}, and K3
   (``rollout_paths``) at M = 16384, N = 50, D = 100 with the BSB
   coefficients, in both its explicit-dW and its seed variant;
4. drives the serving path through the user entry points: BSB-100 ->
   ``MLP`` -> ``save_solution`` -> ``load_solution`` -> ``u_and_grad`` at
   batches 1, 100 and 4096 and one ``surface``, then ``predict_paths_fast``
   with M = 16384, N = 50; the launch counters of K1 and K3 are set to 0
   just before and must have risen just after; the outputs are checked
   against the plain autograd ``make_net_u`` and the plain rollout;
5. times the serving requests (host clock to result), then each kernel, its
   plain version and a cuBLAS bf16 matmul chain that computes the same
   function (the library yardstick, which the port never calls), and prints
   one JSON line of kernels and, last, the device line.

Any failure ends the script with a non-zero exit code and no result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

LAYERS = [101, 256, 256, 256, 256, 1]
D = 100
N_STEPS = 50
M_PATHS = 16384
K1_BATCHES = (1, 100, 4096, 13056)  # 13056 = 51 x 256: one surface request
SERVE_BATCHES = (1, 100, 4096)
# Kernel vs plain version, relative to max|plain|. Both round every dot
# operand to bf16, but they sum in other orders, so a value that lies within
# an f32 rounding of a bf16 tie rounds the other way in one of them and moves
# what follows by up to about a bf16 step (2^-8) of one term. The mean error
# stays far below the largest, which a wrong index or a race would not.
REL_TOL = 1e-2
MEAN_REL_TOL = 1e-4
SERVE_REL_TOL = 2e-2  # bf16-operand kernel vs f32 autograd, relative to max|f32|

# H100 SXM data sheet, dense: bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _rel_err(a: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |a - ref|, that over max |ref|)."""
    err = float((a - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def _compare(name: str, a: torch.Tensor, ref: torch.Tensor) -> float:
    """Hold a kernel's output against its plain version; returns max |a - ref|."""
    d = (a - ref).abs()
    scale = max(float(ref.abs().max()), 1e-30)
    err, rel, mean_rel = float(d.max()), float(d.max()) / scale, float(d.mean()) / scale
    frac = float((d > 1e-6 * scale).float().mean())
    print(f"{name}: max|d|={err:.3e} rel {rel:.3e} (tol {REL_TOL:g}), mean rel {mean_rel:.3e} "
          f"(tol {MEAN_REL_TOL:g}), share above 1e-6 rel {frac:.3e}")
    _require(a.shape == ref.shape, f"{name}: shape {tuple(a.shape)} != {tuple(ref.shape)}")
    _require(bool(torch.isfinite(a).all()), f"{name}: non-finite values")
    _require(rel <= REL_TOL and mean_rel <= MEAN_REL_TOL, f"{name} disagrees with its plain version")
    return err


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Median wall time in ms of fn() followed by a device synchronize: what
    a caller waits for one request."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _macs(widths, layers: int) -> int:
    return sum(widths[k] * widths[k + 1] for k in range(layers))


def _weight_bytes(Ws, bs) -> int:
    return sum(4 * (w.numel() + b.numel()) for w, b in zip(Ws, bs))


def make_net(device, seed: int = 0):
    """The FC-Sine net at full width: Xavier weights from a seeded generator
    and small random biases, so the bias path is exercised."""
    from dnnpde_tpu_torch.nets import MLP

    gen = torch.Generator().manual_seed(seed)
    net = MLP(LAYERS, "sine", generator=gen, device=device)
    with torch.no_grad():
        for layer in net.dense:
            b = 0.1 * torch.randn(layer.linear.bias.shape, generator=gen)
            layer.linear.bias.copy_(b.to(device))
    return net


def weights(net):
    """(Ws, bs) of ``net`` in the JAX layout, detached from autograd."""
    from dnnpde_tpu_torch.params import extract_mlp_params

    Ws, bs = extract_mlp_params(net)
    return [w.detach() for w in Ws], [b.detach() for b in bs]


def requests(B: int, device, seed: int):
    """(t (B,1), X (B,D)): times in [0, 1], states around the BSB x0."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt

    gen = torch.Generator().manual_seed(seed)
    x0 = BlackScholesBarenblatt(D=D).x0
    t = torch.rand((B, 1), generator=gen)
    X = x0 * torch.exp(0.3 * torch.randn((B, D), generator=gen))
    return t.to(device), X.to(device)


# ---- K1 -------------------------------------------------------------------


def library_u_z(Wb, bb, x):
    """cuBLAS yardstick for K1: the same forward and Z-sweep as a chain of
    bf16 matmuls (weights cast once, outside the timing)."""
    a, cs = x.to(torch.bfloat16), []
    for W, b in zip(Wb[:-1], bb[:-1]):
        p = torch.addmm(b, a, W)
        cs.append(torch.cos(p))
        a = torch.sin(p)
    u = torch.addmm(bb[-1], a, Wb[-1])
    r = Wb[-1][:, 0].expand(x.shape[0], -1)
    for W, c in zip(reversed(Wb[:-1]), reversed(cs)):
        r = (r * c) @ W.T
    return u, r


def check_k1(Ws, bs, device, batches=K1_BATCHES) -> dict:
    from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_fwd, mlp_u_z_fwd_reference

    worst = 0.0
    for B in batches:
        t, X = requests(B, device, seed=B)
        x = torch.cat([t, X], dim=1).contiguous()
        u, z = mlp_u_z_fwd(Ws, bs, x)
        u_ref, z_ref = mlp_u_z_fwd_reference(Ws, bs, x)
        _require(u.shape == (B, 1) and z.shape == (B, LAYERS[0]), f"K1 shapes at B={B}")
        worst = max(worst, _compare(f"K1 u B={B}", u, u_ref), _compare(f"K1 Z B={B}", z, z_ref))
    return {"max_abs_err": worst}


def time_k1(Ws, bs, device, B: int = 4096) -> dict:
    from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_fwd, mlp_u_z_fwd_reference

    t, X = requests(B, device, seed=7)
    x = torch.cat([t, X], dim=1).contiguous()
    Wb = [w.to(torch.bfloat16) for w in Ws]
    bb = [b.to(torch.bfloat16) for b in bs]
    ms = time_ms(lambda: mlp_u_z_fwd(Ws, bs, x), iters=50)
    plain_ms = time_ms(lambda: mlp_u_z_fwd_reference(Ws, bs, x), iters=50)
    library_ms = time_ms(lambda: library_u_z(Wb, bb, x), iters=50)
    by_batch = {}
    for b in K1_BATCHES:
        xb = torch.cat(requests(b, device, seed=b), dim=1).contiguous()
        by_batch[b] = time_ms(lambda: mlp_u_z_fwd(Ws, bs, xb), iters=50)
    print("K1 kernel ms by batch: " + json.dumps(by_batch))
    L = len(Ws)
    flops = 2 * B * (_macs(LAYERS, L) + _macs(LAYERS, L - 1))
    nbytes = 4 * B * (2 * LAYERS[0] + 1) + _weight_bytes(Ws, bs)
    bms, by = bound_ms(flops, nbytes)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": f"B={B}"}


# ---- K3 -------------------------------------------------------------------


def library_rollout(Wb, bb, x0, N, dt, mu_c, sig_c, M, gen):
    """cuBLAS yardstick for K3: the same rollout with torch.randn increments
    and a bf16 matmul chain per step."""
    X = x0.reshape(1, -1).expand(M, -1)
    ys = []
    for n in range(N + 1):
        a = torch.cat([torch.full((M, 1), n * dt, device=X.device), X], 1).to(torch.bfloat16)
        for W, b in zip(Wb[:-1], bb[:-1]):
            a = torch.sin(torch.addmm(b, a, W))
        ys.append(torch.addmm(bb[-1], a, Wb[-1]))
        if n < N:
            dw = (dt ** 0.5) * torch.randn(X.shape, device=X.device, generator=gen)
            X = X + (mu_c * dt) * X + sig_c * X * dw
    return torch.cat(ys, 1)


def check_k3(Ws, bs, x0, device, M=M_PATHS, N=N_STEPS) -> dict:
    from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths, rollout_paths_reference

    kw = dict(N=N, dt=1.0 / N, mu_c=0.0, sig_c=0.4)
    gen = torch.Generator(device=device).manual_seed(3)
    dWs = (kw["dt"] ** 0.5) * torch.randn((M, N, D), generator=gen, device=device)
    worst = 0.0
    for name, extra in (("dWs", dict(dWs=dWs)), ("seed", dict(seed=2024, M=M))):
        y = rollout_paths(Ws, bs, x0, **kw, **extra)
        y_ref = rollout_paths_reference(Ws, bs, x0, **kw, **extra)
        _require(y.shape == (M, N + 1), f"K3 {name} shape {tuple(y.shape)}")
        worst = max(worst, _compare(f"K3 {name} M={M} N={N}", y, y_ref))
    return {"max_abs_err": worst, "dWs": dWs}


def time_k3(Ws, bs, x0, dWs, device, M=M_PATHS, N=N_STEPS) -> tuple[dict, dict]:
    from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths, rollout_paths_reference

    kw = dict(N=N, dt=1.0 / N, mu_c=0.0, sig_c=0.4)
    Wb = [w.to(torch.bfloat16) for w in Ws]
    bb = [b.to(torch.bfloat16) for b in bs]
    gen = torch.Generator(device=device).manual_seed(5)
    flops = 2 * M * (N + 1) * _macs(LAYERS, len(Ws))
    base_bytes = 4 * (D + M * (N + 1)) + _weight_bytes(Ws, bs)
    rows = {}
    for name, extra, nbytes in (
        ("seed", dict(seed=11, M=M), base_bytes),
        ("dWs", dict(dWs=dWs), base_bytes + 4 * dWs.numel()),
    ):
        ms = time_ms(lambda: rollout_paths(Ws, bs, x0, **kw, **extra), iters=5, warmup=1)
        plain_ms = time_ms(lambda: rollout_paths_reference(Ws, bs, x0, **kw, **extra),
                           iters=3, warmup=1)
        bms, by = bound_ms(flops, nbytes)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "shape": f"M={M} N={N} D={D} {name}"}
    library_ms = time_ms(
        lambda: library_rollout(Wb, bb, x0, N, kw["dt"], 0.0, 0.4, M, gen), iters=3, warmup=1
    )
    rows["seed"]["library_ms"] = library_ms
    rows["dWs"]["library_ms"] = None  # the yardstick draws its own increments
    return rows["seed"], rows["dWs"]


# ---- the serving path -------------------------------------------------------


def drive_serving(net, device) -> dict:
    """The main path, through the user entry points. Returns the launch
    counts of K1 and K3 in this run and what it served."""
    from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_fwd
    from dnnpde_tpu_torch.ops.rollout_kernel import predict_paths_fast, rollout_paths
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.serve import load_solution, save_solution

    prob = BlackScholesBarenblatt(D=D)
    trainer = SimpleNamespace(problem=prob, params=net, N=N_STEPS, mode="FC",
                              activation="Sine", chol=None)
    reqs = {B: requests(B, device, seed=100 + B) for B in SERVE_BATCHES}
    t_grid = torch.linspace(0.0, 1.0, 51)
    x_grid = requests(256, "cpu", seed=99)[1]

    mlp_u_z_fwd.launches = 0
    rollout_paths.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/bsb100_fc_sine.pt"
        save_solution(path, net, prob.dim)
        sol = load_solution(path, device=device)
        served = {B: sol.u_and_grad(*reqs[B]) for B in SERVE_BATCHES}
        surface = sol.surface(t_grid.numpy(), x_grid.numpy())
    Y = predict_paths_fast(trainer, M=M_PATHS, seed=4321)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    counts = {"mlp_u_z_fwd": mlp_u_z_fwd.launches, "rollout_paths": rollout_paths.launches}
    print(f"serving path: {seconds:.3f} s, launches {json.dumps(counts)}")
    return {"counts": counts, "served": served, "surface": surface, "Y": Y,
            "reqs": reqs, "trainer": trainer, "sol": sol}


def time_serving(run) -> dict:
    """Request latencies of the serving entry points, host clock to result."""
    from dnnpde_tpu_torch.ops.rollout_kernel import predict_paths_fast

    sol, trainer = run["sol"], run["trainer"]
    out = {}
    for B in SERVE_BATCHES:
        t, X = run["reqs"][B]
        out[f"u_and_grad_device_B{B}_ms"] = host_ms(lambda: sol.u_and_grad_device(t, X), 50)
    t, X = run["reqs"][SERVE_BATCHES[-1]]
    out[f"u_and_grad_B{SERVE_BATCHES[-1]}_ms"] = host_ms(lambda: sol.u_and_grad(t, X), 20)
    out[f"predict_paths_fast_M{M_PATHS}_N{N_STEPS}_ms"] = host_ms(
        lambda: predict_paths_fast(trainer, M=M_PATHS, seed=1), 5)
    return out


def check_serving(net, run, device) -> None:
    """What the serving path returned, against the plain autograd net_u and
    the plain rollout."""
    import numpy as np

    from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths_reference
    from dnnpde_tpu_torch.solver import make_net_u

    for name, n in run["counts"].items():
        _require(n > 0, f"the serving path launched {name} {n} times")
    net_u = make_net_u(net)
    for B, (u, Z) in run["served"].items():
        t, X = run["reqs"][B]
        with torch.no_grad():
            u_ref, Z_ref = net_u(t, X)
        _, ru = _rel_err(torch.from_numpy(u), u_ref.cpu())
        _, rz = _rel_err(torch.from_numpy(Z), Z_ref.cpu())
        print(f"served B={B}: u {u.shape} Z {Z.shape} vs f32 autograd: rel du {ru:.3e} "
              f"rel dZ {rz:.3e} tol rel {SERVE_REL_TOL:g}")
        _require(u.shape == (B, 1) and Z.shape == (B, D), f"served shapes at B={B}")
        _require(bool(np.isfinite(u).all() and np.isfinite(Z).all()), f"served non-finite at B={B}")
        _require(ru <= SERVE_REL_TOL and rz <= SERVE_REL_TOL, f"served (u, Z) off at B={B}")
    surf = run["surface"]
    _require(surf.shape == (51, 256) and bool(np.isfinite(surf).all()), "surface")
    print(f"surface: {surf.shape}, u in [{surf.min():.4f}, {surf.max():.4f}]")
    Y = run["Y"]
    tr = run["trainer"]
    Ws, bs = weights(net)
    Y_ref = rollout_paths_reference(
        Ws, bs, tr.problem.x0.to(device), N=N_STEPS, dt=1.0 / N_STEPS,
        mu_c=0.0, sig_c=0.4, seed=4321, M=M_PATHS,
    )
    print(f"predict_paths_fast: Y {tuple(Y.shape)}, Y[:, 0] mean {float(Y[:, 0].mean()):.5f}, "
          f"Y[:, -1] mean {float(Y[:, -1].mean()):.5f}")
    _require(Y.shape == (M_PATHS, N_STEPS + 1), "paths shape")
    _compare("predict_paths_fast vs plain rollout", Y, Y_ref)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from dnnpde_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; nvcc: {nvcc}")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt

    net = make_net(device)
    Ws, bs = weights(net)
    x0 = BlackScholesBarenblatt(D=D).x0.to(device)

    k1 = check_k1(Ws, bs, device)
    k3 = check_k3(Ws, bs, x0, device)

    run = drive_serving(net, device)
    check_serving(net, run, device)

    print("serving latency: " + json.dumps(time_serving(run)))
    k1.update(time_k1(Ws, bs, device))
    k3_seed, k3_dws = time_k3(Ws, bs, x0, k3.pop("dWs"), device)
    k3.update(k3_seed)
    print("K3 explicit-dW variant: " + json.dumps(k3_dws))

    kernels = [
        {"name": "mlp_u_z_fwd", "route": "cuda",
         "source": "dnnpde_tpu_torch/csrc/mlp_u_z_fwd.cu",
         "replaces": "dnnpde_tpu/ops/mlp_kernel.py:188",
         "launches": run["counts"]["mlp_u_z_fwd"], **k1},
        {"name": "rollout_paths", "route": "cuda",
         "source": "dnnpde_tpu_torch/csrc/rollout.cu",
         "replaces": "dnnpde_tpu/ops/rollout_kernel.py:182",
         "launches": run["counts"]["rollout_paths"], **k3},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
