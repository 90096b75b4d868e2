#!/usr/bin/env python3
"""Drive the PyTorch port's training, serving and basket-call paths on one
NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Run from the repo root on a machine with a CUDA card, ``nvcc`` and PyTorch
built for CUDA. It

1. prints the card (``nvidia-smi`` name and power limit) and the torch and
   nvcc versions;
2. builds every kernel under ``dnnpde_tpu_torch/csrc/`` (one nvcc each, in
   parallel) and prints the build time;
3. holds each kernel against its plain PyTorch version at the full FC-Sine
   width [101, 256 x 4, 1]: K1 (``mlp_u_z_fwd``) for B in {1, 100, 4096,
   13056}; K2 (``mlp_u_z_bwd``) for B in {1, 100, 2048}, where two launches
   on the same inputs must also agree bit for bit; K3 (``rollout_paths``)
   at M = 16384, N = 50, D = 100 with the BSB coefficients, in both its
   explicit-dW and its seed variant; K4 (``gbm_terminal``) at M = 131072,
   D = 100, at N = 50 uncorrelated and correlated and at the basket path's
   N = 1, value by value, bitwise across two launches and apart across two
   seeds, then the statistics
   checks of ``scripts/verify_tpu_kernels.py`` (mean, log-std,
   correlation, and the K4 basket price against Black-Scholes);
4. holds one full-width training step on the kernels (``fused_net_u="cuda"``)
   against the f32 autograd step (``"torch"``): loss and every gradient, on
   BSB-100 and on the basket call;
5. drives the training path through the user entry point: ``Trainer`` on
   BSB-100, M = 100, N = 50, ``.train(400, 1e-3, "Adam")``, where each chunk
   is a replayed CUDA graph of one iteration, under ``torch.profiler``: the
   wrappers see only the eager warm-up iteration and the capture, 2 x 51
   calls each of K1 and K2, and the run's trace must show each of K1's and
   K2's kernels exactly 51 x 400 times (the warm-up and 399 replays,
   which no wrapper sees); the mean logged
   loss must fall 10x and Y0 must move toward the exact 77.1; then a
   100-iteration captured chunk is held bit for bit against 100 eager
   ``Trainer.step`` calls (losses, Y0, parameters, Adam state), and a
   ``TrainingPhases`` run at the reference defaults (2000 iterations at
   1e-3, then 500 at 1e-5) must bring |Y0 - 77.1049| below its value after
   the first 400 iterations;
6. drives the serving path from the trained ``Trainer``: ``save_solution``
   -> ``load_solution`` -> ``u_and_grad`` at batches 1, 100 and 4096 (f32,
   as the JAX package serves) and one ``surface``, then
   ``Trainer.predict`` on the kernel path (K1 exactly N + 1 times) and
   ``predict_paths_fast`` with M = 16384, N = 50 (K3); the served (u, Z)
   are held to 1e-5 of max|.| of the plain autograd ``make_net_u``, the
   paths against the plain rollout;
7. drives the basket-call path: ``Trainer`` on BasketCallOption(D=100)
   for 400 captured iterations on K1 + K2 (traced and counted as on the
   training path; the mean logged loss must fall 10x), the CLI's
   oracle ``basket_call_mc`` (200k
   paths) beside ``fused_basket_call_mc`` on K4 (131072 paths; the two
   within 4 combined standard errors), |Y0 - oracle| must halve,
   ``compute_greeks`` at x0 and at 16 states beside ``basket_delta_mc``,
   and ``predict_paths_fast`` through K3 with (mu_c, sig_c) = (0.05, 0.2)
   against the plain rollout;

8. holds a 20-iteration captured chunk bit for bit against 20 eager
   ``Trainer.step`` calls for a NAIS-Net trainer (HJB-100) and a Heston
   trainer, then drives the harness path (the rows of ``bench/harness.py``
   that no kernel serves, each on the f32 autograd path in captured
   chunks): HJB-100 on NAIS-Net ReLU [101, 256 x 4, 1], M = 16, 1000
   iterations (the loss must fall and |Y0 - hjb_exact_mc| halve from
   iteration 100 to the end); Heston on FC-Sine [3, 256 x 4, 1], M = 128,
   the "bs" head, 1000 iterations (Y0 within 5 % of the closed form; the
   closed form, ``heston_mc_price`` and ``crank_nicolson_heston`` agree at
   ``tests/test_numerics.py``'s tolerances; the served (u, Z) equal the
   trainer's net_u within 1e-5 of max|.|, finite at t = T); the basket on
   NAIS-Net Sine, 400 iterations (the FC basket's loss and |Y0 - oracle|
   checks);

   on each of the four paths all four launch counters are set to 0 just
   before it runs and read just after; the kernels line reports each
   kernel's launches path by path (K1's and K2's on the training and basket
   paths from the run's trace, the others from the wrappers; none is on the
   harness path) beside the wrapper calls;
9. times training (iterations/s at M = 100, 512, 2048 on both paths,
   captured chunks and eager ``Trainer.step`` loops, and the basket run),
   traces BSB-100 kernel-path iterations at M = 100 with ``torch.profiler``,
   captured and eager (wall ms per iteration, device-busy ms, the device's
   idle share, and K1's and K2's share of the device time), times the serving requests and both
   oracles (host clock to result), then each kernel, its plain version and
   one PyTorch call that computes the same function (the library
   yardstick, which the port never calls; none computes K4's), and prints
   the script's total seconds, one JSON line of kernels (K4's at the basket
   path's N = 1) and, last, the device line.

Any failure ends the script with a non-zero exit code and no result line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

LAYERS = [101, 256, 256, 256, 256, 1]
D = 100
N_STEPS = 50
M_PATHS = 16384
K1_BATCHES = (1, 100, 4096, 13056)  # 13056 = 51 x 256: one surface request
SERVE_BATCHES = (1, 100, 4096)
K2_BATCHES = (1, 100, 2048)  # 100: the flagship M; 2048: the largest bench.py row
TRAIN_M = 100
TRAIN_ITERS = 400
TRAIN_LOG_EVERY = 100
TRAIN_RATE_MS = (100, 512, 2048)  # bench.py's rows
RATE_ITERS = {100: 100, 512: 50, 2048: 20}  # per timed window, captured and eager
CAPTURE_CHECK_ITERS = 100  # the captured chunk held bit for bit against eager steps
PHASES = ((2000, 1e-3), (500, 1e-5))  # TrainingPhases' reference defaults
PHASE_BASE_ITERS = 400  # |Y0 - exact| after these iterations is the mark to beat
PHASE_LOG_EVERY = 100  # Trainer.train's default, which TrainingPhases keeps
# Kernel vs plain version, relative to max|plain|. Both round every dot
# operand to bf16, but they sum in other orders, so a value that lies within
# an f32 rounding of a bf16 tie rounds the other way in one of them and moves
# what follows by up to about a bf16 step (2^-8) of one term. The mean error
# stays far below the largest, which a wrong index or a race would not.
REL_TOL = 1e-2
MEAN_REL_TOL = 1e-4
SERVE_REL_TOL = 1e-5  # served f32 (u, Z) vs f32 autograd, relative to max|f32|
STEP_REL_TOL = 2e-2  # loss and gradients, kernel step vs f32 step, relative to max|f32|
BASKET_FLIP_TOL = 1e-3  # the basket's paths: largest difference, relative to sum|W_L|
# K1's kernel ms by batch before the tensor-core redesign (PERF.md's kernel
# tables, CUDA-core K1 on an H100 80GB HBM3 at 700 W), printed beside this run's
K1_CUDA_CORE_MS = {1: 0.247, 100: 0.2482, 4096: 0.395}

# K4 against its plain version, value by value, relative to each value: both
# draw the same Philox stream and sum and correlate in the same order; the
# kernel takes the SFU's log2, sqrt, sin, cos and exp (absolute error ~2^-21
# per normal, ~1e-6 of S_T over a 50-term sum, csrc/gbm_terminal.cu) where
# the plain version takes PyTorch's accurate ones. One wrong normal moves a
# value by about σ√dt ≈ 3e-2.
K4_RTOL = 1e-5
K4_M = 131072  # scripts/verify_tpu_kernels.py's shape and the basket path's paths
BASKET_ORACLE_PATHS = 200_000  # the CLI's oracle for --problem basket
BASKET_DELTA_PATHS = 100_000
BASKET_GREEK_BATCH = 16

# H100 SXM data sheet, dense: bf16 tensor cores, f32 CUDA cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SMS = 132
SFU_PER_CLOCK = 16  # per SM: special-function results (log, sqrt, sin, cos, exp)
IMUL_PER_CLOCK = 64  # per SM: 32-bit integer multiplies


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _rel_err(a: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |a - ref|, that over max |ref|)."""
    err = float((a - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def _compare(name: str, a: torch.Tensor, ref: torch.Tensor,
             max_abs_tol: float | None = None) -> float:
    """Hold a kernel's output against its plain version: the largest
    difference within REL_TOL of max |ref| (or within ``max_abs_tol``), the
    mean within MEAN_REL_TOL of max |ref|; returns max |a - ref|."""
    d = (a - ref).abs()
    scale = max(float(ref.abs().max()), 1e-30)
    err, rel, mean_rel = float(d.max()), float(d.max()) / scale, float(d.mean()) / scale
    frac = float((d > 1e-6 * scale).float().mean())
    max_tol = REL_TOL * scale if max_abs_tol is None else max_abs_tol
    print(f"{name}: max|d|={err:.3e} (tol {max_tol:.3e}) rel {rel:.3e}, mean rel {mean_rel:.3e} "
          f"(tol {MEAN_REL_TOL:g}), share above 1e-6 rel {frac:.3e}")
    _require(a.shape == ref.shape, f"{name}: shape {tuple(a.shape)} != {tuple(ref.shape)}")
    _require(bool(torch.isfinite(a).all()), f"{name}: non-finite values")
    _require(err <= max_tol and mean_rel <= MEAN_REL_TOL,
             f"{name} disagrees with its plain version")
    return err


def _counted_kernels():
    """The four kernel wrappers, whose ``launches`` count their launches."""
    from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_bwd, mlp_u_z_fwd
    from dnnpde_tpu_torch.ops.path_kernel import gbm_terminal
    from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths

    return (mlp_u_z_fwd, mlp_u_z_bwd, rollout_paths, gbm_terminal)


def zero_counts() -> None:
    """Set every kernel's launch count to 0, just before a path runs."""
    for k in _counted_kernels():
        k.launches = 0


def read_counts() -> dict:
    """Every kernel's launch count, just after a path ran."""
    return {k.__name__: k.launches for k in _counted_kernels()}


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
    print("K1 kernel ms by batch: " + json.dumps(by_batch)
          + "; before the redesign: " + json.dumps(K1_CUDA_CORE_MS))
    row = _k1_row(Ws, bs, B, ms, plain_ms, library_ms)
    # the training path's shape: 51 launches per iteration at B = M = 100
    x = torch.cat(requests(TRAIN_M, device, seed=8), dim=1).contiguous()
    row_m = _k1_row(Ws, bs, TRAIN_M, time_ms(lambda: mlp_u_z_fwd(Ws, bs, x), iters=50),
                    time_ms(lambda: mlp_u_z_fwd_reference(Ws, bs, x), iters=50),
                    time_ms(lambda: library_u_z(Wb, bb, x), iters=50))
    print(f"K1 at B={TRAIN_M}: " + json.dumps(row_m))
    return row


def _k1_row(Ws, bs, B, ms, plain_ms, library_ms) -> dict:
    L = len(Ws)
    flops = 2 * B * (_macs(LAYERS, L) + _macs(LAYERS, L - 1))
    nbytes = 4 * B * (2 * LAYERS[0] + 1) + _weight_bytes(Ws, bs)
    bms, by = bound_ms(flops, nbytes)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": f"B={B}"}


# ---- K2 -------------------------------------------------------------------


def cotangents(B: int, device, seed: int):
    """(u_bar (B,1), z_bar (B,n0)) with z_bar's t column zero, as the rollout
    gives them (net_u drops Z's t column)."""
    gen = torch.Generator().manual_seed(seed)
    u_bar = torch.randn((B, 1), generator=gen)
    z_bar = torch.randn((B, LAYERS[0]), generator=gen)
    z_bar[:, 0] = 0.0
    return u_bar.to(device), z_bar.to(device)


def _k2_inputs(B: int, device, seed: int):
    x = torch.cat(requests(B, device, seed=seed), dim=1).contiguous()
    return (x, *cotangents(B, device, seed + 1))


def check_k2(Ws, bs, device, batches=K2_BATCHES) -> dict:
    from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_bwd, mlp_u_z_bwd_reference

    worst = 0.0
    for B in batches:
        x, u_bar, z_bar = _k2_inputs(B, device, seed=200 + B)
        out = mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar)
        again = mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar)
        ref = mlp_u_z_bwd_reference(Ws, bs, x, u_bar, z_bar)
        flat = [*out[0], *out[1], out[2]]
        names = ([f"W_bar[{k}]" for k in range(len(Ws))]
                 + [f"b_bar[{k}]" for k in range(len(bs))] + ["x_bar"])
        for name, a, r in zip(names, flat, [*ref[0], *ref[1], ref[2]]):
            worst = max(worst, _compare(f"K2 {name} B={B}", a, r))
        same = all(torch.equal(a, b) for a, b in zip(flat, [*again[0], *again[1], again[2]]))
        print(f"K2 B={B}: two launches bitwise equal: {same}")
        _require(same, f"K2 is not deterministic at B={B}")
    return {"max_abs_err": worst}


def library_u_z_bwd(Wb, bb, x, u_bar, z_bar):
    """Yardstick for K2: torch.autograd through the bf16 matmul chain of
    ``library_u_z`` (forward and backward, as K2 recomputes the forward), for
    the same gradients: the weights', the biases' and x's."""
    x = x.detach().requires_grad_(True)
    u, r = library_u_z(Wb, bb, x)
    return torch.autograd.grad((u, r), [*Wb, *bb, x], (u_bar.to(u.dtype), z_bar.to(r.dtype)))


def _k2_macs(widths) -> int:
    """Multiply-adds per row of K2: forward, sweep (r_{L-2} .. r_1), Z-path
    (outer product and dot per layer), u-path (head, then outer product and
    dot per layer)."""
    L = len(widths) - 1
    hidden = _macs(widths, L - 1)
    sweep = sum(widths[k] * widths[k + 1] for k in range(1, L - 1))
    return hidden + sweep + 2 * hidden + 2 * widths[L - 1] + 2 * hidden


def time_k2(Ws, bs, device) -> dict:
    from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_bwd, mlp_u_z_bwd_reference

    Wb = [w.to(torch.bfloat16).requires_grad_(True) for w in Ws]
    bb = [b.to(torch.bfloat16).requires_grad_(True) for b in bs]
    rows = {}
    for B in (TRAIN_M, K2_BATCHES[-1]):
        x, u_bar, z_bar = _k2_inputs(B, device, seed=300 + B)
        ms = time_ms(lambda: mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar), iters=50)
        plain_ms = time_ms(lambda: mlp_u_z_bwd_reference(Ws, bs, x, u_bar, z_bar), iters=20)
        library_ms = time_ms(lambda: library_u_z_bwd(Wb, bb, x, u_bar, z_bar), iters=20)
        flops = 2 * B * _k2_macs(LAYERS)
        nbytes = 4 * B * (3 * LAYERS[0] + 1) + 2 * _weight_bytes(Ws, bs)
        bms, by = bound_ms(flops, nbytes)
        rows[B] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "library_ms": library_ms, "shape": f"B={B}"}
    print("K2 by batch: " + json.dumps(rows))
    return rows[TRAIN_M]


# ---- K3 -------------------------------------------------------------------


def library_rollout(Wb, bb, x0, N, dt, mu_c, sig_c, M, gen, dWs=None):
    """cuBLAS yardstick for K3: the same rollout with a bf16 matmul chain per
    step, on the increments ``dWs`` (M, N, D) when given, else on
    torch.randn increments."""
    X = x0.reshape(1, -1).expand(M, -1)
    ys = []
    for n in range(N + 1):
        a = torch.cat([torch.full((M, 1), n * dt, device=X.device), X], 1).to(torch.bfloat16)
        for W, b in zip(Wb[:-1], bb[:-1]):
            a = torch.sin(torch.addmm(b, a, W))
        ys.append(torch.addmm(bb[-1], a, Wb[-1]))
        if n < N:
            if dWs is None:
                dw = (dt ** 0.5) * torch.randn(X.shape, device=X.device, generator=gen)
            else:
                dw = dWs[:, n]
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
    rows["dWs"]["library_ms"] = time_ms(
        lambda: library_rollout(Wb, bb, x0, N, kw["dt"], 0.0, 0.4, M, gen, dWs=dWs),
        iters=3, warmup=1,
    )
    return rows["seed"], rows["dWs"]


# ---- K4 -------------------------------------------------------------------


K4_VARIANTS = ("uncorrelated", "correlated", "basket")


def k4_cases(device) -> dict:
    """K4's calls (seed, S0, r, sigma, T, N, M) and L: scripts/verify_tpu_kernels.py's
    two, uncorrelated and with a random correlation matrix, at N = 50, and
    the basket path's (fused_basket_call_mc's defaults: N = 1, no L)."""
    from dnnpde_tpu_torch.sim import cholesky_factor, generate_correlation_matrix

    C = generate_correlation_matrix(D, "random_correlation", seed=1)
    L = torch.from_numpy(cholesky_factor(C)).float().to(device)
    ones = torch.ones(D, device=device)
    return {
        "uncorrelated": ((0, ones, 0.05, 0.2, 1.0, N_STEPS, K4_M), None),
        "correlated": ((1, ones, 0.0, 0.3, 1.0, N_STEPS, K4_M), L),
        "basket": ((0, ones, 0.05, 0.2, 1.0, 1, K4_M), None),
        "C": C,
    }


def check_k4(device) -> dict:
    """K4 value by value against its plain version at all three shapes, two
    launches bitwise, two seeds apart, then verify_tpu_kernels.py's
    statistics checks."""
    from dnnpde_tpu_torch.numerics import black_scholes_call
    from dnnpde_tpu_torch.ops.path_kernel import (
        fused_basket_call_mc,
        gbm_terminal,
        gbm_terminal_reference,
    )

    cases = k4_cases(device)
    worst, out = 0.0, {}
    for name in K4_VARIANTS:
        args, L = cases[name]
        st = gbm_terminal(*args, chol=L)
        again = gbm_terminal(*args, chol=L)
        ref = gbm_terminal_reference(*args, chol=L)
        _require(st.shape == (K4_M, D) and bool(torch.isfinite(st).all()), f"K4 {name} output")
        rel = float(((st - ref).abs() / ref.abs()).max())
        err = float((st - ref).abs().max())
        same = float((st == ref).float().mean())
        print(f"K4 {name} M={K4_M} N={args[5]} D={D}: max|d|={err:.3e}, max rel {rel:.3e} "
              f"(tol {K4_RTOL:g} of each value), share bitwise equal {same:.4f}")
        _require(rel <= K4_RTOL, f"K4 {name} disagrees with its plain version")
        _require(torch.equal(st, again), f"K4 {name}: two launches differ")
        worst = max(worst, err)
        out[name] = st
    _require(not torch.allclose(out["uncorrelated"], gbm_terminal(1, *cases["uncorrelated"][0][1:])),
             "K4: seeds 0 and 1 give the same values")

    ST = out["uncorrelated"].double()
    logs = torch.log(ST)
    mean, se = float(ST.mean()), float(ST.std()) / (K4_M * D) ** 0.5
    print(f"K4 mean S_T {mean:.6f} (expect {np.exp(0.05):.6f}, 4 SE {4 * se:.2e}); "
          f"std log S_T {float(logs.std()):.6f} (expect 0.2, tol 2e-3)")
    _require(abs(mean - np.exp(0.05)) < 4 * se, "K4 mean S_T")
    _require(abs(float(logs.std()) - 0.2) < 2e-3, "K4 log-std")
    emp = np.corrcoef(torch.log(out["correlated"]).double().cpu().numpy().T)
    corr_err = float(np.abs(emp - cases["C"]).max())
    print(f"K4 correlation max err {corr_err:.4f} (tol 0.05)")
    _require(corr_err < 0.05, "K4 correlation")
    p, se = fused_basket_call_mc(2, torch.ones(1, device=device), 1.0, 1.0, 0.05, 0.2,
                                 num_paths=524288, payoff="sum")
    exact = float(black_scholes_call(1.0, 1.0, 1.0, 0.05, 0.2, device=device))
    print(f"K4 MC price {float(p):.6f} +- {float(se):.6f} vs Black-Scholes {exact:.6f}")
    _require(abs(float(p) - exact) < 4 * float(se), "K4 MC price vs Black-Scholes")
    return {"max_abs_err": worst}


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def k4_bound(M: int, N: int, D: int, L, clock_hz: float) -> dict:
    """The least time of K4's work on an H100: the largest of its bytes over
    HBM, its transcendentals over the SFUs, Philox's integer multiplies and
    the correlation's f32 flops (lower triangle only). Philox: a 32 x 32 ->
    64-bit product is two 32-bit multiplies; the calls j = 0 and 1 of one
    (pair, step, group) need 34 products, since round 0 depends on (pair,
    group) only (2 products per item) and the two calls share two products
    of rounds 1 and 2 (csrc/gbm_terminal.cu)."""
    normals = M * N * D
    sfu = 2 * normals + M * D  # ½ log + ½ sqrt + sin or cos per normal; exp per output
    items = (M // 2) * ((D + 3) // 4)
    imul = 2 * items * (34 * N + 2)
    flops = 0 if L is None else M * D * (D + 1)
    nbytes = 4 * M * D + 3 * 4 * D + (0 if L is None else 4 * D * D)
    terms = {
        "bytes": nbytes / PEAK_BYTES,
        "sfu": sfu / (SMS * SFU_PER_CLOCK * clock_hz),
        "imul": imul / (SMS * IMUL_PER_CLOCK * clock_hz),
        "f32_flops": flops / PEAK_F32_FLOPS,
    }
    by = max(terms, key=terms.get)
    return {"bound_ms": 1e3 * terms[by], "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_term": by, "terms_ms": {k: 1e3 * v for k, v in terms.items()}}


def k4_kernel_call(args, L, device):
    """A function that launches K4's C entry point on inputs the wrapper
    prepared once: the kernel's own time, without the wrapper's host work
    (input tensors, checks), which is most of a call at N = 1."""
    from dnnpde_tpu_torch.ops import _build
    from dnnpde_tpu_torch.ops import path_kernel as pk

    seed, S0, r, sigma, T, N, M = args
    S0, a, b, L = pk._inputs(S0, r, sigma, T, N, L, device)
    out = torch.empty((M, S0.shape[0]), dtype=torch.float32, device=device)
    lib = pk._lib()
    ptrs = (S0.data_ptr(), a.data_ptr(), b.data_ptr(), None if L is None else L.data_ptr(),
            out.data_ptr())

    def launch():
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(lib, lib.gbm_terminal(*ptrs, M, S0.shape[0], N, seed, stream), "gbm_terminal")
        return out

    return launch


def time_k4(device) -> dict:
    """K4 (its C entry point on prepared inputs; ``call_ms`` through the
    wrapper) and its plain version at each of k4_cases' shapes, with the
    bound. No single PyTorch call computes K4's function, so library_ms is
    None."""
    from dnnpde_tpu_torch.ops.path_kernel import gbm_terminal, gbm_terminal_reference

    clock = sm_clock_hz()
    rows = {}
    cases = k4_cases(device)
    for name in K4_VARIANTS:
        args, L = cases[name]
        seed, S0, r, sigma, T, N, M = args
        launch = k4_kernel_call(args, L, device)
        _require(torch.equal(launch(), gbm_terminal(*args, chol=L)), f"K4 {name}: direct launch")
        iters = 10 if N > 1 else 50
        ms = time_ms(launch, iters=iters)
        call_ms = time_ms(lambda: gbm_terminal(*args, chol=L), iters=iters)
        plain_ms = time_ms(lambda: gbm_terminal_reference(*args, chol=L), iters=2, warmup=1)
        rows[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
                      **k4_bound(M, N, S0.shape[0], L, clock), "shape": f"M={M} N={N} D={D} {name}"}
    print(f"K4 by variant (SM clock {clock / 1e6:.0f} MHz): " + json.dumps(rows))
    return rows


# ---- the training path ------------------------------------------------------


def flagship_batch(M: int, device, seed: int, prob=None):
    """(ts, dWs, X0) of BSB-100, or of ``prob``, at N = 50 in the loss's layout."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.sim import time_major_batch

    prob = prob or BlackScholesBarenblatt(D=D)
    gen = torch.Generator(device=device).manual_seed(seed)
    ts, dWs = time_major_batch(gen, M, N_STEPS, D, prob.T)
    return ts, dWs, prob.x0.to(device).expand(M, D)


def check_train_step(net, device, prob=None, label: str = "train step") -> None:
    """Loss and every gradient of one full-width rollout of BSB-100, or of
    ``prob``, on the kernels (fused_net_u="cuda") against the f32 autograd
    path ("torch")."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn

    prob = prob or BlackScholesBarenblatt(D=D)
    batch = flagship_batch(TRAIN_M, device, seed=17, prob=prob)
    params = list(net.parameters())
    out = {}
    for backend in ("cuda", "torch"):
        loss_fn = make_loss_fn(prob, net, SolverConfig(fused_net_u=backend, remat=False))
        res = loss_fn(net, *batch)
        out[backend] = [res.loss.detach(), *torch.autograd.grad(res.loss, params)]
    names = ["loss"] + [f"d{n}" for n, _ in net.named_parameters()]
    for name, a, ref in zip(names, out["cuda"], out["torch"]):
        err, rel = _rel_err(a, ref)
        print(f"{label} {name}: max|d|={err:.3e} rel {rel:.3e} (tol {STEP_REL_TOL:g})")
        _require(bool(torch.isfinite(a).all()), f"{label} {name}: non-finite values")
        _require(rel <= STEP_REL_TOL, f"{label} {name}: kernels disagree with the f32 path")


def _kernel_trainer(device, prob=None, seed: int = 1, M: int = TRAIN_M):
    """BSB-100 (or ``prob``) at full width on the kernel pair K1 + K2."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    # remat=False, as the auto rule picks at M = 100: with remat the backward
    # re-runs each step's forward, and K1 would launch 51 + 49 times a step
    return Trainer(prob or BlackScholesBarenblatt(D=D), M=M, N=N_STEPS, layers=LAYERS,
                   solver_config=SolverConfig(fused_net_u="cuda", remat=False), seed=seed,
                   device=device)


# K1's kernel and K2's two, by the names a device trace gives them
K1_K2_KERNELS = ("mlp_u_z_fwd_kernel", "mlp_u_z_bwd_rows", "mlp_u_z_bwd_wgrad")


def traced_train(trainer, iters: int, log_every: int):
    """``trainer.train(iters, 1e-3, "Adam")`` under ``torch.profiler``
    (device activity). Returns the result, the host seconds (the profiler
    included), and how often the device ran each of K1's and K2's kernels in
    this run, counted by name in the trace. The wrappers see only a chunk's
    eager warm-up iteration and its capture, not the replays of the graph;
    the trace sees every kernel the device ran, graph nodes included (0 on
    the CPU, which has no device trace)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = trainer.device.type == "cuda"
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        res = trainer.train(iters, 1e-3, "Adam", log_every=log_every)
        if cuda:
            torch.cuda.synchronize(trainer.device)
    seconds = time.perf_counter() - t0
    runs = dict.fromkeys(K1_K2_KERNELS, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            m = re.search(r"mlp_u_z_\w+", e.name())
            if m and m.group(0) in runs:
                runs[m.group(0)] += 1
    return res, seconds, runs


def drive_training(device) -> dict:
    """The training path, through the user entry point, traced. Returns the
    wrapper calls and the kernel runs of this run and the trained Trainer."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt

    prob = BlackScholesBarenblatt(D=D)
    exact = float(prob.exact_solution(torch.zeros(1, 1), prob.x0[None])[0, 0])
    trainer = _kernel_trainer(device)
    y0_init = float(trainer.evaluate_u([[0.0]], prob.x0[None])[0][0, 0])
    zero_counts()
    res, seconds, runs = traced_train(trainer, TRAIN_ITERS, TRAIN_LOG_EVERY)
    counts = read_counts()
    print(f"training path: {TRAIN_ITERS} iterations in {seconds:.3f} s under the profiler "
          f"({TRAIN_ITERS / seconds:.3f} it/s), wrapper calls (warm-up + capture) "
          f"{json.dumps(counts)}, kernels run (trace) {json.dumps(runs)}")
    print(f"training: mean logged loss {json.dumps(res.graph[1].tolist())}; "
          f"Y0 {y0_init:.4f} -> {json.dumps(res.y0_history.tolist())}; exact {exact:.4f}")
    return {"counts": counts, "runs": runs, "trainer": trainer, "graph": res.graph,
            "y0": res.y0_history, "y0_init": y0_init, "exact": exact, "seconds": seconds}


def _check_captured_counts(run: dict, path: str) -> None:
    """A train() call of TRAIN_ITERS iterations in one chunk shape calls each
    of the K1 and K2 wrappers once per step of its eager warm-up iteration
    and of its capture, and the device runs K1's kernel and K2's two kernels
    once per step of every iteration: the warm-up and TRAIN_ITERS - 1
    replays."""
    want = 2 * (N_STEPS + 1)
    for name in ("mlp_u_z_fwd", "mlp_u_z_bwd"):
        n = run["counts"][name]
        _require(n == want, f"the {path} path called the {name} wrapper {n} times, not "
                 f"{want} (warm-up + capture)")
    want = TRAIN_ITERS * (N_STEPS + 1)
    for name, n in run["runs"].items():
        _require(n == want, f"the {path} path's trace ran {name} {n} times, not {want} "
                 f"({N_STEPS + 1} in each of {TRAIN_ITERS} iterations)")


def check_training(run) -> None:
    """Launch counts (wrapper calls, and the kernels the run's trace shows),
    the loss's fall and Y0's move."""
    _check_captured_counts(run, "training")
    losses = run["graph"][1]
    _require(bool(np.isfinite(losses).all()), "non-finite training loss")
    _require(losses[0] >= 10 * losses[-1],
             f"mean logged loss fell only {losses[0] / losses[-1]:.2f}x")
    exact = run["exact"]
    _require(abs(run["y0"][-1] - exact) < abs(run["y0_init"] - exact),
             "Y0 did not move toward the exact value")


def check_captured_chunk(device, iters: int = CAPTURE_CHECK_ITERS) -> None:
    """One chunk of ``iters`` captured iterations (an eager warm-up, the
    capture, then replays) against ``iters`` eager ``Trainer.step`` calls
    from the same state: losses, Y0s, parameters and Adam state, bit for
    bit."""
    captured, eager = _kernel_trainer(device, seed=5), _kernel_trainer(device, seed=5)
    captured.train(iters, 1e-3, "Adam", log_every=iters, verbose=False)
    chunk = next(iter(captured._chunk_cache.values()))
    _require(chunk.graph is not None, "the training chunk was not captured")
    steps = [eager.step(*eager._batch(), "Adam", 1e-3) for _ in range(iters)]
    same = {
        "losses": torch.equal(chunk.losses[:iters], torch.stack([s[0] for s in steps])),
        "y0": torch.equal(chunk.y0s[:iters], torch.stack([s[1] for s in steps])),
        "params": all(torch.equal(a, b) for a, b in zip(captured._params, eager._params)),
        "adam_state": all(
            torch.equal(a, b)
            for k in ("count", "mu", "nu")
            for a, b in zip(*(([t._opt_state[k]] if k == "count" else t._opt_state[k])
                              for t in (captured, eager)))),
        "generator": torch.equal(captured.generator.get_state(), eager.generator.get_state()),
    }
    print(f"captured chunk of {iters} iterations vs {iters} eager steps, bitwise: "
          + json.dumps(same))
    _require(all(same.values()), "the captured chunk differs from the eager steps")


def drive_phases(device) -> dict:
    """``TrainingPhases`` at the reference defaults on the kernel path; Y0
    must end nearer the exact value than after the first 400 iterations."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.train import TrainingPhases

    prob = BlackScholesBarenblatt(D=D)
    exact = float(prob.exact_solution(torch.zeros(1, 1), prob.x0[None])[0, 0])
    trainer = _kernel_trainer(device, seed=7)
    phases = TrainingPhases(trainer)
    t0 = time.perf_counter()
    phases.train_initial_phase(*PHASES[0])
    phases.fine_tuning_phase(*PHASES[1])
    seconds = time.perf_counter() - t0
    y0 = dict(zip(trainer.iteration, trainer.y0_log))
    # the log at iteration it holds Y0 of iteration it + log_every - 1
    base = abs(y0[PHASE_BASE_ITERS - PHASE_LOG_EVERY] - exact)
    final = abs(trainer.y0_log[-1] - exact)
    out = {"iterations": sum(n for n, _ in PHASES), "seconds": seconds,
           "it_per_s": sum(n for n, _ in PHASES) / seconds, "exact": exact,
           f"abs_y0_err_after_{PHASE_BASE_ITERS}": base, "abs_y0_err_final": final,
           "y0_final": trainer.y0_log[-1], "loss_final": trainer.training_loss[-1]}
    print("TrainingPhases: " + json.dumps(out))
    _require(final < base, "TrainingPhases did not bring Y0 nearer the exact value")
    return out


def time_training(device) -> dict:
    """Training iterations per second at bench.py's batch sizes, host clock
    around windows that end in a device synchronize: ``train`` (replays of
    the captured iteration, after a warm-up window that captures it) and a
    loop of eager ``Trainer.step`` calls on the trainer's own increments."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    out = {}
    for M in TRAIN_RATE_MS:
        n = RATE_ITERS[M]
        for backend in ("cuda", "torch"):
            tr = Trainer(BlackScholesBarenblatt(D=D), M=M, N=N_STEPS, layers=LAYERS, seed=2,
                         solver_config=SolverConfig(fused_net_u=backend, remat=False))
            tr.train(n, 1e-3, log_every=n, verbose=False)  # warm-up and capture
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            tr.train(n, 1e-3, log_every=n, verbose=False)
            torch.cuda.synchronize(device)
            out[f"{backend}_M{M}_captured_it_per_s"] = n / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            for _ in range(n):
                tr.step(*tr._batch(), "Adam", 1e-3)
            torch.cuda.synchronize(device)
            out[f"{backend}_M{M}_eager_it_per_s"] = n / (time.perf_counter() - t0)
    return out


TRACE_ITERS = 20  # kernel-path iterations in the profiled window


def _union_ms(spans) -> float:
    """Total length in ms of the union of (start, end) intervals in us."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def trace_iteration(device, iters: int = TRACE_ITERS, eager: bool = False) -> dict:
    """Where the time of a BSB-100 kernel-path training iteration at M = 100
    goes: host-clock ms per iteration without and with ``torch.profiler``,
    and from the profiler's device trace the busy ms per iteration (the
    union of kernel, copy and set intervals), the device's idle share, the
    kernels' ms by K1, K2 and the rest, and their launches by kernel name
    per iteration (K2 is two kernels). The window is one ``train`` chunk of
    replays of the captured iteration, or with ``eager`` a loop of
    ``Trainer.step`` calls."""
    from torch.profiler import ProfilerActivity, profile

    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    tr = Trainer(BlackScholesBarenblatt(D=D), M=TRAIN_M, N=N_STEPS, layers=LAYERS, seed=3,
                 solver_config=SolverConfig(fused_net_u="cuda", remat=False), device=device)

    def window() -> float:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if eager:
            for _ in range(iters):
                tr.step(*tr._batch(), "Adam", 1e-3)
        else:
            tr.train(iters, 1e-3, log_every=iters, verbose=False)
        torch.cuda.synchronize(device)
        return 1e3 * (time.perf_counter() - t0) / iters

    window()  # warm-up (and capture)
    wall = window()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = window()
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    device_events = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    _require(len(device_events) > 0, "the profiler recorded no device activity")

    # sum_partials_kernel: K2's second kernel in older trees, which
    # scripts/time_tree.py traces with this function too
    def kind(name: str) -> str:
        if "mlp_u_z_fwd" in name:
            return "k1"
        if "mlp_u_z_bwd" in name or "sum_partials" in name:
            return "k2"
        return "other"

    ms = {"k1": 0.0, "k2": 0.0, "other": 0.0}
    launches = {"k1": 0, "k2": 0, "other": 0}
    by_kernel, count_by_kernel = {}, {}  # K1's and K2's kernels by name, per iteration
    for e in device_events:
        if e["cat"] == "kernel":
            k = kind(e["name"])
            ms[k] += e["dur"] / 1e3 / iters
            launches[k] += 1
            if k != "other":
                name = re.search(r"mlp_u_z_\w+|sum_partials\w*", e["name"]).group(0)
                by_kernel[name] = by_kernel.get(name, 0.0) + e["dur"] / 1e3 / iters
                count_by_kernel[name] = count_by_kernel.get(name, 0) + 1
    busy = _union_ms((e["ts"], e["ts"] + e["dur"]) for e in device_events) / iters
    # "train": replays of the captured iteration in this tree, eager in trees
    # before the CUDA-graph chunk (scripts/time_tree.py traces those too)
    return {"window": "step loop" if eager else "train", "M": TRAIN_M,
            "iterations": iters, "wall_ms": wall, "traced_wall_ms": traced,
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / traced,
            "kernel_ms": ms, "k1_share": ms["k1"] / busy, "k2_share": ms["k2"] / busy,
            "kernel_launches": launches, "k1_k2_kernels_ms": by_kernel,
            "k1_k2_launches_per_iteration": {k: v / iters for k, v in count_by_kernel.items()}}


# ---- the serving path -------------------------------------------------------


def drive_serving(trainer, device) -> dict:
    """The serving path from a trained ``Trainer``, through the user entry
    points. Returns the launch counts of every kernel in this run and what
    it served."""
    from dnnpde_tpu_torch.ops.rollout_kernel import predict_paths_fast
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.serve import load_solution, save_solution

    prob = BlackScholesBarenblatt(D=D)
    net = trainer.params
    reqs = {B: requests(B, device, seed=100 + B) for B in SERVE_BATCHES}
    t_grid = torch.linspace(0.0, 1.0, 51)
    x_grid = requests(256, "cpu", seed=99)[1]

    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/bsb100_fc_sine.pt"
        save_solution(path, net, prob.dim)
        sol = load_solution(path, device=device)
        served = {B: sol.u_and_grad(*reqs[B]) for B in SERVE_BATCHES}
        surface = sol.surface(t_grid.numpy(), x_grid.numpy())
    # the verify skill's flagship read-back, on K1 under fused_net_u="cuda"
    t_star, W_star = trainer.fetch_minibatch(torch.Generator(device=device).manual_seed(5))
    X_star, Y_star = trainer.predict(prob.x0[None], t_star, W_star)
    Y = predict_paths_fast(trainer, M=M_PATHS, seed=4321)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    print(f"serving path: {seconds:.3f} s, launches {json.dumps(counts)}")
    return {"counts": counts, "served": served, "surface": surface, "Y": Y,
            "predicted": (X_star, Y_star), "reqs": reqs, "trainer": trainer, "sol": sol}


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


def check_serving(run, device) -> None:
    """What the serving path returned, against the plain autograd net_u and
    the plain rollout; K1 launched once per step of the one predict call."""
    from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths_reference
    from dnnpde_tpu_torch.solver import make_net_u

    n = run["counts"]["mlp_u_z_fwd"]
    _require(n == N_STEPS + 1, f"the serving path launched mlp_u_z_fwd {n} times, "
             f"not {N_STEPS + 1} (one Trainer.predict)")
    _require(run["counts"]["rollout_paths"] > 0, "the serving path never launched rollout_paths")
    X_star, Y_star = run["predicted"]
    M_star = run["trainer"].M
    _require(X_star.shape == (M_star, N_STEPS + 1, D) and Y_star.shape == (M_star, N_STEPS + 1, 1)
             and bool(np.isfinite(Y_star).all()), "Trainer.predict shapes or values")
    net = run["trainer"].params
    net_u = make_net_u(net)
    for B, (u, Z) in run["served"].items():
        t, X = run["reqs"][B]
        with torch.no_grad():
            u_ref, Z_ref = net_u(t, X)
        _, ru = _rel_err(torch.from_numpy(u), u_ref.cpu())
        _, rz = _rel_err(torch.from_numpy(Z), Z_ref.cpu())
        print(f"served B={B}: u {u.shape} Z {Z.shape} vs f32 autograd: rel du {ru:.3e} "
              f"rel dZ {rz:.3e} tol rel {SERVE_REL_TOL:g} of max|.|")
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


# ---- the basket path ----------------------------------------------------------


def drive_basket(device) -> dict:
    """The basket-call path through the user entry points: train
    BasketCallOption(D=100) on K1 + K2, price it with the CLI's Monte-Carlo
    oracle and with the pricer on K4, take greeks, serve paths through K3.
    Returns the launch counts of all four kernels in this run and what it
    computed."""
    from dnnpde_tpu_torch.evals import compute_greeks
    from dnnpde_tpu_torch.numerics import basket_call_mc, basket_delta_mc
    from dnnpde_tpu_torch.ops.path_kernel import fused_basket_call_mc
    from dnnpde_tpu_torch.ops.rollout_kernel import predict_paths_fast
    from dnnpde_tpu_torch.pde import BasketCallOption

    prob = BasketCallOption(D=D)
    x0 = prob.x0.to(device)
    oracle_args = (x0, prob.strike, prob.T, prob.r, prob.sigma_bar)
    trainer = _kernel_trainer(device, prob)
    y0_init = float(trainer.evaluate_u([[0.0]], prob.x0[None])[0][0, 0])
    zero_counts()
    res, seconds, runs = traced_train(trainer, TRAIN_ITERS, TRAIN_LOG_EVERY)
    oracle = basket_call_mc(torch.Generator(device=device).manual_seed(0), *oracle_args,
                            num_paths=BASKET_ORACLE_PATHS, payoff="mean")
    fused = fused_basket_call_mc(0, *oracle_args, payoff="mean")
    rng = torch.Generator().manual_seed(21)
    t_b = torch.rand((BASKET_GREEK_BATCH, 1), generator=rng)
    X_b = torch.exp(0.2 * torch.randn((BASKET_GREEK_BATCH, D), generator=rng))
    greeks_x0 = compute_greeks(trainer, [[0.0]], prob.x0[None])
    greeks_b = compute_greeks(trainer, t_b, X_b)
    delta_mc = basket_delta_mc(torch.Generator(device=device).manual_seed(1), *oracle_args,
                               num_paths=BASKET_DELTA_PATHS)
    Y = predict_paths_fast(trainer, M=M_PATHS, seed=99)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts = read_counts()
    oracle = tuple(float(v) for v in oracle)
    fused = tuple(float(v) for v in fused)
    print(f"basket path: {TRAIN_ITERS} iterations in {seconds:.3f} s under the profiler "
          f"({TRAIN_ITERS / seconds:.3f} it/s), wrapper calls {json.dumps(counts)} (K1 and "
          f"K2: warm-up + capture), K1 and K2 kernels run (trace) {json.dumps(runs)}")
    print(f"basket: mean logged loss {json.dumps(res.graph[1].tolist())}; Y0 {y0_init:.6f} -> "
          f"{json.dumps(res.y0_history.tolist())}; oracle basket_call_mc "
          f"{oracle[0]:.6f} +- {oracle[1]:.6f}, fused_basket_call_mc (K4) "
          f"{fused[0]:.6f} +- {fused[1]:.6f}")
    print(f"basket greeks at x0: u {greeks_x0[0][0, 0]:.6f}, sum delta "
          f"{greeks_x0[1].sum():.6f} (basket_delta_mc {float(delta_mc.sum()):.6f}), "
          f"sum gamma {greeks_x0[2].sum():.6f}")
    return {"counts": counts, "runs": runs, "trainer": trainer, "graph": res.graph,
            "y0": res.y0_history, "y0_init": y0_init, "oracle": oracle, "fused": fused, "greeks_x0": greeks_x0,
            "greeks_b": greeks_b, "delta_mc": delta_mc, "Y": Y, "seconds": seconds}


def check_basket(run, device) -> None:
    from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths_reference

    _check_captured_counts(run, "basket")
    for name in ("gbm_terminal", "rollout_paths"):
        _require(run["counts"][name] > 0, f"the basket path never launched {name}")
    losses = run["graph"][1]
    _require(bool(np.isfinite(losses).all()), "non-finite basket training loss")
    # 10x, as BSB's: after 400 iterations the fall lands anywhere in ~20-400x
    # with the seed and with ulp-level changes of the kernels' sums, and the
    # CUDA-core kernels before the tensor-core redesign fell less than 100x at
    # 11 of 24 seeds (PERF.md, Findings); that the kernel path trains the
    # basket's model is held by the step check instead
    _require(losses[0] >= 10 * losses[-1],
             f"basket: mean logged loss fell only {losses[0] / losses[-1]:.2f}x, not 10x")
    (p1, se1), (p2, se2) = run["oracle"], run["fused"]
    _require(abs(p1 - p2) < 4 * (se1**2 + se2**2) ** 0.5,
             f"basket oracles disagree: {p1} +- {se1} vs {p2} +- {se2}")
    err0, err1 = abs(run["y0_init"] - p1), abs(run["y0"][-1] - p1)
    print(f"basket |Y0 - oracle|: {err0:.6f} -> {err1:.6f}")
    _require(err1 <= 0.5 * err0, "basket: |Y0 - oracle| did not halve")
    for where, (u, delta, gamma), B in (("x0", run["greeks_x0"], 1),
                                        ("batch", run["greeks_b"], BASKET_GREEK_BATCH)):
        _require(u.shape == (B, 1) and delta.shape == (B, D) and gamma.shape == (B, D),
                 f"basket greeks shapes at {where}")
        _require(bool(np.isfinite(u).all() and np.isfinite(delta).all()
                      and np.isfinite(gamma).all()), f"basket greeks non-finite at {where}")
    dmc = run["delta_mc"]
    _require(dmc.shape == (D,) and bool(torch.isfinite(dmc).all()), "basket_delta_mc")
    tr = run["trainer"]
    Ws, bs = weights(tr.params)
    Y_ref = rollout_paths_reference(
        Ws, bs, tr.problem.x0.to(device), N=N_STEPS, dt=1.0 / N_STEPS,
        mu_c=0.05, sig_c=0.2, seed=99, M=M_PATHS,
    )
    _require(run["Y"].shape == (M_PATHS, N_STEPS + 1), "basket paths shape")
    # The basket's u (~0.05) is a small sum of 256 head terms a_i W_L[i]
    # (|a_i| <= 1) that cancel, so one bf16 flip, which moves a term by up to
    # 2^-8 |W_L[i]|, is large beside max|u| and the largest difference is
    # held to BASKET_FLIP_TOL of sum |W_L| instead: about 65 flips of a mean
    # head term on one value, some 10x the largest difference seen on an
    # H100 and a fifth of max|u|. The mean stays within MEAN_REL_TOL of
    # max|u|, which a wrong index or a race on a few percent of paths breaks.
    head = float(Ws[-1].abs().sum())
    print(f"basket paths: max|Y| {float(Y_ref.abs().max()):.5f}, head bound sum|W_L| {head:.4f}")
    _compare("basket predict_paths_fast vs plain rollout (mu_c 0.05, sig_c 0.2)", run["Y"], Y_ref,
             max_abs_tol=BASKET_FLIP_TOL * head)


def time_basket(run, device) -> dict:
    """The basket path's training rate, and the host time of each oracle
    call (request to result)."""
    from dnnpde_tpu_torch.numerics import basket_call_mc
    from dnnpde_tpu_torch.ops.path_kernel import fused_basket_call_mc

    prob = run["trainer"].problem
    args = (prob.x0.to(device), prob.strike, prob.T, prob.r, prob.sigma_bar)
    gen = torch.Generator(device=device).manual_seed(0)
    return {
        "train_it_per_s_under_profiler": TRAIN_ITERS / run["seconds"],
        f"basket_call_mc_{BASKET_ORACLE_PATHS}_ms": host_ms(
            lambda: basket_call_mc(gen, *args, num_paths=BASKET_ORACLE_PATHS), 5),
        f"fused_basket_call_mc_{K4_M}_ms": host_ms(lambda: fused_basket_call_mc(0, *args), 5),
    }


# ---- the harness path ---------------------------------------------------------
#
# The oracle-gated rows of bench/harness.py that the FC kernel paths above do
# not cover: NAIS-Net on the HJB and the basket, and the Heston problem with
# its full diffusion and BS control-variate head. No kernel serves them (K1 +
# K2 take plain MLPs without an output transform, K3 GBM-type problems, and
# the basket oracle here is basket_call_mc), so each trains on the f32
# autograd path in captured chunks.

HJB_M, HJB_ITERS = 16, 1000  # the reference-config row's M
HESTON_M, HESTON_ITERS = 128, 1000
NAIS_BASKET_ITERS = 400
HARNESS_LOG_EVERY = 100
HARNESS_CAPTURE_ITERS = 20
HESTON_Y0_TOL = 0.05  # |Y0 - closed form| after 1000 iterations, relative
HESTON_MC_PATHS, HESTON_MC_STEPS = 100_000, 1000  # heston_mc_price's defaults
HESTON_SERVE_B = 4096


def _timed_train(trainer, iters: int, lr: float = 1e-3):
    t0 = time.perf_counter()
    res = trainer.train(iters, lr, "Adam", log_every=HARNESS_LOG_EVERY, verbose=False)
    return res, time.perf_counter() - t0


def check_harness_capture(device) -> dict:
    """A 20-iteration captured chunk against 20 eager ``Trainer.step`` calls
    from the same state, bit for bit, for a NAIS-Net trainer (HJB-100) and a
    Heston trainer."""
    from dnnpde_tpu_torch.pde import HamiltonJacobiBellman, HestonPDE
    from dnnpde_tpu_torch.train import Trainer

    k, out = HARNESS_CAPTURE_ITERS, {}
    cases = {"naisnet_hjb": (HamiltonJacobiBellman(D=D), "Naisnet", "ReLU", HJB_M),
             "heston": (HestonPDE(), "FC", "Sine", HESTON_M)}
    for name, (prob, mode, act, M) in cases.items():
        captured, eager = (Trainer(prob, M=M, N=N_STEPS, mode=mode, activation=act, seed=6,
                                   ema_decay=0.999, device=device) for _ in range(2))
        captured.train(k, 1e-3, "Adam", log_every=k, verbose=False)
        chunk = next(iter(captured._chunk_cache.values()))
        _require(chunk.graph is not None, f"the {name} chunk was not captured")
        steps = [eager.step(*eager._batch(), "Adam", 1e-3) for _ in range(k)]
        same = {
            "losses": torch.equal(chunk.losses[:k], torch.stack([s[0] for s in steps])),
            "y0": torch.equal(chunk.y0s[:k], torch.stack([s[1] for s in steps])),
            "params": all(torch.equal(a, b) for a, b in zip(captured._params, eager._params)),
            "ema": all(torch.equal(a, b) for a, b in zip(captured.ema_params.parameters(),
                                                         eager.ema_params.parameters())),
            "generator": torch.equal(captured.generator.get_state(),
                                     eager.generator.get_state()),
        }
        print(f"harness {name}: captured chunk of {k} iterations vs {k} eager steps, "
              f"bitwise: {json.dumps(same)}")
        _require(all(same.values()), f"the {name} captured chunk differs from the eager steps")
        out[name] = same
    return out


def drive_harness(device) -> dict:
    """The harness path through the user entry points: HJB-100 on NAIS-Net
    ReLU against ``hjb_exact_mc``; Heston (FC-Sine, the "bs" head) against
    its closed form, Milstein Monte Carlo and Crank-Nicolson, then served;
    the basket on NAIS-Net Sine against ``basket_call_mc``. Returns the
    launch counts of all four kernels in this run (none is on this path)
    and what it computed."""
    from dnnpde_tpu_torch.numerics import (
        CNGrid,
        HestonParams,
        basket_call_mc,
        crank_nicolson_heston,
        heston_call_price,
        heston_mc_price,
        hjb_exact_mc,
    )
    from dnnpde_tpu_torch.pde import BasketCallOption, HamiltonJacobiBellman, HestonPDE
    from dnnpde_tpu_torch.serve import load_solution, save_solution
    from dnnpde_tpu_torch.train import Trainer

    zero_counts()
    out: dict = {"rows": {}}
    gen = torch.Generator(device=device)

    prob = HamiltonJacobiBellman(D=D)
    hjb = Trainer(prob, M=HJB_M, N=N_STEPS, mode="Naisnet", activation="ReLU", seed=0,
                  device=device)
    res, seconds = _timed_train(hjb, HJB_ITERS)
    oracle = float(hjb_exact_mc(gen.manual_seed(0), 0.0, np.zeros(D)))
    out["rows"]["hjb_100d_naisnet_relu"] = dict(
        M=HJB_M, iterations=HJB_ITERS, seconds=seconds, it_per_s=HJB_ITERS / seconds,
        oracle=oracle, y0=res.y0_history.tolist(), mean_loss=res.graph[1].tolist())

    prob = HestonPDE()
    params = HestonParams(K=prob.strike, r=prob.r, T=prob.T, kappa=prob.kappa,
                          theta=prob.theta, sigma=prob.sigma_v, rho=prob.rho, v0=prob.v0)
    heston = Trainer(prob, M=HESTON_M, N=N_STEPS, seed=0, device=device)
    res, seconds = _timed_train(heston, HESTON_ITERS)
    closed = float(heston_call_price(prob.S0, prob.v0, params, order=512, device=device))
    mc = tuple(float(v) for v in heston_mc_price(
        gen.manual_seed(0), prob.S0, params, HESTON_MC_PATHS, HESTON_MC_STEPS))
    # test_numerics.py's Crank-Nicolson case: S0 = K = 100, r = 0.03, 60 x 30 x 400
    cn_params = HestonParams(K=100.0, r=0.03, T=1.0, kappa=2.0, theta=0.2, sigma=0.3,
                             rho=0.8, v0=0.2)
    cn = crank_nicolson_heston(100.0, cn_params, CNGrid(S_max=200.0, v_max=0.5, n_S=60,
                                                        n_v=30, n_t=400),
                               dtype=torch.float64, device=device)[0]
    cn_closed = float(heston_call_price(100.0, 0.2, cn_params, order=512,
                                        device=device).double())
    rng = torch.Generator().manual_seed(33)
    t_req = torch.rand((HESTON_SERVE_B, 1), generator=rng)
    t_req[: HESTON_SERVE_B // 8] = prob.T  # the head's terminal values
    X_req = torch.stack([torch.exp(0.3 * torch.randn(HESTON_SERVE_B, generator=rng)),
                         0.4 * torch.rand(HESTON_SERVE_B, generator=rng)], dim=-1)
    with tempfile.TemporaryDirectory() as tmp:
        save_solution(f"{tmp}/heston.pt", heston)
        served = load_solution(f"{tmp}/heston.pt", device=device).u_and_grad(t_req, X_req)
    with torch.no_grad():
        ref = heston.net_u(t_req.to(device), X_req.to(device))
    out["rows"]["heston_m128"] = dict(
        M=HESTON_M, iterations=HESTON_ITERS, seconds=seconds,
        it_per_s=HESTON_ITERS / seconds, oracle=closed, y0=res.y0_history.tolist(),
        mean_loss=res.graph[1].tolist())
    out["heston"] = {"closed": closed, "mc": mc, "cn": cn, "cn_closed": cn_closed,
                     "served": served, "net_u": tuple(r.cpu().numpy() for r in ref),
                     "terminal": t_req[:, 0] == prob.T}

    prob = BasketCallOption(D=D)
    basket = Trainer(prob, M=TRAIN_M, N=N_STEPS, mode="Naisnet", seed=1, device=device)
    y0_init = float(basket.evaluate_u([[0.0]], prob.x0[None])[0][0, 0])
    res, seconds = _timed_train(basket, NAIS_BASKET_ITERS)
    oracle = basket_call_mc(gen.manual_seed(0), prob.x0.to(device), prob.strike, prob.T,
                            prob.r, prob.sigma_bar, num_paths=BASKET_ORACLE_PATHS)
    out["rows"]["basket_100d_naisnet_sine"] = dict(
        M=TRAIN_M, iterations=NAIS_BASKET_ITERS, seconds=seconds,
        it_per_s=NAIS_BASKET_ITERS / seconds, oracle=float(oracle[0]),
        oracle_se=float(oracle[1]), y0_init=y0_init, y0=res.y0_history.tolist(),
        mean_loss=res.graph[1].tolist())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["counts"] = read_counts()
    for name, row in out["rows"].items():
        print(f"harness {name}: " + json.dumps(row))
    print(f"harness heston oracles: closed form {closed:.6f}, heston_mc_price "
          f"{mc[0]:.6f} +- {mc[1]:.6f}; Crank-Nicolson (K = 100) {cn:.6f} vs closed form "
          f"{cn_closed:.6f}")
    print(f"harness path: kernel launches {json.dumps(out['counts'])}")
    return out


def check_harness(run) -> None:
    """The harness path's checks: the losses fall, HJB-100's |Y0 - oracle|
    halves from iteration 100 to the end, Heston's Y0 is finite and within
    5 % of the closed form, the three Heston oracles agree at
    test_numerics.py's tolerances, the served Heston (u, Z) equal the
    trainer's net_u within SERVE_REL_TOL of max|.|, Z at t = T is finite,
    and the NAIS-Net basket passes the FC basket's checks."""
    rows = run["rows"]
    for name, row in rows.items():
        losses = np.asarray(row["mean_loss"])
        _require(bool(np.isfinite(losses).all() and np.isfinite(row["y0"]).all()),
                 f"harness {name}: non-finite loss or Y0")
        _require(losses[-1] < losses[0], f"harness {name}: the mean logged loss did not fall")
    hjb = rows["hjb_100d_naisnet_relu"]
    err100, err = (abs(hjb["y0"][i] - hjb["oracle"]) for i in (0, -1))
    print(f"harness HJB |Y0 - oracle|: {err100:.5f} after {HARNESS_LOG_EVERY} iterations -> "
          f"{err:.5f} after {HJB_ITERS}")
    _require(err < 0.5 * err100, "HJB-100: |Y0 - oracle| did not halve from iteration 100")

    hes = rows["heston_m128"]
    # the harness's read of a run's Y0: the mean of its last three logs (a
    # logged Y0 at M = 128 wobbles some 5 % from log to log)
    y0 = float(np.mean(hes["y0"][-3:]))
    rel = abs(y0 - hes["oracle"]) / hes["oracle"]
    print(f"harness Heston Y0 (last three logs) {y0:.6f} vs closed form {hes['oracle']:.6f}: "
          f"rel {rel:.4f} (tol {HESTON_Y0_TOL})")
    _require(rel < HESTON_Y0_TOL, "Heston: Y0 not within 5 % of the closed form")
    h = run["heston"]
    (mc, se) = h["mc"]
    _require(abs(mc - h["closed"]) < 4 * se + 5e-3,
             f"Heston: Milstein MC {mc} +- {se} vs closed form {h['closed']}")
    _require(abs(h["cn"] - h["cn_closed"]) < 0.01 * h["cn_closed"],
             f"Heston: Crank-Nicolson {h['cn']} vs closed form {h['cn_closed']}")
    (u, Z), (u_ref, Z_ref) = h["served"], h["net_u"]
    _, ru = _rel_err(torch.from_numpy(u), torch.from_numpy(u_ref))
    _, rz = _rel_err(torch.from_numpy(Z), torch.from_numpy(Z_ref))
    terminal = h["terminal"].numpy()
    print(f"harness Heston served (u, Z) vs trainer net_u: rel du {ru:.3e} rel dZ {rz:.3e} "
          f"(tol {SERVE_REL_TOL:g}); {int(terminal.sum())} requests at t = T")
    _require(bool(np.isfinite(u).all() and np.isfinite(Z).all()), "Heston: served non-finite")
    _require(bool(np.isfinite(Z[terminal]).all()), "Heston: Z at t = T non-finite")
    _require(ru <= SERVE_REL_TOL and rz <= SERVE_REL_TOL, "Heston: served (u, Z) off net_u")

    bsk = rows["basket_100d_naisnet_sine"]
    losses = bsk["mean_loss"]
    _require(losses[0] >= 10 * losses[-1],
             f"NAIS-Net basket: mean logged loss fell only {losses[0] / losses[-1]:.2f}x")
    err0, err1 = abs(bsk["y0_init"] - bsk["oracle"]), abs(bsk["y0"][-1] - bsk["oracle"])
    print(f"harness NAIS-Net basket |Y0 - oracle|: {err0:.6f} -> {err1:.6f}")
    _require(err1 <= 0.5 * err0, "NAIS-Net basket: |Y0 - oracle| did not halve")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from dnnpde_tpu_torch.ops import _build

    t_start = time.perf_counter()
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

    from dnnpde_tpu_torch.pde import BasketCallOption, BlackScholesBarenblatt

    net = make_net(device)
    Ws, bs = weights(net)
    x0 = BlackScholesBarenblatt(D=D).x0.to(device)

    k1 = check_k1(Ws, bs, device)
    k2 = check_k2(Ws, bs, device)
    k3 = check_k3(Ws, bs, x0, device)
    k4 = check_k4(device)
    check_train_step(net, device)
    check_train_step(net, device, BasketCallOption(D=D), "basket train step")

    train = drive_training(device)
    check_training(train)
    check_captured_chunk(device)
    drive_phases(device)
    run = drive_serving(train["trainer"], device)
    check_serving(run, device)
    basket = drive_basket(device)
    check_basket(basket, device)
    check_harness_capture(device)
    harness = drive_harness(device)
    check_harness(harness)

    print("training rate: " + json.dumps(time_training(device)))
    print("training iteration (traced, captured chunk): " + json.dumps(trace_iteration(device)))
    print("training iteration (traced, eager steps): "
          + json.dumps(trace_iteration(device, eager=True)))
    print("serving latency: " + json.dumps(time_serving(run)))
    print("basket path: " + json.dumps(time_basket(basket, device)))
    print("harness rows (captured it/s, seconds): " + json.dumps(
        {name: {"it_per_s": row["it_per_s"], "seconds": row["seconds"]}
         for name, row in harness["rows"].items()}))
    k1.update(time_k1(Ws, bs, device))
    k2.update(time_k2(Ws, bs, device))
    k3_seed, k3_dws = time_k3(Ws, bs, x0, k3.pop("dWs"), device)
    k3.update(k3_seed)
    print("K3 explicit-dW variant: " + json.dumps(k3_dws))
    k4.update(time_k4(device)["basket"])  # the basket path's shape

    paths = {"training": train, "serving": run, "basket": basket, "harness": harness}

    def launches(name, traced_names=()):
        """The kernel's launches on each path: on the training and basket
        paths K1's and K2's from the run's trace (K2: its row-chain kernel,
        which runs once with its weight-gradient kernel in every call),
        otherwise the wrapper's count, which sees every launch of an eager
        path; beside them the wrapper calls on every path."""
        calls = {p: r["counts"][name] for p, r in paths.items()}
        by_path = {p: r["runs"][traced_names[0]] if traced_names and "runs" in r else calls[p]
                   for p, r in paths.items()}
        out = {"launches": sum(by_path.values()), "launches_by_path": by_path,
               "wrapper_calls_by_path": calls}
        if traced_names:
            out["traced_runs_by_kernel"] = {
                p: {k: r["runs"][k] for k in traced_names} for p, r in paths.items()
                if "runs" in r}
        return out

    kernels = [
        {"name": "mlp_u_z_fwd", "route": "cuda",
         "source": "dnnpde_tpu_torch/csrc/mlp_u_z_fwd.cu",
         "replaces": "dnnpde_tpu/ops/mlp_kernel.py:188",
         **launches("mlp_u_z_fwd", K1_K2_KERNELS[:1]), **k1},
        {"name": "mlp_u_z_bwd", "route": "cuda",
         "source": "dnnpde_tpu_torch/csrc/mlp_u_z_bwd.cu",
         "replaces": "dnnpde_tpu/ops/mlp_kernel.py:221",
         **launches("mlp_u_z_bwd", K1_K2_KERNELS[1:]), **k2},
        {"name": "rollout_paths", "route": "cuda",
         "source": "dnnpde_tpu_torch/csrc/rollout.cu",
         "replaces": "dnnpde_tpu/ops/rollout_kernel.py:182",
         **launches("rollout_paths"), **k3},
        {"name": "gbm_terminal", "route": "cuda",
         "source": "dnnpde_tpu_torch/csrc/gbm_terminal.cu",
         "replaces": "dnnpde_tpu/ops/path_kernel.py:180",
         **launches("gbm_terminal"), **k4},
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
