"""Training throughput of the port: 100-D Black–Scholes–Barenblatt deep-BSDE
training on one CUDA card, the counterpart of the repo root's ``bench.py``.

    python -m dnnpde_tpu_torch.bench

Prints ONE JSON line with ``bench.py``'s keys, ``{"metric", "value", "unit",
"vs_baseline", "extra"}``, for the port: M = 100, N = 50, D = 100, FC-Sine
[101, 256×4, 1], Adam at 1e-3, through ``Trainer.train`` (each chunk a
replayed CUDA graph). ``value`` is the default Trainer (f32 autograd net_u,
as ``bench.py`` times the JAX default); ``extra`` holds the m512 row, the
m2048 row as the median of 3 runs, the ``m2048_bf16`` row
(``net_kwargs={"compute_dtype": "bfloat16"}``) and, under ``kernel_``, the
same rows on the kernel pair K1 + K2 (``SolverConfig(fused_net_u="cuda")``).
Each rate is iterations over the host-clock time of long chunks that end in
a read of their logs, after a warm-up of the same length (the warm-up
captures the chunk's graph); ``spread`` gives each row's per-chunk (or, for
m2048, per-run) rates. ``vs_baseline`` is the M = 100 rate over that of a
reference-style PyTorch loop (host NumPy minibatch, Python time loop,
autograd Z per step) on the CPU, the yardstick of ``bench.py``'s own
``vs_baseline`` on its TPU host; ``extra["vs_reference_style_on_card"]``
divides by the same loop on the card. The card's name and power limit are
printed first. ``run()`` takes smaller sizes, and ``device="cpu"`` (where
the kernels take their plain versions).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

M, N, D = 100, 50, 100
WIDTH, DEPTH = 256, 4
CHUNK = 1000
BENCH_ITERS = 3000
BASELINE_WARMUP, BASELINE_ITERS = 3, 20


def bench_port(batch: int, iters: int, chunk: int, kernels: bool, net_kwargs=None, *,
               dim: int = D, steps: int = N, width: int = WIDTH, device=None) -> dict:
    """Iterations/s of ``Trainer.train`` over ``iters`` iterations in chunks
    of ``chunk``, after a warm-up chunk; and each chunk's own rate."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    config = SolverConfig(fused_net_u="cuda", remat=False) if kernels else None
    trainer = Trainer(BlackScholesBarenblatt(D=dim), M=batch, N=steps,
                      layers=[dim + 1] + [width] * DEPTH + [1], seed=0, solver_config=config,
                      net_kwargs=net_kwargs, device=device)
    trainer.train(chunk, 1e-3, "Adam", log_every=chunk, verbose=False)  # warm-up, capture
    rates, total = [], 0.0
    for _ in range(iters // chunk):
        t0 = time.perf_counter()
        res = trainer.train(chunk, 1e-3, "Adam", log_every=chunk, verbose=False)
        _ = float(res.graph[1][-1])  # the chunk's logs are on the host: it has finished
        dt = time.perf_counter() - t0
        total += dt
        rates.append(chunk / dt)
    return {"it_per_s": len(rates) * chunk / total, "chunks": rates}


def bench_reference_style(batch: int = M, dim: int = D, steps: int = N, width: int = WIDTH,
                          device=None) -> float:
    """Iterations/s of a minimal reference-style PyTorch loop (the reference's
    per-iteration structure: host NumPy minibatch, Python time loop,
    ``autograd.grad`` per step, Adam, clipping), the ``vs_baseline`` of
    ``bench.py``; the median over ``BASELINE_ITERS`` iterations."""
    from dnnpde_tpu_torch.runtime import default_device

    dev = default_device(device)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    layers = [dim + 1] + [width] * DEPTH + [1]
    hidden = [torch.nn.Linear(a, b, device=dev) for a, b in zip(layers[:-2], layers[1:-1])]
    out = torch.nn.Linear(layers[-2], layers[-1], device=dev)
    params = [p for m in hidden + [out] for p in m.parameters()]
    opt = torch.optim.Adam(params, lr=1e-3)
    T, r, sb = 1.0, 0.05, 0.4
    x0 = np.tile([1.0, 0.5], (dim + 1) // 2)[:dim].astype(np.float32)
    dt = T / steps

    def net_u(t, X):
        a = torch.cat([t, X], dim=1)
        for h in hidden:
            a = torch.sin(h(a))
        u = out(a)
        return u, torch.autograd.grad(u.sum(), X, create_graph=True)[0]

    times = []
    for i in range(BASELINE_WARMUP + BASELINE_ITERS):
        tic = time.perf_counter()
        dW = torch.from_numpy((np.sqrt(dt) * rng.normal(size=(batch, steps, dim)))
                              .astype(np.float32)).to(dev)
        X = torch.from_numpy(np.broadcast_to(x0, (batch, dim)).copy()).to(dev)
        X.requires_grad_(True)
        t = torch.zeros((batch, 1), device=dev)
        Y, Z = net_u(t, X)
        loss = 0.0
        for n in range(steps):
            sdw = sb * X * dW[:, n, :]
            X1 = (X + sdw).detach().requires_grad_(True)
            phi = r * (Y - (X * Z).sum(1, keepdim=True))
            Y_tilde = Y + phi * dt + (Z * sdw).sum(1, keepdim=True)
            t = t + dt
            Y, Z = net_u(t, X1)
            loss = loss + ((Y - Y_tilde) ** 2).sum()
            X = X1
        g = (X**2).sum(1, keepdim=True)
        loss = loss + ((Y - g) ** 2).sum()
        Dg = torch.autograd.grad(g.sum(), X, create_graph=True)[0]
        loss = loss + ((Z - Dg) ** 2).sum()
        opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        opt.step()
        _ = float(loss.detach())  # the reference reads the loss back every iteration
        if i >= BASELINE_WARMUP:
            times.append(time.perf_counter() - tic)
    return 1.0 / float(np.median(times))


def run(dim: int = D, steps: int = N, width: int = WIDTH, scale: float = 1.0,
        device=None) -> dict:
    """The bench line as a dict (``bench.py``'s rows, on both paths)."""
    def it(n: int) -> int:
        return max(1, int(n * scale))

    kw = dict(dim=dim, steps=steps, width=width, device=device)
    extra: dict = {"spread": {}}
    value = None
    for prefix, kernels in (("", False), ("kernel_", True)):
        row = bench_port(M, it(BENCH_ITERS), it(CHUNK), kernels, **kw)
        extra["spread"][f"{prefix}m100_chunks_iters_per_sec"] = row["chunks"]
        if kernels:
            extra["kernel_iters_per_sec"] = row["it_per_s"]
        else:
            value = row["it_per_s"]
        ips = bench_port(512, it(1000), it(1000), kernels, **kw)["it_per_s"]
        extra[f"{prefix}m512_iters_per_sec"] = ips
        extra[f"{prefix}m512_path_steps_per_sec"] = ips * 512 * steps
        runs = [bench_port(2048, it(500), it(500), kernels, **kw)["it_per_s"] for _ in range(3)]
        ips = sorted(runs)[1]
        extra[f"{prefix}m2048_iters_per_sec"] = ips
        extra[f"{prefix}m2048_path_steps_per_sec"] = ips * 2048 * steps
        extra[f"{prefix}m2048_runs_iters_per_sec"] = runs
    ips = bench_port(2048, it(500), it(500), False, {"compute_dtype": "bfloat16"}, **kw)["it_per_s"]
    extra["m2048_bf16_iters_per_sec"] = ips
    extra["m2048_bf16_path_steps_per_sec"] = ips * 2048 * steps
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    extra["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    extra["vs_reference_style_on_card"] = (
        value / bench_reference_style(M, dim, steps, width, dev) if dev.type == "cuda" else None)
    return {
        "metric": "bsb100d_train_iters_per_sec",
        "value": value,
        "unit": f"iters/s (M={M},N={steps},D={dim} FC-Sine deep-BSDE step, PyTorch port)",
        "vs_baseline": value / bench_reference_style(M, dim, steps, width, "cpu"),
        "extra": extra,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run()))
    return 0
