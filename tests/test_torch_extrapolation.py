"""The port's Richardson extrapolation (``train/extrapolation.py``) on the CPU
at a small size: ``richardson_y0`` combines its two reads as 2·y0(2N) −
y0(N), exactly; ``train_y0`` reads the mean of the last ``tail`` logged Y0s,
or with ``use_ema`` the EMA net's u at (0, x0) (held within 1e-6 of the
greeks' EMA read, another path to the same number); passed trainers are
reset and keep their captured chunks, and a reset trainer repeats a fresh
one's read exactly."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dnnpde_tpu_torch.evals import compute_greeks
from dnnpde_tpu_torch.pde import CallOption1D
from dnnpde_tpu_torch.train import Trainer, richardson_y0, train_y0

KW = dict(layers=[2, 16, 16, 1], device="cpu")
PHASES = ((6, 1e-3), (4, 1e-4))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_richardson_combines_the_two_resolutions():
    prob = CallOption1D(D=1)
    out = richardson_y0(prob, M=8, N=2, phases=PHASES, seed=1, warmup=3, **KW)
    assert set(out) == {"y0_N", "y0_2N", "y0_richardson"}
    assert out["y0_richardson"] == 2.0 * out["y0_2N"] - out["y0_N"]
    assert out["y0_N"] == train_y0(prob, 8, 2, PHASES, seed=1, warmup=3, **KW)
    assert out["y0_2N"] == train_y0(prob, 8, 4, PHASES, seed=1, warmup=3, **KW)
    assert out["y0_N"] != out["y0_2N"]


def test_train_y0_reads_the_tail_mean():
    prob = CallOption1D(D=1)
    tr = Trainer(prob, M=8, N=2, **KW)
    y = train_y0(prob, 8, 2, ((500, 1e-3), (500, 1e-4)), seed=0, warmup=5, tail=2,
                 trainer=tr)
    # the warm-up's log, then one log every 500 iterations of each phase
    assert len(tr.y0_log) == 1 + 1 + 1 and tr._next_it == 1005
    assert y == float(np.mean(tr.y0_log[-2:]))


def test_train_y0_use_ema_reads_the_ema_net_at_x0():
    prob = CallOption1D(D=1)
    tr = Trainer(prob, M=8, N=2, ema_decay=0.9, **KW)
    y = train_y0(prob, 8, 2, PHASES, seed=0, warmup=0, trainer=tr, use_ema=True)
    u, _, _ = compute_greeks(tr, [[0.0]], prob.x0.numpy()[None, :], use_ema=True)
    assert abs(y - float(u[0, 0])) <= 1e-6 * max(abs(float(u[0, 0])), 1e-3)
    u_raw, _, _ = compute_greeks(tr, [[0.0]], prob.x0.numpy()[None, :])
    assert y != float(u_raw[0, 0])


def test_passed_trainers_are_reset_and_keep_their_chunks():
    prob = CallOption1D(D=1)
    trainers = (Trainer(prob, M=8, N=2, **KW), Trainer(prob, M=8, N=4, **KW))
    first = richardson_y0(prob, M=8, N=2, phases=PHASES, seed=3, warmup=2, trainers=trainers)
    chunks = [dict(t._chunk_cache) for t in trainers]
    again = richardson_y0(prob, M=8, N=2, phases=PHASES, seed=3, warmup=2, trainers=trainers)
    assert again == first
    for t, before in zip(trainers, chunks):
        assert all(t._chunk_cache[k] is v for k, v in before.items())
    fresh = richardson_y0(prob, M=8, N=2, phases=PHASES, seed=3, warmup=2, **KW)
    assert fresh == first
