"""Brownian increments of the port: moments, antithetic pairs and Cholesky
correlation by statistics (the port draws from torch's generator, the JAX
package from threefry), and the time grid exactly against JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dnnpde_tpu.sim.brownian import time_grid as jax_time_grid
from dnnpde_tpu_torch.sim import brownian_increments, brownian_paths, time_grid, time_major_batch


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_moments():
    M, N, D, dt = 4000, 3, 2, 0.04
    dw = brownian_increments(_gen(), M, N, D, dt)
    assert dw.shape == (M, N, D) and dw.dtype == torch.float32
    n = dw.numel()
    # mean within 4 standard errors, variance within 4 of its standard errors
    assert abs(float(dw.mean())) < 4 * (dt / n) ** 0.5
    assert abs(float(dw.var()) - dt) < 4 * dt * (2.0 / n) ** 0.5


def test_determinism_per_seed():
    a = brownian_increments(_gen(5), 8, 2, 3, 0.1)
    b = brownian_increments(_gen(5), 8, 2, 3, 0.1)
    c = brownian_increments(_gen(6), 8, 2, 3, 0.1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_antithetic_pairs():
    dw = brownian_increments(_gen(), 10, 4, 3, 0.25, antithetic=True)
    assert torch.equal(dw[:5], -dw[5:])
    with pytest.raises(ValueError, match="even M"):
        brownian_increments(_gen(), 7, 4, 3, 0.25, antithetic=True)


def test_cholesky_correlation():
    rho = 0.6
    corr = torch.tensor([[1.0, rho], [rho, 1.0]])
    L = torch.linalg.cholesky(corr)
    dw = brownian_increments(_gen(1), 6000, 2, 2, 0.01, chol=L).reshape(-1, 2)
    emp = float(np.corrcoef(dw.numpy().T)[0, 1])
    # 12000 pairs: standard error of the correlation ≈ (1 - ρ²)/√n ≈ 0.006
    assert abs(emp - rho) < 0.03
    assert abs(float(dw.var(dim=0).mean()) - 0.01) < 0.0005


def test_time_grid_matches_jax_exactly():
    for M, N, T in [(3, 5, 1.0), (2, 50, 0.7), (1, 37, 1.3), (1, 100, 1.0), (1, 7, 0.3)]:
        ours = time_grid(M, N, T, device="cpu").numpy()
        np.testing.assert_array_equal(ours, np.asarray(jax_time_grid(M, N, T)))


def test_paths_and_time_major_layout():
    t, W = brownian_paths(_gen(2), 4, 3, 2, 1.0)
    assert t.shape == (4, 4, 1) and W.shape == (4, 4, 2)
    assert torch.count_nonzero(W[:, 0]) == 0
    dw = brownian_increments(_gen(2), 4, 3, 2, 1.0 / 3)
    torch.testing.assert_close(W[:, 1:], dw.cumsum(dim=1))
    ts, dWs = time_major_batch(_gen(2), 4, 3, 2, 1.0)
    assert ts.shape == (4, 4, 1) and dWs.shape == (3, 4, 2)
    assert torch.equal(dWs, dw.transpose(0, 1))
    assert torch.equal(ts[:, 0, 0], t[0, :, 0])
