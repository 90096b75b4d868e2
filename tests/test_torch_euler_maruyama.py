"""The port's forward-SDE simulators (``sim/euler_maruyama.py``): the
Euler–Maruyama roll against the JAX scan on the same increments, and the
GBM path generator by its log-increment identity, antithetic mirror and
moments (its normals come from torch's generator, not threefry)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.sim.euler_maruyama import euler_maruyama as jax_euler_maruyama
from dnnpde_tpu_torch.sim import euler_maruyama, gbm_paths


def _drift(lib):
    return lambda t, x: 0.05 * x + 0.1 * lib.sin(t) * lib.ones_like(x)


def _sigma_dw(lib):
    return lambda t, x, dw: (0.2 + 0.1 * t) * x * dw


@pytest.mark.parametrize("t0", [0.0, 0.3])
def test_euler_maruyama_matches_jax_on_the_same_increments(t0):
    rng = np.random.default_rng(1)
    M, N, D, dt = 7, 6, 3, 0.1
    x0 = rng.uniform(0.5, 1.5, size=(M, D)).astype(np.float32)
    dW = (np.sqrt(dt) * rng.normal(size=(M, N, D))).astype(np.float32)
    port = euler_maruyama(_drift(torch), _sigma_dw(torch), torch.from_numpy(x0),
                          torch.from_numpy(dW), dt, t0=t0)
    ref = jax_euler_maruyama(_drift(jnp), _sigma_dw(jnp), jnp.asarray(x0), jnp.asarray(dW),
                             dt, t0=t0)
    assert port.shape == (M, N + 1, D)
    # f32 elementwise steps in both; t accumulates by + dt in both
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_gbm_paths_log_increment_identity():
    S0, r, sig, T, N, M = np.array([1.0, 0.5, 2.0], np.float32), 0.05, 0.3, 1.0, 4, 64
    paths = gbm_paths(_gen(1), S0, r, sig, T, N, M)
    assert paths.shape == (M, N + 1, 3) and paths.device.type == "cpu"
    np.testing.assert_array_equal(paths[:, 0].numpy(), np.broadcast_to(S0, (M, 3)))
    # log S_{n+1} − log S_n = (r − σ²/2)dt + σ·dW with dW = √dt·N(0, 1)
    dt = T / N
    dW = torch.randn((M, N, 3), generator=_gen(1)) * dt**0.5
    incr = torch.diff(torch.log(paths), dim=1)
    torch.testing.assert_close(incr, (r - 0.5 * sig**2) * dt + sig * dW, rtol=0, atol=2e-6)


def test_gbm_paths_antithetic_mirror_and_even_m():
    paths = gbm_paths(_gen(2), [1.0, 1.0], 0.03, [0.2, 0.4], 1.0, 3, 10, antithetic=True)
    dt, drift = 1.0 / 3, (0.03 - 0.5 * torch.tensor([0.2, 0.4]) ** 2) * (1.0 / 3)
    noise = torch.diff(torch.log(paths), dim=1) - drift  # σ·dW
    torch.testing.assert_close(noise[5:], -noise[:5], rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="even M"):
        gbm_paths(_gen(2), [1.0], 0.03, 0.2, 1.0, 3, 9, antithetic=True)


def test_gbm_paths_moments_and_correlation():
    M, C = 40000, np.array([[1.0, 0.6], [0.6, 1.0]])
    L = torch.from_numpy(np.linalg.cholesky(C)).float()
    ST = gbm_paths(_gen(3), [1.0, 1.0], 0.05, 0.2, 1.0, 2, M, chol=L)[:, -1]
    logs = torch.log(ST).numpy()
    # E[log S_T] = (r − σ²/2)T, std σ√T; 5 SE and 2 % of σ
    np.testing.assert_allclose(logs.mean(0), 0.03, atol=5 * 0.2 / np.sqrt(M))
    np.testing.assert_allclose(logs.std(0), 0.2, rtol=0.02)
    assert abs(np.corrcoef(logs.T)[0, 1] - 0.6) < 0.02
