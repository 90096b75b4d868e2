"""The port's GBM-type problems (calls, basket, BSB test case) against the
JAX package, method by method, on the same numpy inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.pde import problems as jp
from dnnpde_tpu.ops.rollout_kernel import gbm_coefficients as jax_gbm_coefficients
from dnnpde_tpu_torch.ops.rollout_kernel import gbm_coefficients
from dnnpde_tpu_torch.pde import (
    BasketCallOption,
    BSPDETestCase,
    CallOption1D,
    CallOptionND,
)

ATOL, RTOL = 1e-6, 1e-5  # f32 elementwise math in both frameworks
M = 9

CASES = {
    "call1d": (CallOption1D, jp.CallOption1D, {}),
    "call1d_D3_strike": (CallOption1D, jp.CallOption1D, {"D": 3, "strike": 2.5}),
    "callnd": (CallOptionND, jp.CallOptionND, {"D": 6}),
    "basket": (BasketCallOption, jp.BasketCallOption, {"D": 6}),
    "basket_weighted": (BasketCallOption, jp.BasketCallOption,
                        {"D": 3, "weights": (0.5, 0.3, 0.2), "strike": 0.9}),
    "bspde": (BSPDETestCase, jp.BSPDETestCase, {"D": 6, "T": 0.7}),
}


def _pair(name):
    port_cls, jax_cls, kw = CASES[name]
    return port_cls(**kw), jax_cls(**kw)


def _inputs(D, seed=3):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.0, size=(M, 1)).astype(np.float32)
    X = (1.0 + 0.3 * rng.normal(size=(M, D))).astype(np.float32)
    Y = rng.normal(size=(M, 1)).astype(np.float32)
    Z = rng.normal(size=(M, D)).astype(np.float32)
    return t, X, Y, Z


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_problem_matches_jax(name):
    p, j = _pair(name)
    assert (p.dim, p.noise_dim, p.sigma_kind, p.T, p.name) == (
        j.dim, j.noise_dim, j.sigma_kind, j.T, j.name)
    assert p.has_output_transform is False and j.clamp_u is None
    if hasattr(j, "K"):
        assert p.K == j.K
    np.testing.assert_array_equal(p.x0.numpy(), np.asarray(j.x0))
    t, X, Y, Z = _inputs(p.dim)
    T, Xt, Yt, Zt = (torch.from_numpy(a) for a in (t, X, Y, Z))
    _close(p.mu(T, Xt, Yt, Zt), j.mu(t, X, Y, Z))
    _close(p.sigma(T, Xt, Yt), j.sigma(t, X, Y))
    _close(p.phi(T, Xt, Yt, Zt), j.phi(t, X, Y, Z))
    _close(p.g(Xt), j.g(jnp.asarray(X)))
    _close(p.Dg(Xt), j.Dg(jnp.asarray(X)))


@pytest.mark.parametrize("method", ["exact_solution", "reference_exact_solution"])
def test_bspde_exact_solutions_match_jax(method):
    p, j = _pair("bspde")
    t, X, _, _ = _inputs(p.dim, seed=5)
    _close(getattr(p, method)(torch.from_numpy(t), torch.from_numpy(X)),
           getattr(j, method)(t, X))


def test_basket_weights_must_have_length_d():
    with pytest.raises(ValueError, match="weights must have length D=3"):
        BasketCallOption(D=3, weights=(0.5, 0.5))
    assert BasketCallOption(D=2, weights=(0.5, 0.5)).weights == (0.5, 0.5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gbm_coefficients_match_jax(name):
    p, j = _pair(name)
    assert gbm_coefficients(p) == jax_gbm_coefficients(j) == (p.r, p.sigma_bar)
