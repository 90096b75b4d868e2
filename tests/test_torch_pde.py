"""The port's PDE problems against the JAX package, method by method, on the
same inputs (numpy, from a seeded generator)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt, PDEProblem

D, M = 6, 9
ATOL, RTOL = 1e-6, 1e-5  # f32 elementwise math in both frameworks


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    t = rng.uniform(0.0, 1.0, size=(M, 1)).astype(np.float32)
    X = (1.0 + 0.3 * rng.normal(size=(M, D))).astype(np.float32)
    Y = rng.normal(size=(M, 1)).astype(np.float32)
    Z = rng.normal(size=(M, D)).astype(np.float32)
    dW = (0.1 * rng.normal(size=(M, D))).astype(np.float32)
    return t, X, Y, Z, dW


def _close(port, ref):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL
    )


def test_bsb_metadata():
    p, j = BlackScholesBarenblatt(D=D), JaxBSB(D=D)
    assert (p.dim, p.noise_dim, p.sigma_kind, p.T) == (j.dim, j.noise_dim, j.sigma_kind, j.T)
    assert p.has_output_transform is False and j.has_output_transform is False
    np.testing.assert_array_equal(p.x0.numpy(), np.asarray(j.x0))
    assert p.x0.dtype == torch.float32
    np.testing.assert_array_equal(BlackScholesBarenblatt(D=5).x0.numpy(), [1, 0.5, 1, 0.5, 1])


@pytest.mark.parametrize("method", ["mu", "sigma", "phi", "g", "Dg", "exact", "sigma_dw", "transform"])
def test_bsb_methods_match_jax(inputs, method):
    t, X, Y, Z, dW = inputs
    p, j = BlackScholesBarenblatt(D=D), JaxBSB(D=D)
    tt, Xt, Yt, Zt, dWt = (torch.from_numpy(a) for a in inputs)
    if method == "mu":
        _close(p.mu(tt, Xt, Yt, Zt), j.mu(t, X, Y, Z))
    elif method == "sigma":
        _close(p.sigma(tt, Xt, Yt), j.sigma(t, X, Y))
    elif method == "phi":
        _close(p.phi(tt, Xt, Yt, Zt), j.phi(t, X, Y, Z))
    elif method == "g":
        _close(p.g(Xt), j.g(jnp.asarray(X)))
    elif method == "Dg":
        _close(p.Dg(Xt), j.Dg(jnp.asarray(X)))
        _close(p.Dg(Xt), 2.0 * X)  # closed form of ∇ΣX²
    elif method == "exact":
        _close(p.exact_solution(tt, Xt), j.exact_solution(t, X))
    elif method == "sigma_dw":
        sig = p.sigma(tt, Xt, Yt)
        _close(p.sigma_dw(sig, dWt), j.sigma_dw(j.sigma(t, X, Y), dW))
    else:
        _close(p.transform_u(tt, Xt, Yt), j.transform_u(t, X, Y))


@pytest.mark.parametrize("mode", ["hard", "softplus"])
def test_clamp_transform_matches_jax(inputs, mode):
    """The base contract's output clamp, on a subclass that turns it on."""
    t, X, Y, _, _ = inputs

    def clamped(base):
        @dataclasses.dataclass(frozen=True)
        class Clamped(base):
            @property
            def clamp_u(self):
                return 0.1

            @property
            def clamp_mode(self):
                return mode

        return Clamped(D=D)

    p, j = clamped(BlackScholesBarenblatt), clamped(JaxBSB)
    assert p.has_output_transform and j.has_output_transform
    _close(p.transform_u(torch.from_numpy(t), torch.from_numpy(X), torch.from_numpy(Y)),
           j.transform_u(t, X, Y))


def test_full_sigma_dw_and_abstract_base():
    rng = np.random.default_rng(3)
    sig = rng.normal(size=(M, 3, 2)).astype(np.float32)
    dW = rng.normal(size=(M, 2)).astype(np.float32)

    class Full(PDEProblem):
        @property
        def sigma_kind(self):
            return "full"

    out = Full().sigma_dw(torch.from_numpy(sig), torch.from_numpy(dW))
    np.testing.assert_allclose(out.numpy(), np.einsum("mij,mj->mi", sig, dW), rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError):
        PDEProblem().dim
    assert PDEProblem().exact_solution(None, None) is None
