"""K3 (``ops/rollout_kernel.py``) of the port against the JAX package.

The explicit-increment plain rollout is held against ``rollout_paths_xla``
and the Pallas kernel in interpret mode on the same dW. The seed variant
draws Philox normals, which the JAX package does not have: the generator is
checked against the Philox4x32-10 known-answer vectors and by its moments,
and the rollout's column means against the JAX rollout on numpy normals.
The CUDA kernel itself is tested on the card by ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.ops.rollout_kernel import rollout_paths_pallas, rollout_paths_xla
from dnnpde_tpu_torch.nets import MLP
from dnnpde_tpu_torch.ops.rollout_kernel import (
    gbm_coefficients,
    philox4x32_10,
    philox_normals,
    predict_paths_fast,
    rollout_paths,
    rollout_paths_reference,
)
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt, PDEProblem


def _mlp(rng, D, H, depth):
    """The weights of tests/test_rollout_kernel.py::_mlp, as numpy."""
    Ws = [(rng.normal(size=(D + 1, H)) * 0.1).astype(np.float32)]
    bs = [np.zeros(H, np.float32)]
    for _ in range(depth - 2):
        Ws.append((rng.normal(size=(H, H)) * 0.05).astype(np.float32))
        bs.append(np.zeros(H, np.float32))
    Ws.append((rng.normal(size=(H, 1)) * 0.1).astype(np.float32))
    bs.append((rng.normal(size=(1,)) * 0.1).astype(np.float32))
    return Ws, bs


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_close_but_flips(actual, desired):
    """rtol 1e-5 everywhere but where a bf16 rounding flipped.

    Both sides round every dot operand to bf16 at the same places but sum
    in f32 in other orders, so now and then a value within an f32 rounding
    of a bf16 tie rounds the other way and moves what follows by about a
    bf16 step of one term. Such values may be at most 5% of the whole and
    off by at most 1e-3 of max|desired|; a wrong index moves most values."""
    off = ~np.isclose(actual, desired, rtol=1e-5, atol=1e-6)
    assert off.mean() <= 0.05, f"{off.sum()} of {off.size} values differ"
    scale = np.abs(desired).max()
    np.testing.assert_allclose(actual, desired, rtol=0, atol=1e-3 * scale)


def _x0(D):
    return np.tile([1.0, 0.5], (D + 1) // 2)[:D].astype(np.float32)


@pytest.mark.parametrize(
    "D,H,depth,N,M,tile_b",
    [
        (5, 256, 5, 7, 16, 8),
        (3, 128, 3, 4, 24, 8),
        (100, 128, 4, 5, 8, 8),
    ],
)
def test_plain_rollout_matches_xla_and_pallas(D, H, depth, N, M, tile_b):
    rng = np.random.default_rng(0)
    Ws, bs = _mlp(rng, D, H, depth)
    x0 = _x0(D)
    dWs = (rng.normal(size=(M, N, D)) * 0.14).astype(np.float32)
    kw = dict(N=N, dt=1.0 / N, mu_c=0.05, sig_c=0.2)
    jW, jb = [jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs]
    y_xla = np.asarray(rollout_paths_xla(jW, jb, jnp.asarray(x0), dWs=jnp.asarray(dWs), **kw))
    y_pal = np.asarray(rollout_paths_pallas(jW, jb, jnp.asarray(x0), dWs=jnp.asarray(dWs),
                                            tile_b=tile_b, interpret=True, **kw))
    y = rollout_paths(_t(Ws), _t(bs), torch.from_numpy(x0), dWs=torch.from_numpy(dWs), **kw)
    assert y.shape == (M, N + 1)
    _assert_close_but_flips(y.numpy(), y_xla)
    _assert_close_but_flips(y.numpy(), y_pal)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        words = philox4x32_10(*[torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
        assert tuple(int(w) for w in words) == want


def test_philox_normals_moments_and_determinism():
    z = philox_normals(seed=7, M=2048, n=3, D=10)
    assert z.shape == (2048, 10) and z.dtype == torch.float32
    n = z.numel()
    assert abs(float(z.mean())) < 4 / n**0.5
    assert abs(float(z.var()) - 1.0) < 4 * (2.0 / n) ** 0.5
    assert torch.equal(z, philox_normals(seed=7, M=2048, n=3, D=10))
    assert not torch.equal(z, philox_normals(seed=8, M=2048, n=3, D=10))
    assert not torch.equal(z, philox_normals(seed=7, M=2048, n=4, D=10))
    # counter-based: a path's numbers do not depend on how many paths are drawn
    assert torch.equal(z[:5], philox_normals(seed=7, M=5, n=3, D=10))
    # a 64-bit seed uses both key words
    assert not torch.equal(philox_normals(seed=1, M=4, n=0, D=4),
                           philox_normals(seed=1 + 2**32, M=4, n=0, D=4))


def test_seed_variant_column_means_match_jax_on_numpy_normals():
    """Same model, different random numbers: the column means of Y agree
    within 4 standard errors."""
    rng = np.random.default_rng(1)
    D, N, M = 3, 4, 4096
    Ws, bs = _mlp(rng, D, 128, 3)
    x0 = _x0(D)
    kw = dict(N=N, dt=1.0 / N, mu_c=0.0, sig_c=0.4)
    y = rollout_paths(_t(Ws), _t(bs), torch.from_numpy(x0), seed=123, M=M, **kw).numpy()
    dWs = (np.sqrt(kw["dt"]) * rng.normal(size=(M, N, D))).astype(np.float32)
    y_ref = np.asarray(rollout_paths_xla([jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs],
                                         jnp.asarray(x0), dWs=jnp.asarray(dWs), **kw))
    se = np.sqrt(y.var(axis=0) / M + y_ref.var(axis=0) / M)
    np.testing.assert_array_equal(y[:, 0], y[0, 0])  # t = 0: every path sits at x0
    np.testing.assert_allclose(y[0, 0], y_ref[0, 0], rtol=1e-6)
    assert np.all(np.abs(y.mean(axis=0) - y_ref.mean(axis=0)) <= 4 * se + 1e-7)
    assert np.all(y.std(axis=0)[1:] > 0)


def test_rollout_argument_validation():
    Ws, bs = _mlp(np.random.default_rng(0), 3, 128, 3)
    Ws, bs = _t(Ws), _t(bs)
    x0 = torch.ones(3)
    kw = dict(N=4, dt=0.25, mu_c=0.0, sig_c=0.4)
    with pytest.raises(ValueError, match="exactly one"):
        rollout_paths(Ws, bs, x0, **kw)
    with pytest.raises(ValueError, match="M is required"):
        rollout_paths(Ws, bs, x0, seed=1, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        rollout_paths_reference(Ws, bs, x0, dWs=torch.zeros(2, 4, 3), seed=1, **kw)
    with pytest.raises(ValueError, match="dWs must be"):
        rollout_paths(Ws, bs, x0, dWs=torch.zeros(2, 3, 3), **kw)
    with pytest.raises(ValueError, match="inputs"):
        rollout_paths(Ws, bs, torch.ones(4), seed=1, M=2, **kw)


def test_gbm_coefficients():
    assert gbm_coefficients(BlackScholesBarenblatt(D=4)) == (0.0, 0.4)
    assert gbm_coefficients(BlackScholesBarenblatt(D=4, sigma_bar=0.3)) == (0.0, 0.3)
    assert gbm_coefficients(PDEProblem()) is None


def _trainer(problem, **kw):
    net = MLP([problem.dim + 1, 16, 16, 1], "sine",
              generator=torch.Generator().manual_seed(0), device="cpu")
    base = dict(problem=problem, params=net, N=3, mode="FC", activation="Sine", chol=None)
    return SimpleNamespace(**{**base, **kw})


def test_predict_paths_fast_guards():
    @dataclasses.dataclass(frozen=True)
    class NotGBM(PDEProblem):
        name: str = "NotGBM"

        @property
        def dim(self):
            return 2

    @dataclasses.dataclass(frozen=True)
    class Clamped(BlackScholesBarenblatt):
        @property
        def clamp_u(self):
            return 0.0

    with pytest.raises(ValueError, match="not GBM"):
        predict_paths_fast(_trainer(NotGBM()), M=4)
    with pytest.raises(ValueError, match="FC-sine"):
        predict_paths_fast(_trainer(BlackScholesBarenblatt(D=2), mode="Naisnet"), M=4)
    with pytest.raises(ValueError, match="FC-sine"):
        predict_paths_fast(_trainer(BlackScholesBarenblatt(D=2), activation="Tanh"), M=4)
    with pytest.raises(ValueError, match="transforms"):
        predict_paths_fast(_trainer(Clamped(D=2)), M=4)
    with pytest.raises(ValueError, match="correlate"):
        predict_paths_fast(_trainer(BlackScholesBarenblatt(D=2), chol=torch.eye(2)), M=4)


def test_predict_paths_fast_is_the_seeded_rollout():
    from dnnpde_tpu_torch.params import extract_mlp_params

    tr = _trainer(BlackScholesBarenblatt(D=3))
    Y = predict_paths_fast(tr, M=10, seed=5)
    with torch.no_grad():
        Ws, bs = extract_mlp_params(tr.params)
        ref = rollout_paths_reference(Ws, bs, tr.problem.x0, N=3, dt=1.0 / 3, mu_c=0.0,
                                      sig_c=0.4, seed=5, M=10)
    assert Y.shape == (10, 4) and not Y.requires_grad
    torch.testing.assert_close(Y, ref, rtol=0, atol=0)
