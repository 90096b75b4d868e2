"""The port's optimizers (``train/optimizers.py``) against the JAX
package's optax chains: 5 steps on the same parameters and gradients, with
the gradients' global norm above the clipping threshold 1 and below it."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnnpde_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from dnnpde_tpu_torch.train import build_optimizer

NAMES = ["Adam", "SGD", "RMSprop", "AdamW", "Adadelta", "Adagrad", "Adamax", "ASGD"]
SHAPES = [(3, 4), (4,), (4, 1)]


def _run(name, grad_scale, lr=1e-2, steps=5):
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(grad_scale * rng.normal(size=s)).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]

    tx = jax_build_optimizer(name, lr)
    p_j = [jnp.asarray(p) for p in params]
    state = tx.init(p_j)
    opt = build_optimizer(name, lr)
    p_t = [torch.from_numpy(p.copy()) for p in params]
    st = opt.init(p_t)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        u_t, st = opt.update([torch.from_numpy(x) for x in g], st, p_t)
        p_t = [p + u for p, u in zip(p_t, u_t)]
        for a, r in zip(p_t, p_j):
            # the same f32 arithmetic; only the global norm's summation
            # order and transcendental roundings differ
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7)
    return np.sqrt(sum(float((x**2).sum()) for x in grads[0]))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("clipped", [True, False], ids=["norm_above_1", "norm_below_1"])
def test_matches_optax(name, clipped):
    norm = _run(name, grad_scale=1.0 if clipped else 0.05)
    assert (norm > 1.0) == clipped


def test_unknown_name_and_lbfgs_raise():
    """An unknown name raises; LBFGS, once not ported, now builds optax's
    zoom-linesearch LBFGS without clipping (tests/test_torch_lbfgs.py)."""
    from dnnpde_tpu_torch.train.optimizers import LBFGS

    with pytest.raises(ValueError, match="not recognized"):
        build_optimizer("Lion", 1e-3)
    tx = build_optimizer("LBFGS", 1e-3)
    assert isinstance(tx, LBFGS) and tx.learning_rate == 1e-3
    assert not hasattr(tx, "clip_norm")
