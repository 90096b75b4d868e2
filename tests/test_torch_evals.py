"""The port's evaluation layer (``evals/``) against the JAX package: metrics
exactly, greeks and the learned price surface with the same weights carried
across by ``params.py``, and the prediction sampler's shapes and seeding."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dnnpde_tpu.evals import greeks as jgreeks
from dnnpde_tpu.evals import metrics as jmetrics
from dnnpde_tpu.pde import BasketCallOption as JaxBasket
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch.evals import (
    ConvergenceAnalysis,
    PredictionGenerator,
    compute_greeks,
    error_stats,
    heston_greeks,
    learned_price_surface,
    relative_l2_error,
    squared_errors,
)
from dnnpde_tpu_torch.evals.predictions import _sample_seed
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BasketCallOption
from dnnpde_tpu_torch.train import Trainer

D = 3
LAYERS = [D + 1, 16, 16, 1]


def test_metrics_match_jax_exactly():
    rng = np.random.default_rng(0)
    pred, exact = rng.normal(size=(5, 4)), rng.normal(size=(5, 4))
    np.testing.assert_array_equal(squared_errors(pred, exact), jmetrics.squared_errors(pred, exact))
    assert error_stats(pred, exact) == jmetrics.error_stats(pred, exact)
    for axis in (None, 0, 1):
        np.testing.assert_array_equal(relative_l2_error(pred, exact, axis=axis),
                                      jmetrics.relative_l2_error(pred, exact, axis=axis))
    preds = [exact + 0.5**k * rng.normal(size=exact.shape) for k in range(3)]
    got = ConvergenceAnalysis(preds, exact).calculate_errors()
    want = jmetrics.ConvergenceAnalysis(preds, exact).calculate_errors()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def trainers():
    """A JAX and a port Trainer on the basket with the same weights."""
    jtr = JaxTrainer(JaxBasket(D=D), M=8, N=4, layers=LAYERS, seed=3)
    tr = Trainer(BasketCallOption(D=D), M=8, N=4, layers=LAYERS, seed=0, device="cpu")
    src = from_flax_params(jax.tree.map(np.asarray, jtr.params), "sine", device="cpu")
    with torch.no_grad():
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    return jtr, tr


def _rel(port, ref, tol):
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_compute_greeks_matches_jax(trainers):
    jtr, tr = trainers
    rng = np.random.default_rng(1)
    t = rng.uniform(0.0, 1.0, size=(6, 1)).astype(np.float32)
    X = rng.uniform(0.6, 1.4, size=(6, D)).astype(np.float32)
    got = compute_greeks(tr, t, X)
    want = jgreeks.compute_greeks(jtr, t, X)
    # f32 in both; first and second derivatives through the same sine net
    _rel(got[0], want[0], 1e-5)
    _rel(got[1], want[1], 1e-5)
    _rel(got[2], want[2], 1e-4)
    u, _ = tr.evaluate_u(t, X)
    np.testing.assert_allclose(got[0], u, rtol=1e-6, atol=1e-7)


def test_learned_price_surface_matches_jax(trainers):
    jtr, tr = trainers
    s, t = np.linspace(0.5, 1.5, 7), np.linspace(0.0, 1.0, 4)
    got = learned_price_surface(tr, s, t, dim=1)
    assert got.shape == (4, 7)
    _rel(got, jgreeks.learned_price_surface(jtr, s, t, dim=1), 1e-5)


def test_heston_layout_and_ema_raise(trainers):
    from dnnpde_tpu_torch.pde import CallOptionND

    tr2 = Trainer(CallOptionND(D=2), M=4, N=2, layers=[3, 8, 1], device="cpu")
    price, delta, gamma = heston_greeks(tr2, [0.9, 1.1], [0.04, 0.05], 0.5)
    assert price.shape == delta.shape == gamma.shape == (2,)
    u, dl, gm = compute_greeks(tr2, [[0.5], [0.5]], [[0.9, 0.04], [1.1, 0.05]])
    np.testing.assert_array_equal(delta, dl[:, 0])
    # use_ema needs a trainer built with ema_decay, as in the JAX package
    with pytest.raises(ValueError, match="ema_decay"):
        compute_greeks(trainers[1], [[0.0]], [[1.0] * D], use_ema=True)
    with pytest.raises(ValueError, match="ema_decay"):
        PredictionGenerator(trainers[1], use_ema=True).generate_predictions()


def test_prediction_generator_shapes_and_seeding(trainers):
    _, tr = trainers
    res = PredictionGenerator(tr, num_samples=3, seed=37).generate_predictions()
    assert res.t_test.shape == (24, 5, 1) and res.W_test.shape == (8, 5, D)
    assert res.X_pred.shape == (24, 5, D) and res.Y_pred.shape == (24, 5, 1)
    again = PredictionGenerator(tr, num_samples=3, seed=37).generate_predictions()
    np.testing.assert_array_equal(res.X_pred, again.X_pred)
    other = PredictionGenerator(tr, num_samples=3, seed=38).generate_predictions()
    assert not np.allclose(res.X_pred, other.X_pred)
    # sample i is the minibatch of a generator seeded from (seed, i)
    t2, W2 = tr.fetch_minibatch(generator=torch.Generator().manual_seed(_sample_seed(37, 2)))
    np.testing.assert_array_equal(res.W_test, W2.numpy())
    X2, _ = tr.predict(tr.problem.x0[None], t2, W2)
    np.testing.assert_array_equal(res.X_pred[16:], X2)
    assert not np.allclose(res.X_pred[:8], res.X_pred[8:16])
    xi = PredictionGenerator(tr, Xi=np.full(D, 1.2), num_samples=1).generate_predictions()
    np.testing.assert_allclose(xi.X_pred[:, 0], 1.2)
