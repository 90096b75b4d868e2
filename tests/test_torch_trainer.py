"""The port's Trainer (``train/trainer.py``): ``Trainer.step`` against the
JAX package's value_and_grad + optax update on the same batches, and the
loop's behaviour on the CPU at a small size."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu.solver import SolverConfig as JaxConfig
from dnnpde_tpu.solver import make_loss_fn as jax_make_loss_fn
from dnnpde_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.solver import SolverConfig
from dnnpde_tpu_torch.train import Trainer

D, M, N = 4, 8, 4
LAYERS = [D + 1, 16, 16, 1]


def _trainer(**kw):
    kw = {"M": M, "N": N, "layers": LAYERS, "device": "cpu", "seed": 0, **kw}
    return Trainer(BlackScholesBarenblatt(D=D), **kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.broadcast_to(np.linspace(0, 1, N + 1, dtype=np.float32)[:, None, None],
                         (N + 1, M, 1)).copy()
    X0 = np.tile(np.asarray(JaxBSB(D=D).x0), (M, 1)).astype(np.float32)
    return [(ts, (0.5 * rng.normal(size=(N, M, D))).astype(np.float32), X0) for _ in range(n)]


def test_step_matches_jax_value_and_grad_and_optax():
    net = jax_build_network("FC", LAYERS, "Sine")
    params = net.init(jax.random.PRNGKey(4), jnp.ones((1, D + 1)))
    tr = _trainer(solver_config=SolverConfig(remat=False))
    with torch.no_grad():
        src = from_flax_params(jax.tree.map(np.asarray, params), "sine", device="cpu")
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    loss_fn = jax_make_loss_fn(JaxBSB(D=D), net, JaxConfig(remat=False))
    tx = jax_build_optimizer("Adam", 1e-2)
    state = tx.init(params)
    for ts, dWs, X0 in _batches(3):
        (loss_j, res), grads = jax.value_and_grad(
            lambda p: (lambda r: (r.loss, r))(loss_fn(p, ts, dWs, X0)), has_aux=True)(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        loss, y0 = tr.step(*(torch.from_numpy(a) for a in (ts, dWs, X0)), "Adam", 1e-2)
        # f32 in both frameworks; other summation orders through the rollout
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
        np.testing.assert_allclose(float(y0), float(res.Y0), rtol=1e-5, atol=1e-6)
    want = from_flax_params(jax.tree.map(np.asarray, params), "sine", device="cpu")
    for a, r in zip(tr.params.parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), r.detach().numpy(), rtol=1e-4, atol=1e-6)


def test_cpu_training_lowers_the_loss():
    tr = _trainer(M=16)
    res = tr.train(60, 1e-3, "Adam", log_every=20, verbose=False)
    assert res.graph.shape == (2, 3)
    np.testing.assert_array_equal(res.graph[0], [0, 20, 40])
    assert np.isfinite(res.graph[1]).all() and res.graph[1][-1] < res.graph[1][0]
    assert res.y0_history.shape == (3,) and res.min_loss <= res.graph[1].min()
    tr.train(10, 1e-3, "Adam", log_every=10, verbose=False)  # continues the counter
    assert tr.iteration[-1] == 60


def test_fetch_minibatch_predict_and_evaluate_shapes():
    tr = _trainer()
    t, W = tr.fetch_minibatch()
    assert t.shape == (M, N + 1, 1) and W.shape == (M, N + 1, D)
    assert torch.all(W[:, 0] == 0)
    t5, W5 = tr.fetch_minibatch(M=5, N=3)
    assert t5.shape == (5, 4, 1) and W5.shape == (5, 4, D)
    X, Y = tr.predict(tr.problem.x0[None], t, W)
    assert X.shape == (M, N + 1, D) and Y.shape == (M, N + 1, 1)
    assert tr.M == M
    u, Z = tr.evaluate_u(np.zeros((3, 1)), np.ones((3, D)))
    assert u.shape == (3, 1) and Z.shape == (3, D)


@pytest.mark.parametrize("guard", [True, False])
def test_nan_guard_skips_a_non_finite_step(guard):
    tr = _trainer(nan_guard=guard, solver_config=SolverConfig(remat=False))
    ts, dWs, X0 = (torch.from_numpy(a) for a in _batches(1)[0])
    tr.step(ts, dWs, X0)
    before = [p.detach().clone() for p in tr.params.parameters()]
    state = {k: [x.clone() for x in v] if isinstance(v, list) else v.clone()
             for k, v in tr._opt_state.items()}
    bad = dWs.clone()
    bad[0, 0, 0] = float("nan")
    loss, _ = tr.step(ts, bad, X0)
    assert not torch.isfinite(loss)
    after = list(tr.params.parameters())
    if guard:
        for a, b in zip(after, before):
            assert torch.equal(a, b)
        assert torch.equal(tr._opt_state["count"], state["count"])
        for a, b in zip(tr._opt_state["mu"], state["mu"]):
            assert torch.equal(a, b)
        loss, _ = tr.step(ts, dWs, X0)
        assert torch.isfinite(loss) and not torch.equal(after[0], before[0])
    else:
        assert not all(bool(torch.isfinite(p).all()) for p in after)


def test_antithetic_needs_even_m():
    with pytest.raises(ValueError, match="even M"):
        _trainer(M=7, antithetic=True)
    tr = _trainer(antithetic=True)
    _, dWs, _ = tr._batch()
    torch.testing.assert_close(dWs[:, M // 2:], -dWs[:, : M // 2])


def test_correlated_increments_use_the_cholesky_factor():
    tr = _trainer(correlation_type="random_correlation", correlation_seed=5)
    assert tr.chol.shape == (D, D) and torch.allclose(tr.chol, torch.tril(tr.chol))
    torch.testing.assert_close(tr.chol @ tr.chol.T, torch.from_numpy(tr.correlation).float(),
                               rtol=1e-5, atol=1e-6)


def test_auto_remat_rule():
    assert _trainer().config.remat is False
    big = Trainer(BlackScholesBarenblatt(D=100), M=2048, N=50, device="cpu")
    assert big.config.remat is True  # 50 x 2048 x 256 x 12 x 4 B = 1.26 GB > 1 GB


def test_device_none_and_later_features_raise(monkeypatch):
    # meshes are ported (tests/test_torch_parallel.py); one whose "dp" size
    # does not divide M is rejected before any collective, as in JAX
    with pytest.raises(ValueError, match="divisible"):
        _trainer(mesh=_DpMesh(M + 1))
    # sampled X0, the local objectives, path weights and Z-matching are
    # ported (test_torch_stopping_trainer.py)
    for kw in ({"x0_sampler": lambda g, m: None, "objective": "local"}, {"objective": "local"},
               {"path_weight_fn": lambda x: x},
               {"z_match_weight": 1.0, "objective": "local"}):
        _trainer(**kw)
    # LBFGS training and polish are ported too (test_torch_lbfgs.py)
    tr = _trainer()
    assert np.isfinite(tr.train(1, 1e-3, "LBFGS", log_every=1, verbose=False).graph).all()
    assert tr.polish(n_iter=1, M=tr.M).shape == (1,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(BlackScholesBarenblatt(D=D), M=M, N=N, layers=LAYERS)


class _DpMesh:
    """The face of a 1-D "dp" mesh of ``n`` ranks that the batch split reads."""

    mesh_dim_names = ("dp",)

    def __init__(self, n):
        self.n = n

    def size(self, dim):
        return self.n
