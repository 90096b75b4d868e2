"""The port's Trainer state and schedules against the JAX package's Trainer:
time-step refinement, two_phase, checkpoints, track_best, metrics rows,
learning-rate schedules, the remat rule, EMA, collapse restarts, reset,
warm_start_from and TrainingPhases; on the CPU at a small size.

Both trainers start from the same weights (carried across with
``params.py``). Where the trajectories need the same increments, the port
is fed, iteration by iteration, the increments the JAX Trainer draws: they
are computed beforehand from the JAX trainer's key with the JAX package's
``brownian_increments``, following ``Trainer.train``'s key schedule.
Tolerance of a trajectory: f32 on both sides with other summation orders,
so each value is held to 1e-5 of max|reference| per optimizer step taken
before it (``_close``); statistics use the rule of
``test_torch_trainer.py::test_step_matches_jax_value_and_grad_and_optax``.
"""

from __future__ import annotations

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnnpde_tpu.evals import greeks as jgreeks
from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu.sim.brownian import brownian_increments as jax_increments
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu.train import TrainingPhases as JaxPhases
from dnnpde_tpu.train import build_optimizer as jax_build_optimizer
from dnnpde_tpu.train.schedules import TimeStepRefinement as JaxRefinement
from dnnpde_tpu.train.schedules import two_phase as jax_two_phase
from dnnpde_tpu_torch.evals import compute_greeks
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn
from dnnpde_tpu_torch.train import (
    TimeStepRefinement,
    Trainer,
    TrainingPhases,
    build_optimizer,
    two_phase,
)

D, M, N = 3, 8, 4
LAYERS = [D + 1, 16, 16, 1]


@dataclasses.dataclass(frozen=True)
class _ClampedJaxBSB(JaxBSB):
    """BSB with u clamped at 0: an absorbing state once u < 0 everywhere."""

    @property
    def clamp_u(self):
        return 0.0


@dataclasses.dataclass(frozen=True)
class _ClampedBSB(BlackScholesBarenblatt):
    @property
    def clamp_u(self):
        return 0.0


def _pair(jprob=None, prob=None, layers=LAYERS, **kw):
    """A JAX trainer and a port trainer (on the CPU) with the JAX weights."""
    jtr = JaxTrainer(jprob or JaxBSB(D=D), M=kw.pop("M", M), N=kw.pop("N", N), layers=layers,
                     seed=0, **kw)
    tr = Trainer(prob or BlackScholesBarenblatt(D=D), M=jtr.M, N=jtr.N, layers=layers, seed=0,
                 device="cpu", **kw)
    _copy_weights(tr, jtr.params)
    return jtr, tr


def _copy_weights(tr, jparams):
    src = from_flax_params(jax.tree.map(np.asarray, jparams), "sine", device="cpu")
    with torch.no_grad():
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)


def _as_port(jparams):
    return [p.detach().numpy() for p in
            from_flax_params(jax.tree.map(np.asarray, jparams), "sine", device="cpu").parameters()]


def _jax_draws(jtr, n_iter, log_every):
    """The increments (time-major) JAX's ``train(n_iter, log_every=...)``
    will draw from ``jtr``'s current key, in order."""
    key = jtr.key
    if jtr.refinement is not None:
        buckets = list(jtr.refinement.buckets(jtr._next_it, n_iter))
    else:
        buckets = [(jtr._next_it, n_iter, jtr.N)]
    p = jtr.problem
    out = []
    for _, b_len, b_N in buckets:
        done = 0
        while done < b_len:
            k = min(log_every, b_len - done)
            key, sub = jax.random.split(key)
            for kk in jax.random.split(sub, k):
                kw = jax.random.split(kk, 3)[0]
                dW = jax_increments(kw, jtr.M, b_N, p.noise_dim, p.T / b_N, jtr.chol,
                                    jtr.dtype, antithetic=jtr.antithetic)
                out.append(np.swapaxes(np.asarray(dW), 0, 1).copy())
            done += k
    return out


def _feed(tr, draws):
    """Make the port trainer draw ``draws`` in order (its other work unchanged)."""
    it = iter(draws)

    def increments(n):
        dWs = torch.from_numpy(next(it))
        assert dWs.shape[0] == n
        return dWs

    tr._increments = increments


def _train_both(jtr, tr, n_iter, lr, log_every, optimizer="Adam"):
    _feed(tr, _jax_draws(jtr, n_iter, log_every))
    rj = jtr.train(n_iter, lr, optimizer, log_every=log_every, verbose=False)
    rp = tr.train(n_iter, lr, optimizer, log_every=log_every, verbose=False)
    return rj, rp


def _close(actual, reference, steps):
    """|actual - reference| <= 1e-5 x steps x max|reference|."""
    actual, reference = np.asarray(actual, np.float64), np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    scale = np.abs(reference).max() + 1e-30
    assert np.abs(actual - reference).max() <= 1e-5 * max(steps, 1) * scale


def _close_params(tr_params, jparams, steps):
    for a, r in zip(tr_params.parameters(), _as_port(jparams)):
        _close(a.detach().numpy(), r, steps)


def _same_trainer_state(a, b):
    """Bitwise: params, optimizer state, EMA, generator, history."""
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    for k, v in a._opt_state.items():
        for x, y in zip(v if isinstance(v, list) else [v], b._opt_state[k] if isinstance(
                v, list) else [b._opt_state[k]]):
            assert torch.equal(x, y), k
    if a._ema is not None:
        for x, y in zip(a._ema.parameters(), b._ema.parameters()):
            assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.training_loss == b.training_loss and a.y0_log == b.y0_log
    assert a.iteration == b.iteration and a._next_it == b._next_it


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("Mm,n_cap", [(50 ** (1 / 5), None), (2.0, None), (3.7, 40),
                                      (50 ** (1 / 5), 40)])
def test_refinement_formula_and_buckets_match_jax_exactly(Mm, n_cap):
    ours, ref = TimeStepRefinement(Mm=Mm, n_cap=n_cap), JaxRefinement(Mm=Mm, n_cap=n_cap)
    for it in list(range(0, 30000, 250)) + [3999, 4000, 7999, 15999, 16000, 19999, 20000]:
        assert ours.n_at(it) == ref.n_at(it)
    for start, n in ((0, 10), (3900, 300), (3998, 8005), (19990, 30), (0, 25000)):
        assert list(ours.buckets(start, n)) == list(ref.buckets(start, n))
    assert ours.n_at(16000) == ref.n_at(16000) == min(math.ceil(Mm**5), n_cap or 10**9)


def test_two_phase_matches_jax():
    for kw in ({}, {"initial_iters": 30, "initial_lr": 2e-3, "fine_iters": 7,
                    "fine_lr": 3e-6, "optimizer_type": "SGD"}):
        for ours, ref in zip(two_phase(**kw), jax_two_phase(**kw)):
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    p1, p2 = two_phase()
    assert (p1.n_iter, p1.learning_rate, p2.n_iter, p2.learning_rate) == (2000, 1e-3, 500, 1e-5)


def test_trainer_applies_refinement_like_jax():
    layers = [D + 1, 16, 16, 16, 16, 1]
    jtr, tr = _pair(layers=layers, N=32, Mm=2.0)
    for t in (jtr, tr):  # cross the 4000-iteration ramp: N goes from 2 to 4
        t._next_it = 3998
    rj, rp = _train_both(jtr, tr, 4, 1e-3, log_every=2)
    assert tr.iteration == jtr.iteration == [3998, 4000]
    assert sorted(k[0] for k in tr._chunk_cache) == [2, 4]
    for i, (a, r) in enumerate(zip(rp.graph[1], rj.graph[1])):
        _close(a, r, 2 * i)
    _close_params(tr.params, jtr.params, 4)
    with pytest.raises(ValueError, match="N_samples"):
        @dataclasses.dataclass(frozen=True)
        class _Sampled(BlackScholesBarenblatt):
            N_samples: int = 50

        Trainer(_Sampled(D=D), M=M, N=N, layers=LAYERS, device="cpu")


# --------------------------------------------------------- learning rates
def _sched(c):  # a schedule both frameworks evaluate on their own count
    return 1e-2 * 0.8 ** c


@pytest.mark.parametrize("name", ["Adam", "SGD", "RMSprop", "Adagrad"])
def test_optimizer_schedule_matches_optax(name):
    rng = np.random.default_rng(3)
    params = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)]
    tx, ours = jax_build_optimizer(name, _sched), build_optimizer(name, _sched)
    jp, tp = [jnp.asarray(p) for p in params], [torch.from_numpy(p.copy()) for p in params]
    js, ts = tx.init(jp), ours.init(tp)
    for step in range(5):
        g = [(0.7 * rng.normal(size=p.shape)).astype(np.float32) for p in params]
        ju, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ours.update([torch.from_numpy(x) for x in g], ts, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        assert int(ts["count"]) == step + 1
        np.testing.assert_allclose(float(ts["lr"]), _sched(step), rtol=1e-6)
        for a, r in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_schedule_lr_matches_jax():
    jtr, tr = _pair()
    rj, rp = _train_both(jtr, tr, 6, _sched, log_every=3)
    np.testing.assert_allclose(rp.graph[1], rj.graph[1], rtol=1e-5)
    _close_params(tr.params, jtr.params, 6)
    np.testing.assert_allclose(float(tr._opt_state["lr"]), _sched(5), rtol=1e-6)


def test_schedule_then_float_lr_matches_jax():
    jtr, tr = _pair()
    _train_both(jtr, tr, 4, 1e-3, log_every=4)
    float_chunk = next(iter(tr._chunk_cache.values()))
    _train_both(jtr, tr, 4, _sched, log_every=4)  # float -> schedule: fresh state and chunks
    sched_chunk = next(iter(tr._chunk_cache.values()))
    assert sched_chunk is not float_chunk and int(tr._opt_state["count"]) == 4
    _train_both(jtr, tr, 4, 1e-5, log_every=4)  # schedule -> float
    assert next(iter(tr._chunk_cache.values())) is not sched_chunk
    again = next(iter(tr._chunk_cache.values()))
    _train_both(jtr, tr, 4, 1e-4, log_every=4)  # float -> float: the chunk stays
    assert next(iter(tr._chunk_cache.values())) is again
    _train_both(jtr, tr, 4, _sched, log_every=4)  # and back
    assert tr.iteration == jtr.iteration == [0, 4, 8, 12, 16]
    for i, (a, r) in enumerate(zip(tr.training_loss, jtr.training_loss)):
        _close(a, r, 4 * i)
    _close_params(tr.params, jtr.params, 20)


def test_lr_change_reuses_the_chunk_and_optimizer_change_drops_it():
    _, tr = _pair()
    tr.train(4, 1e-3, log_every=4, verbose=False)
    chunk = next(iter(tr._chunk_cache.values()))
    mu = tr._opt_state["mu"][0]
    tr.train(4, 1e-5, log_every=4, verbose=False)
    assert next(iter(tr._chunk_cache.values())) is chunk
    assert tr._opt_state["mu"][0] is mu and int(tr._opt_state["count"]) == 4  # fresh, in place
    np.testing.assert_allclose(float(tr._opt_state["lr"]), 1e-5, rtol=1e-7)
    tr.train(4, 1e-3, "SGD", log_every=4, verbose=False)
    assert next(iter(tr._chunk_cache.values())) is not chunk


# ------------------------------------------------------------- remat, net
def test_auto_remat_rule_is_dtype_aware_like_jax():
    layers = [101, 256, 256, 256, 256, 1]
    for M_, kw in ((2048, {}), (2048, {"net_kwargs": {"compute_dtype": "bfloat16"}}),
                   (100, {})):
        ours = Trainer(BlackScholesBarenblatt(D=100), M=M_, N=50, layers=layers, seed=0,
                       device="cpu", **kw)
        ref = JaxTrainer(JaxBSB(D=100), M=M_, N=50, layers=layers, seed=0, **kw)
        assert ours.config.remat == ref.config.remat
    assert ours.config.remat is False


def test_net_kwargs_gain_like_jax():
    kw = dict(M=4, N=2, layers=[4, 64, 64, 1], seed=0)
    bound = {}
    for gain in (1.0, 0.5):
        ours = Trainer(BlackScholesBarenblatt(D=3), device="cpu", net_kwargs={"gain": gain}, **kw)
        ref = JaxTrainer(JaxBSB(D=3), net_kwargs={"gain": gain}, **kw)
        w = ours.params.dense[0].linear.weight.detach().numpy()
        jw = np.asarray(ref.params["params"]["Dense_0"]["Dense_0"]["kernel"])
        limit = gain * math.sqrt(6.0 / (4 + 64))  # Xavier-uniform bound
        assert np.abs(w).max() <= limit and np.abs(jw).max() <= limit
        bound[gain] = np.abs(w).max()
    assert bound[0.5] <= 0.55 * bound[1.0]


# ----------------------------------------------- checkpoints, track_best
@pytest.mark.parametrize("ema_decay", [None, 0.9], ids=["opt_state", "ema"])
def test_checkpoint_resume_equals_the_uninterrupted_run(tmp_path, ema_decay):
    f = str(tmp_path / "ckpt.pt")
    jtr, tr = _pair(ema_decay=ema_decay)
    _train_both(jtr, tr, 6, 1e-3, log_every=3)
    jtr.save_model(str(tmp_path / "ckpt.msgpack"))
    tr.save_model(f)
    jtr2 = JaxTrainer(JaxBSB(D=D), M=M, N=N, layers=LAYERS, seed=99, ema_decay=ema_decay)
    jtr2.load_model(str(tmp_path / "ckpt.msgpack"))
    cont = _jax_draws(jtr2, 4, 2)
    tr2 = Trainer(BlackScholesBarenblatt(D=D), M=M, N=N, layers=LAYERS, seed=99, device="cpu",
                  ema_decay=ema_decay)
    tr2.train(2, 1e-3, log_every=2, verbose=False)  # a state of its own, then overwritten
    tr2.load_model(f)
    assert tr2._opt_sig == ("Adam", 1e-3) and tr2.iteration == jtr2.iteration == [0, 3]
    for t in (tr, tr2):  # the uninterrupted run, and the resumed one
        _feed(t, cont)
        t.train(4, 1e-3, log_every=2, verbose=False)
    jtr2.train(4, 1e-3, log_every=2, verbose=False)
    _same_trainer_state(tr, tr2)
    for i, (a, r) in enumerate(zip(tr2.training_loss, jtr2.training_loss)):
        _close(a, r, 3 * i)
    _close_params(tr2.params, jtr2.params, 10)
    if ema_decay:
        _close_params(tr2.ema_params, jtr2.ema_params, 10)
    # the generator's state round-trips too: unfed runs resume bitwise
    a = Trainer(BlackScholesBarenblatt(D=D), M=M, N=N, layers=LAYERS, seed=5, device="cpu",
                ema_decay=ema_decay)
    a.train(6, 1e-3, log_every=3, verbose=False)
    a.save_model(f)
    b = Trainer(BlackScholesBarenblatt(D=D), M=M, N=N, layers=LAYERS, seed=6, device="cpu",
                ema_decay=ema_decay)
    b.load_model(f)
    for t in (a, b):
        t.train(4, 1e-3, log_every=2, verbose=False)
    _same_trainer_state(a, b)


def test_track_best_matches_jax():
    jtr, tr = _pair(track_best=True)
    rj, rp = _train_both(jtr, tr, 6, 1e-2, log_every=3)
    X, Y = rp.min_loss_state
    assert X.shape == (M, N + 1, D) and Y.shape == (M, N + 1, 1)
    np.testing.assert_allclose(rp.min_loss, rj.min_loss, rtol=6e-5)
    _close(X, rj.min_loss_state[0], 6)
    _close(Y, rj.min_loss_state[1], 6)
    jtr2, tr2 = _pair()
    rj2, rp2 = _train_both(jtr2, tr2, 6, 1e-2, log_every=3)
    assert rp2.min_loss_state is None and rj2.min_loss_state is None
    np.testing.assert_allclose(rp2.min_loss, rj2.min_loss, rtol=6e-5)


def test_metrics_jsonl_rows_match_jax(tmp_path):
    fj, fp = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jtr, tr = _pair()
    jtr.metrics_file, tr.metrics_file = fj, fp
    _train_both(jtr, tr, 4, 1e-3, log_every=2)
    rows_j = [json.loads(line) for line in open(fj)]
    rows_p = [json.loads(line) for line in open(fp)]
    assert len(rows_p) == len(rows_j) == 2
    for i, (p, j) in enumerate(zip(rows_p, rows_j)):
        assert list(p) == list(j)
        assert {k: p[k] for k in ("it", "lr", "N", "optimizer")} == \
            {k: j[k] for k in ("it", "lr", "N", "optimizer")}
        for k in ("loss", "mean_loss", "y0"):
            _close(p[k], j[k], 2 * i + 2)


# -------------------------------------------------------------------- EMA
def test_ema_tracks_and_averages_like_jax():
    jtr, tr = _pair(ema_decay=0.9)
    rj, rp = _train_both(jtr, tr, 20, 1e-3, log_every=10)
    raw = [p.detach() for p in tr.params.parameters()]
    assert any(not torch.allclose(a, b) for a, b in zip(raw, tr.ema_params.parameters()))
    _close_params(tr.ema_params, jtr.ema_params, 20)
    _close_params(tr.params, jtr.params, 20)
    with pytest.raises(ValueError):
        Trainer(BlackScholesBarenblatt(D=D), M=M, N=N, layers=LAYERS, ema_decay=1.5, device="cpu")
    with pytest.raises(ValueError, match="ema_decay"):
        _ = Trainer(BlackScholesBarenblatt(D=D), M=M, N=N, layers=LAYERS, device="cpu").ema_params


def test_ema_shadow_frozen_on_guarded_skip_like_jax():
    jtr, tr = _pair(nan_guard=True, ema_decay=0.5)
    _train_both(jtr, tr, 4, 1e-3, log_every=2)  # healthy warm-up
    _close_params(tr.ema_params, jtr.ema_params, 4)
    shadow = [e.clone() for e in tr.ema_params.parameters()]
    jshadow = [np.asarray(x) for x in jax.tree.leaves(jtr.ema_params)]
    with torch.no_grad():
        for p in tr.params.parameters():
            p.mul_(float("nan"))
    jtr.params = jax.tree.map(lambda x: x * jnp.nan, jtr.params)
    _train_both(jtr, tr, 4, 1e-3, log_every=2)  # every update is skipped
    for a, b in zip(tr.ema_params.parameters(), shadow):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(jtr.ema_params), jshadow):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_predict_and_greeks_use_ema_like_jax():
    jtr, tr = _pair(ema_decay=0.9)
    _train_both(jtr, tr, 20, 1e-3, log_every=10)
    rng = np.random.default_rng(7)
    t = np.broadcast_to(np.linspace(0, 1, N + 1, dtype=np.float32)[None, :, None], (M, N + 1, 1))
    W = np.concatenate([np.zeros((M, 1, D)), np.cumsum(
        0.5 * rng.normal(size=(M, N, D)), axis=1)], axis=1).astype(np.float32)
    x0 = np.asarray(JaxBSB(D=D).x0)[None]
    X_raw, Y_raw = tr.predict(x0, t, W)
    X_ema, Y_ema = tr.predict(x0, t, W, use_ema=True)
    jX, jY = jtr.predict(x0, t, W, use_ema=True)
    np.testing.assert_allclose(X_raw, X_ema)  # X does not depend on the net here
    assert not np.allclose(Y_raw, Y_ema)
    _close(Y_ema, jY, 20)
    _close(X_ema, jX, 20)
    ts, Xs = rng.uniform(size=(5, 1)).astype(np.float32), rng.uniform(0.5, 1.5, (5, D)).astype(
        np.float32)
    for a, r in zip(compute_greeks(tr, ts, Xs, use_ema=True),
                    jgreeks.compute_greeks(jtr, ts, Xs, use_ema=True)):
        _close(a, r, 20)
    with pytest.raises(ValueError, match="ema_decay"):
        _pair()[1].predict(x0, t, W, use_ema=True)


# ------------------------------------------------------- collapse restarts
def test_collapse_restart_rolls_back_and_rerolls_like_jax():
    kw = dict(layers=[D + 1, 16, 16, 1], collapse_restart=True, collapse_max_restarts=2)
    jtr, tr = _pair(_ClampedJaxBSB(D=D), _ClampedBSB(D=D), **kw)
    # poison the output bias so u <= 0 everywhere: Y0 is pinned at 0 at once
    leaves, treedef = jax.tree_util.tree_flatten(jtr.params)
    leaves[[i for i, x in enumerate(leaves) if x.shape == (1,)][-1]] -= 1e3
    jtr.params = jax.tree_util.tree_unflatten(treedef, leaves)
    with torch.no_grad():
        tr.params.dense[-1].linear.bias.sub_(1e3)
    before = [p.detach().clone() for p in tr.params.parameters()]
    rj = jtr.train(9, 1e-3, log_every=3, verbose=False)
    rp = tr.train(9, 1e-3, log_every=3, verbose=False)
    assert tr.collapse_restarts == jtr.collapse_restarts == [0, 0]
    assert tr.iteration == jtr.iteration == [0, 3, 6]
    assert np.isfinite(rp.graph[1]).all() and np.isfinite(rj.graph[1]).all()
    # the stream was re-seeded twice, each time from its state after the failed
    # chunk's draws and the restart count (JAX folds 7919 + n into its key)
    twin = Trainer(BlackScholesBarenblatt(D=D), M=M, N=N, layers=kw["layers"], seed=0,
                   device="cpu")
    seeds = []
    for n in range(2):
        for _ in range(3):
            twin._increments(N)
        assert twin._reroll_seed(n) != twin._reroll_seed(n + 1)
        seeds.append(twin._reroll_seed(n))
        twin.generator.manual_seed(seeds[-1])
    assert seeds[0] != seeds[1] and tr.generator.initial_seed() == seeds[1]
    # in the absorbing state the gradients are 0: params stay at the snapshot
    for a, b in zip(tr.params.parameters(), before):
        assert torch.equal(a, b)
    for a, r in zip(tr.params.parameters(), _as_port(jtr.params)):
        np.testing.assert_array_equal(a.detach().numpy(), r)


def test_collapse_restart_is_a_noop_on_a_healthy_run_like_jax():
    runs = {}
    for guard in (False, True):
        jtr, tr = _pair(layers=[D + 1, 16, 16, 1], collapse_restart=guard)
        _train_both(jtr, tr, 6, 1e-3, log_every=3)
        assert tr.collapse_restarts == jtr.collapse_restarts == []
        runs[guard] = (jtr, tr)
    _same_trainer_state(runs[False][1], runs[True][1])
    for i, (a, r) in enumerate(zip(runs[True][1].training_loss, runs[True][0].training_loss)):
        _close(a, r, 3 * i)


# ------------------------------------------------- reset, warm start, phases
def test_reset_keeps_chunks_and_reinitializes_like_jax():
    kw = dict(layers=[D + 1, 16, 1], N=3, ema_decay=0.9)
    jtr, tr = _pair(**kw)
    for t in (jtr, tr):
        t.train(4, 1e-3, log_every=2, verbose=False)
    chunks = dict(tr._chunk_cache)
    before = [p.detach().clone() for p in tr.params.parameters()]
    for t in (jtr, tr):
        t.reset(7)
        assert t.training_loss == [] and t._next_it == 0 and t._ema is None
    assert tr._chunk_cache == chunks and len(jtr._chunk_cache) == len(chunks)
    fresh = Trainer(BlackScholesBarenblatt(D=D), M=M, N=3, layers=kw["layers"], seed=7,
                    device="cpu")
    for a, b, c in zip(tr.params.parameters(), fresh.params.parameters(), before):
        assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(tr.generator.get_state(), fresh.generator.get_state())
    assert int(tr._opt_state["count"]) == 0 and float(tr._opt_state["mu"][0].abs().max()) == 0
    for t in (jtr, tr):
        t.train(4, 1e-3, log_every=2, verbose=False)
    assert all(tr._chunk_cache[k] is v for k, v in chunks.items())  # still the same chunks
    assert tr.iteration == jtr.iteration == [0, 2]
    # reset(same seed) reproduces the trajectory exactly, as in JAX
    for t in (jtr, tr):
        t.reset(7)
        l1 = list(t.train(4, 1e-3, log_every=2, verbose=False).graph[1])
        t.reset(7)
        l2 = list(t.train(4, 1e-3, log_every=2, verbose=False).graph[1])
        assert l1 == l2


def test_warm_start_from_like_jax():
    kw = dict(layers=[D + 1, 16, 16, 1], M=16, N=5, ema_decay=0.99)
    jtr1, tr1 = _pair(**kw)
    _train_both(jtr1, tr1, 20, 1e-3, log_every=10)
    jtr2 = JaxTrainer(JaxBSB(D=D, sigma_bar=0.3), seed=123, **kw)
    tr2 = Trainer(BlackScholesBarenblatt(D=D, sigma_bar=0.3), seed=123, device="cpu", **kw)
    jtr2.warm_start_from(jtr1)
    tr2.warm_start_from(tr1)
    for a, b in zip(tr2.params.parameters(), tr1.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(tr2.ema_params.parameters(), tr1.ema_params.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(tr2.generator.get_state(), tr1.generator.get_state())
    _train_both(jtr2, tr2, 10, 1e-4, log_every=10)
    assert tr2.iteration == jtr2.iteration == [0, 10, 20]
    for i, (a, r) in enumerate(zip(tr2.training_loss, jtr2.training_loss)):
        _close(a, r, 10 * i)
    _close_params(tr2.params, jtr2.params, 30)
    _close_params(tr2.ema_params, jtr2.ema_params, 30)
    other = Trainer(BlackScholesBarenblatt(D=D), M=16, N=5, layers=[D + 1, 8, 8, 1], device="cpu")
    with pytest.raises(ValueError, match="identical network"):
        other.warm_start_from(tr1)


def test_training_phases_match_jax():
    jtr, tr = _pair()
    _feed(tr, _jax_draws(jtr, 6, 100))
    JaxPhases(jtr).train_initial_phase(6, 1e-3)
    TrainingPhases(tr).train_initial_phase(6, 1e-3)
    _feed(tr, _jax_draws(jtr, 4, 100))
    JaxPhases(jtr).fine_tuning_phase(4, 1e-5)
    res = TrainingPhases(tr).fine_tuning_phase(4, 1e-5)
    assert tr.iteration == jtr.iteration == [0, 6]
    for i, (a, r) in enumerate(zip(res.graph[1], jtr.training_loss)):
        _close(a, r, 6 * i)
    _close_params(tr.params, jtr.params, 10)


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("remat", [False, True])
def test_loss_without_paths_is_the_same_bit_for_bit(remat):
    _, tr = _pair()
    loss_fn = make_loss_fn(tr.problem, tr.net, SolverConfig(remat=remat))
    ts, dWs, X0 = tr._batch()
    full = loss_fn(tr.net, ts, dWs, X0)
    slim = loss_fn(tr.net, ts, dWs, X0, paths=False)
    assert slim.X is None and slim.Y is None
    assert torch.equal(full.loss, slim.loss) and torch.equal(full.Y0, slim.Y0)
    for a, b in zip(torch.autograd.grad(full.loss, tr._params),
                    torch.autograd.grad(slim.loss, tr._params)):
        assert torch.equal(a, b)
