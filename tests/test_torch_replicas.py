"""The port's replica training (``train/replicas.py``) against the JAX package
and against the port's own solo ``Trainer``, on the CPU at a small size.

- One replica iteration against JAX: K = 2 sets of weights from a vmapped
  flax init come across with ``params.from_flax_replicas``; both sides take
  the same numpy increments and X0. The JAX side is the reference's
  ``member_iter`` written out (``make_loss_fn`` + ``optax.chain(clip,
  scale_by_*)`` + ``−lr·u`` + the EMA). Three iterations for each
  preconditioner under each objective: losses, parameters and EMA within
  1e-5 of max|reference|, Y0s within 1e-5 of max(|Y0|, 0.01) (an initial
  net's Y0 can sit near 0, where a relative error says nothing).
- Replica k's loss and gradients equal the solo ``make_loss_fn`` on replica
  k's weights for all five nets (SDENet on the same noise): 2e-6 of
  max|·| (measured ≤ 3e-7).
- Replica k against the port's solo ``Trainer(seed=k)`` over 30 iterations in
  two phases with features composed: Y0 logs and final weights within 1e-5
  of max|·| (measured ≤ 1e-6; the JAX test allows rtol 2e-3).
- K = 2 against K = 1: replica 0's trajectory, optimizer state, EMA and
  generator are bitwise the same, so clipping, Adam and the EMA do not
  couple the replicas.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.pde import CallOption1D as JaxCall1D
from dnnpde_tpu.solver.bsde import SolverConfig as JaxConfig
from dnnpde_tpu.solver.bsde import make_loss_fn as jax_make_loss_fn
from dnnpde_tpu.sim.brownian import time_grid as jax_time_grid
from dnnpde_tpu.train.replicas import ReplicaResult as JaxReplicaResult
from dnnpde_tpu.train.replicas import replica_values_at as jax_replica_values_at
from dnnpde_tpu_torch.params import from_flax_params, from_flax_replicas
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt, CallOption1D
from dnnpde_tpu_torch.sim import gaussian_x0, lognormal_x0
from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn
from dnnpde_tpu_torch.train import (
    ReplicaProgram,
    ReplicaResult,
    Trainer,
    replica_net,
    replica_values_at,
    train_replicas,
)

M, N = 16, 4
LAYERS = [2, 16, 16, 1]
Y0_SCALE = 0.01  # the call's value is ~0.1; an initial net's Y0 may sit near 0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """vmap's small batched kernels slow down many times under thread
    oversubscription (several test workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(actual, reference, tol, floor=1e-30):
    """|actual − reference| ≤ tol · max(max|reference|, floor)."""
    actual, reference = np.asarray(actual, np.float64), np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    err = np.abs(actual - reference).max() / max(np.abs(reference).max(), floor)
    assert err <= tol, err


def _jax_stack(K, layers, seed=0):
    net = jax_build_network("FC", layers, "Sine")
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    dummy = jnp.zeros((1, layers[0]), jnp.float32)
    return net, jax.vmap(lambda k: net.init({"params": k}, dummy))(keys)


_TX = {"adam": optax.scale_by_adam, "rmsprop": optax.scale_by_rms,
       "sgd": optax.identity, "adamax": optax.scale_by_adamax}


@pytest.mark.parametrize("objective", ["global", "local", "local_ema"])
@pytest.mark.parametrize("opt", ["Adam", "RMSprop", "SGD", "Adamax"])
def test_replica_iterations_match_jax_member_iter(opt, objective):
    K, lr, decay = 2, 3e-3, 0.9
    local_ema = objective == "local_ema"
    jprob, prob = JaxCall1D(D=1), CallOption1D(D=1)
    jnet, jparams = _jax_stack(K, LAYERS)
    cfg = JaxConfig(remat=False, objective="local" if local_ema else objective)
    loss_fn = jax_make_loss_fn(jprob, jnet, cfg)
    tx = optax.chain(optax.clip_by_global_norm(1.0), _TX[opt.lower()]())
    ts = jnp.swapaxes(jax_time_grid(M, N, jprob.T), 0, 1)

    @jax.jit
    def member_iter(params, opt_state, ema, dWs, X0):
        target = ema if local_ema else None
        (loss, y0), grads = jax.value_and_grad(
            lambda p: (lambda r: (r.loss, r.Y0))(loss_fn(p, ts, dWs, X0, None,
                                                         target_params=target)),
            has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, updates))
        ema = jax.tree.map(lambda e, p: e + (1.0 - decay) * (p - e), ema, params)
        return params, opt_state, ema, loss, y0

    prog = ReplicaProgram(prob, (0, 1), M=M, N=N, layers=LAYERS, optimizer_type=opt,
                          ema_decay=decay, objective=objective, device="cpu")
    with torch.no_grad():
        for name, value in from_flax_replicas(jax.tree.map(np.asarray, jparams), "sine",
                                              device="cpu").items():
            prog.params[name].copy_(value)
            prog.ema[name].copy_(value)
    prog.new_phase(lr)
    members = [jax.tree.map(lambda a, k=k: a[k], jparams) for k in range(K)]
    states = [tx.init(p) for p in members]
    emas = list(members)
    rng = np.random.default_rng(7)
    for it in range(3):
        dW = (np.sqrt(1.0 / N) * rng.standard_normal((K, N, M, 1))).astype(np.float32)
        X0 = np.exp(0.3 * rng.standard_normal((K, M, 1)) - 0.045).astype(np.float32)
        loss, y0 = prog.step(torch.from_numpy(dW), torch.from_numpy(X0))
        for k in range(K):
            members[k], states[k], emas[k], jl, jy = member_iter(
                members[k], states[k], emas[k], jnp.asarray(dW[k]), jnp.asarray(X0[k]))
            _rel(loss[k], jl, 1e-5)
            _rel(y0[k], jy, 1e-5, floor=Y0_SCALE)
    for tree, ours in ((members, prog.params), (emas, prog.ema)):
        ref = from_flax_replicas(jax.tree.map(lambda *a: np.stack(a), *[
            jax.tree.map(np.asarray, t) for t in tree]), "sine", device="cpu")
        for name, value in ours.items():
            _rel(value, ref[name], 1e-5)


@pytest.mark.parametrize("mode", ["FC", "Resnet", "Naisnet", "Verlet", "SDEnet"])
def test_replica_loss_and_grads_equal_the_solo_loss(mode):
    prob = BlackScholesBarenblatt(D=3)
    layers = [4, 16, 16, 16, 1]
    prog = ReplicaProgram(prob, (0, 3), M=8, N=3, layers=layers, mode=mode, device="cpu")
    dWs, X0, noise = prog.draw()
    assert X0 is None and len(noise) == (4 * 2 if mode == "SDEnet" else 0)
    grads, loss, y0 = torch.func.vmap(prog._value_and_grad_one, in_dims=(0, 0, 0, None, 0))(
        prog.params, {}, dWs, prog.X0, noise)
    solo_cfg = SolverConfig(remat=False, stochastic_net=mode == "SDEnet")
    for k in range(2):
        net = replica_net(prog.params, k, layers, mode)
        draws = iter([n[k] for n in noise])
        res = make_loss_fn(prob, net, solo_cfg)(net, prog.ts, dWs[k], prog.X0, paths=False,
                                                  noise=lambda shape: next(draws))
        solo = torch.autograd.grad(res.loss, list(net.parameters()))
        _rel(loss[k], res.loss.detach(), 2e-6)
        _rel(y0[k], res.Y0.detach(), 2e-6)
        for (name, _), g in zip(net.named_parameters(), solo):
            _rel(grads[name][k], g, 2e-6)


FEATURES = {
    "plain": dict(),
    "composed": dict(ema_decay=0.9, antithetic=True, objective="local"),
    "local_ema": dict(ema_decay=0.95, objective="local_ema"),
}


@pytest.mark.parametrize("name", list(FEATURES))
def test_replica_k_tracks_the_solo_trainer(name):
    prob = CallOption1D(D=1)
    kw = dict(FEATURES[name])
    if name == "composed":
        kw["x0_sampler"] = lognormal_x0(prob.x0, 0.3)
    phases = [(20, 1e-3), (10, 1e-4)]
    res = train_replicas(prob, seeds=(0, 3), phases=phases, M=M, N=N, layers=LAYERS,
                         log_every=10, device="cpu", **kw)
    assert res.losses.shape == res.y0s.shape == (2, 3)
    assert res.compile_time > 0 and res.wall_time > 0
    for i, seed in enumerate((0, 3)):
        tr = Trainer(prob, M=M, N=N, layers=LAYERS, seed=seed, device="cpu", **kw)
        for n, lr in phases:
            tr.train(n, lr, log_every=10, verbose=False)
        _rel(res.y0s[i], tr.y0_log, 1e-5)
        for pname, p in tr.params.named_parameters():
            _rel(res.params[pname][i], p.detach(), 1e-5)
        if "ema_decay" in kw:
            for pname, p in tr.ema_params.named_parameters():
                _rel(res.ema_params[pname][i], p.detach(), 1e-5)
    assert abs(res.y0s[0, -1] - res.y0s[1, -1]) > 1e-6  # the seeds differ


@pytest.mark.parametrize("opt", ["Adam", "Adamax"])
def test_a_second_replica_leaves_the_first_bitwise_unchanged(opt):
    prob = CallOption1D(D=1)
    kw = dict(M=M, N=N, layers=LAYERS, optimizer_type=opt, ema_decay=0.9, antithetic=True,
              x0_sampler=lognormal_x0(prob.x0, 0.3), objective="local_ema", capacity=6,
              device="cpu")
    one = ReplicaProgram(prob, (0,), **kw)
    two = ReplicaProgram(prob, (0, 5), **kw)
    for prog in (one, two):
        prog.new_phase(3e-3)
        prog.run(6)
    assert torch.equal(one.losses[:, 0], two.losses[:, 0])
    assert torch.equal(one.y0s[:, 0], two.y0s[:, 0])
    for n in one.params:
        assert torch.equal(one.params[n][0], two.params[n][0])
        assert torch.equal(one.ema[n][0], two.ema[n][0])
    for key, value in one.opt_state.items():
        for a, b in zip(value if isinstance(value, list) else [value],
                        two.opt_state[key] if isinstance(value, list) else [two.opt_state[key]]):
            assert torch.equal(a[0], b[0]), key
    assert torch.equal(one.generators[0].get_state(), two.generators[0].get_state())


def test_replica_values_at_matches_jax_and_reads_the_ema():
    jprob, prob = JaxCall1D(D=1), CallOption1D(D=1)
    _, jparams = _jax_stack(3, LAYERS, seed=4)
    _, jema = _jax_stack(3, LAYERS, seed=5)
    jres = JaxReplicaResult(params=jparams, ema_params=jema, losses=None, y0s=None,
                            seeds=(0, 1, 2), wall_time=0.0, compile_time=0.0)
    res = ReplicaResult(
        params=from_flax_replicas(jax.tree.map(np.asarray, jparams), device="cpu"),
        ema_params=from_flax_replicas(jax.tree.map(np.asarray, jema), device="cpu"),
        losses=None, y0s=None, seeds=(0, 1, 2), wall_time=0.0, compile_time=0.0)
    X = np.array([[0.8], [1.0], [1.3]], np.float32)
    for use_ema in (True, False):
        ours = replica_values_at(prob, res, 0.25, X, layers=LAYERS, use_ema=use_ema)
        ref = jax_replica_values_at(jprob, jres, 0.25, X, layers=LAYERS, use_ema=use_ema)
        assert ours.shape == (3, 3)
        _rel(ours, ref, 1e-6)
    assert replica_values_at(prob, res, layers=LAYERS).shape == (3, 1)


def test_from_flax_replicas_slices_like_from_flax_params():
    _, jparams = _jax_stack(3, [3, 8, 8, 1], seed=2)
    tree = jax.tree.map(np.asarray, jparams)
    stacked = from_flax_replicas(tree, device="cpu")
    for k in range(3):
        net = from_flax_params(jax.tree.map(lambda a, k=k: a[k], tree), device="cpu")
        for name, p in net.named_parameters():
            assert torch.equal(stacked[name][k], p.detach())
        assert torch.equal(replica_net(stacked, k, [3, 8, 8, 1]).dense[0].linear.weight,
                           net.dense[0].linear.weight)


def test_replica_errors_are_the_references():
    prob = CallOption1D(D=1)
    kw = dict(phases=[(2, 1e-3)], M=8, N=2, layers=[2, 8, 8, 1], device="cpu")
    with pytest.raises(ValueError, match="ema_decay"):
        train_replicas(prob, seeds=(0,), objective="local_ema", **kw)
    with pytest.raises(ValueError, match="objective"):
        train_replicas(prob, seeds=(0,), objective="localish", **kw)
    with pytest.raises(ValueError, match="even M"):
        train_replicas(prob, seeds=(0,), antithetic=True, **{**kw, "M": 7})
    with pytest.raises(ValueError, match="replicas support"):
        train_replicas(prob, seeds=(0,), optimizer_type="LBFGS", **kw)
    with pytest.raises(ValueError, match="remat"):
        train_replicas(prob, seeds=(0,), config=SolverConfig(remat=True), **kw)
    prog = ReplicaProgram(prob, (0,), M=8, N=2, layers=[2, 8, 8, 1], device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        prog.run(2)


def test_each_phase_restarts_the_optimizer_and_keeps_the_ema():
    prob = CallOption1D(D=1)
    prog = ReplicaProgram(prob, (0, 1), M=8, N=2, layers=[2, 8, 8, 1], ema_decay=0.9,
                          capacity=3, device="cpu")
    prog.new_phase(1e-3)
    prog.run(3)
    assert prog.opt_state["count"].tolist() == [3, 3]
    ema = {n: e.clone() for n, e in prog.ema.items()}
    prog.new_phase([1e-4, 2e-4])
    assert prog.opt_state["count"].tolist() == [0, 0]
    assert all(float(m.abs().max()) == 0.0 for m in prog.opt_state["mu"])
    assert prog.lr.tolist() == pytest.approx([1e-4, 2e-4])
    assert all(torch.equal(ema[n], prog.ema[n]) for n in ema)


SAMPLERS = {
    "none": lambda prob: None,
    "lognormal": lambda prob: lognormal_x0(prob.x0, 0.3),
    "gaussian": lambda prob: gaussian_x0(prob.x0, 0.1),
}


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_the_trainer_polish_and_the_replicas_draw_the_same_x0(sampler, antithetic, monkeypatch):
    """The Trainer's batch, ``polish``'s frozen batch and the replica
    program's draw take the same X0 from the same generator state and leave
    the generator in the same state: the order of draws that ties replica k
    to ``Trainer(seed=k)``."""
    prob, seed = CallOption1D(D=1), 3
    kw = dict(M=M, N=N, layers=LAYERS, antithetic=antithetic, objective="local",
              x0_sampler=SAMPLERS[sampler](prob), device="cpu")
    tr = Trainer(prob, seed=seed, **kw)
    _, _, x0 = tr._batch()
    polished, frozen = Trainer(prob, seed=seed, **kw), []
    monkeypatch.setattr(polished, "_polish_on", lambda ts, dWs, X0, *a, **k: frozen.append(X0))
    polished.polish(n_iter=1, antithetic=antithetic)
    prog = ReplicaProgram(prob, (seed,), **kw)
    _, x0_replica, _ = prog.draw()
    for other in (frozen[0], prog.X0 if x0_replica is None else x0_replica[0]):
        assert torch.equal(other, x0)
    if sampler != "none":
        assert not torch.equal(x0[0], prob.x0)
        assert torch.equal(x0[: M // 2], x0[M // 2:]) == antithetic
    for g in (polished.generator, prog.generators[0]):
        assert torch.equal(g.get_state(), tr.generator.get_state())


def test_jax_stack_weights_are_distinct_per_replica():
    """The stacked layout keeps each replica's weights apart (a stacking that
    broadcast one replica would pass the per-replica comparisons above only
    by accident)."""
    _, jparams = _jax_stack(2, LAYERS)
    stacked = from_flax_replicas(jax.tree.map(np.asarray, jparams), device="cpu")
    assert all(v.shape[0] == 2 and not torch.equal(v[0], v[1])
               for n, v in stacked.items() if n.endswith("weight"))
