"""The port's local objective against the JAX solver's, on the CPU: the loss,
Y0 and every parameter gradient on the same increments and initial states,
each within 1e-5 of max|ref| (f32 on both sides in other summation orders,
as ``test_torch_hjb_heston.py`` holds the global loss), with remat on and
off. Cases: the local objective on a plain net, with ``target_params``, the
American put with its head, the Bermudan max-call on sparse exercise dates,
the Heston American put with Z-matching, ``iv_space_weights`` on a
lognormal X0 cloud, and the fused "torch" backend against JAX's "jnp"."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.pde import AmericanPutOption as JaxAmericanPut
from dnnpde_tpu.pde import BermudanMaxCall as JaxMaxCall
from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu.pde import HestonAmericanPut as JaxHestonAmerican
from dnnpde_tpu.solver import SolverConfig as JaxConfig
from dnnpde_tpu.solver import iv_space_weights as jax_iv_space_weights
from dnnpde_tpu.solver import make_loss_fn as jax_make_loss_fn
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import (
    AmericanPutOption,
    BermudanMaxCall,
    BlackScholesBarenblatt,
    HestonAmericanPut,
)
from dnnpde_tpu_torch.solver import SolverConfig, iv_space_weights, make_loss_fn

M = 16


def _close(actual, reference, tol):
    actual = np.asarray(actual, np.float64)
    reference = np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.isfinite(actual).all()
    assert np.abs(actual - reference).max() <= tol * (np.abs(reference).max() + 1e-30)


def _net_pair(dim, seed=2, width=16):
    layers = [dim + 1, width, width, width, 1]
    net = jax_build_network("FC", layers, "Sine")
    params = net.init(jax.random.PRNGKey(seed), jnp.ones((1, layers[0])))
    port = from_flax_params(jax.tree.map(np.asarray, params), "sine", device="cpu")
    return net, params, port


def _batch(prob, N, seed=11, x0_scale=0.0):
    """(ts, dWs, X0) in numpy; X0 = x0 · exp(scale·Z − scale²/2) when
    ``x0_scale`` > 0 (a lognormal cloud)."""
    rng = np.random.default_rng(seed)
    ts = np.broadcast_to(np.linspace(0.0, prob.T, N + 1, dtype=np.float32)[:, None, None],
                         (N + 1, M, 1)).copy()
    dWs = (np.sqrt(prob.T / N) * rng.normal(size=(N, M, prob.noise_dim))).astype(np.float32)
    X0 = np.broadcast_to(np.asarray(prob.x0, np.float32), (M, prob.dim)).copy()
    if x0_scale:
        z = rng.normal(size=X0.shape)
        X0 = (X0 * np.exp(x0_scale * z - 0.5 * x0_scale**2)).astype(np.float32)
    return ts, dWs, X0


CASES = {
    # name: (JAX problem, port problem, N, config kwargs, X0 spread, use target_params)
    "local-plain": (JaxBSB(D=3), BlackScholesBarenblatt(D=3), 6, {}, 0.0, False),
    "local-target-params": (JaxBSB(D=3), BlackScholesBarenblatt(D=3), 6, {}, 0.0, True),
    "american-put-head": (JaxAmericanPut(), AmericanPutOption(), 8, {}, 0.0, False),
    "american-put-plain": (JaxAmericanPut(bs_head=False), AmericanPutOption(bs_head=False), 8,
                           {}, 0.2, False),
    "max-call-sparse-dates": (JaxMaxCall(N_steps=18), BermudanMaxCall(N_steps=18), 18, {},
                              0.0, False),
    "heston-american-z-match": (JaxHestonAmerican(), HestonAmericanPut(), 6,
                                {"z_match_weight": 0.5, "z_match_mask": (0.0, 1.0)}, 0.0,
                                False),
    "heston-american-z-match-target": (JaxHestonAmerican(), HestonAmericanPut(), 6,
                                       {"z_match_weight": 1.0}, 0.0, True),
    "heston-american-iv-weights": (JaxHestonAmerican(), HestonAmericanPut(), 6,
                                   {"path_weight_fn": "iv"}, 0.25, False),
    "fused-max-call-plain": (JaxMaxCall(N_steps=18, head=False),
                             BermudanMaxCall(N_steps=18, head=False), 18,
                             {"fused_net_u": True}, 0.0, False),
}


def _configs(kw):
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("path_weight_fn") == "iv":
        jkw["path_weight_fn"] = jax_iv_space_weights(strike=1.0, T=1.0, r=0.05)
        pkw["path_weight_fn"] = iv_space_weights(strike=1.0, T=1.0, r=0.05)
    return jkw, pkw


@pytest.mark.parametrize("case", list(CASES))
def test_local_loss_and_gradients_match_the_jax_solver(case):
    jprob, prob, N, kw, spread, with_target = CASES[case]
    net, params, port = _net_pair(prob.dim)
    tparams, target = None, None
    if with_target:
        _, tparams, target = _net_pair(prob.dim, seed=9)
    ts, dWs, X0 = _batch(jprob, N, x0_scale=spread)
    jkw, pkw = _configs(kw)

    jloss = jax_make_loss_fn(jprob, net, JaxConfig(remat=False, objective="local", **jkw))
    (ref_loss, ref_y0), ref_grads = jax.value_and_grad(
        lambda p: (lambda r: (r.loss, r.Y0))(jloss(p, ts, dWs, X0, target_params=tparams)),
        has_aux=True)(params)
    ref = from_flax_params(jax.tree.map(np.asarray, ref_grads), "sine", device="cpu")
    for remat in (False, True):
        loss_fn = make_loss_fn(prob, port, SolverConfig(remat=remat, objective="local", **pkw))
        res = loss_fn(port, *(torch.from_numpy(a) for a in (ts, dWs, X0)),
                      target_params=target)
        grads = torch.autograd.grad(res.loss, list(port.parameters()))
        _close(float(res.loss.detach()), float(ref_loss), 1e-5)
        _close(float(res.Y0.detach()), float(ref_y0), 1e-5)
        for g, r in zip(grads, ref.parameters()):
            _close(g.numpy(), r.detach().numpy(), 1e-5)
        if target is not None:
            # the target net gets no gradient (JAX: exactly zero)
            tgrads = torch.autograd.grad(res.loss, list(target.parameters()), allow_unused=True)
            assert all(g is None or not g.any() for g in tgrads)


def test_remat_does_not_change_the_local_loss_or_its_gradients():
    """Checkpointing the step (with the widened Z-matching carry and the
    exercise flags) gives the same loss and gradients as keeping the
    activations, to the last bit of f32 summation order."""
    prob = HestonAmericanPut()
    _, _, port = _net_pair(prob.dim)
    ts, dWs, X0 = (torch.from_numpy(a) for a in _batch(prob, 6, x0_scale=0.2))
    out = []
    for remat in (False, True):
        cfg = SolverConfig(remat=remat, objective="local", z_match_weight=0.5,
                           z_match_mask=(0.0, 1.0), path_weight_fn=iv_space_weights(r=0.05))
        res = make_loss_fn(prob, port, cfg)(port, ts, dWs, X0, paths=False)
        out.append([res.loss.detach(), *torch.autograd.grad(res.loss, list(port.parameters()))])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_paths_of_the_local_rollout_match_jax():
    """X and Y stacked by the local rollout of the American put."""
    jprob, prob = JaxAmericanPut(), AmericanPutOption()
    net, params, port = _net_pair(1)
    ts, dWs, X0 = _batch(jprob, 8)
    ref = jax_make_loss_fn(jprob, net, JaxConfig(remat=False, objective="local"))(
        params, ts, dWs, X0)
    with torch.no_grad():
        res = make_loss_fn(prob, port, SolverConfig(remat=False, objective="local"))(
            port, *(torch.from_numpy(a) for a in (ts, dWs, X0)))
    _close(res.X.numpy(), np.asarray(ref.X), 1e-6)
    _close(res.Y.numpy(), np.asarray(ref.Y), 1e-5)


def test_config_errors_match_jax():
    """Early exercise and Z-matching need the local objective; the grid must
    hold the maturity as a date; target_params needs the local objective."""
    _, _, port = _net_pair(2)
    with pytest.raises(ValueError, match="early_exercise"):
        make_loss_fn(BermudanMaxCall(N_steps=18), port, SolverConfig())
    with pytest.raises(ValueError, match="z_match_weight requires"):
        make_loss_fn(HestonAmericanPut(), port, SolverConfig(z_match_weight=1.0))
    with pytest.raises(ValueError, match="objective"):
        make_loss_fn(HestonAmericanPut(), port, SolverConfig(objective="local_ema"))
    prob = BermudanMaxCall(N_steps=18)  # exercise_every = 2
    ts, dWs, X0 = (torch.from_numpy(a) for a in _batch(prob, 9))
    loss_fn = make_loss_fn(prob, port, SolverConfig(objective="local"))
    with pytest.raises(ValueError, match="multiple of"):
        loss_fn(port, ts, dWs, X0)
    bsb = BlackScholesBarenblatt(D=2)
    ts, dWs, X0 = (torch.from_numpy(a) for a in _batch(bsb, 4))
    with pytest.raises(ValueError, match="target_params requires"):
        make_loss_fn(bsb, port, SolverConfig())(port, ts, dWs, X0, target_params=port)
    with pytest.raises(ValueError, match="fused_net_u"):
        make_loss_fn(BermudanMaxCall(N_steps=18), port,
                     SolverConfig(objective="local", fused_net_u=True))
