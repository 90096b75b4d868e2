"""The port's deep-BSDE loss (``solver/bsde.py``) against the JAX package's
on identical (params, ts, dWs, X0): loss, X, Y, Y0 and every parameter
gradient, for BSB with D = 4, M = 8, N = 4."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu.solver import SolverConfig as JaxConfig
from dnnpde_tpu.solver import make_loss_fn as jax_make_loss_fn
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn, make_path_loss_fn

D, M, N = 4, 8, 4


def _case(layers, seed=0):
    net = jax_build_network("FC", layers, "Sine")
    params = net.init(jax.random.PRNGKey(seed), jnp.ones((1, layers[0])))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    ts = np.broadcast_to(np.linspace(0, 1, N + 1, dtype=np.float32)[:, None, None],
                         (N + 1, M, 1)).copy()
    dWs = (np.sqrt(1.0 / N) * rng.normal(size=(N, M, D))).astype(np.float32)
    X0 = np.tile(np.asarray(JaxBSB(D=D).x0), (M, 1)).astype(np.float32)
    X0 *= np.exp(0.1 * rng.normal(size=(M, D))).astype(np.float32)
    return net, params, ts, dWs, X0


def _jax(net, params, batch, config):
    loss_fn = jax_make_loss_fn(JaxBSB(D=D), net, config)
    (_, res), g = jax.value_and_grad(lambda p: (lambda r: (r.loss, r))(loss_fn(p, *batch)),
                                     has_aux=True)(params)
    inner = g["params"]
    names = sorted(inner, key=lambda n: int(n.rsplit("_", 1)[1]))
    grads = []
    for n in names:  # port parameter order: weight (out, in), bias, per layer
        grads += [np.asarray(inner[n]["Dense_0"]["kernel"]).T, np.asarray(inner[n]["Dense_0"]["bias"])]
    return res, grads


def _port(params, batch, config):
    net = from_flax_params(params, "sine", device="cpu")
    res = make_loss_fn(BlackScholesBarenblatt(D=D), net, config)(
        net, *(torch.from_numpy(a) for a in batch))
    grads = torch.autograd.grad(res.loss, list(net.parameters()))
    return res, [g.numpy() for g in grads]


def _assert_matches(res_p, g_p, res_j, g_j, rtol, atol_rel):
    for a, r in [(res_p.loss, res_j.loss), (res_p.X, res_j.X), (res_p.Y, res_j.Y),
                 (res_p.Y0, res_j.Y0), *zip(g_p, g_j)]:
        a, r = (np.asarray(v.detach() if isinstance(v, torch.Tensor) else v) for v in (a, r))
        assert a.shape == r.shape
        np.testing.assert_allclose(a, r, rtol=rtol, atol=atol_rel * (np.abs(r).max() + 1e-30))


@pytest.mark.parametrize("fused", [False, True])
def test_loss_and_grads_match_jax_f32(fused):
    layers = [D + 1, 16, 16, 16, 1]
    net, params, *batch = _case(layers)
    port_fused = "torch" if fused else False
    res_j, g_j = _jax(net, params, batch, JaxConfig(remat=False, fused_net_u=fused))
    res_p, g_p = _port(params, batch, SolverConfig(remat=False, fused_net_u=port_fused))
    # f32 in both frameworks, other summation orders through the N steps
    _assert_matches(res_p, g_p, res_j, g_j, rtol=1e-4, atol_rel=1e-5)


def test_cuda_backend_matches_jax_pallas_interpret_at_bf16_tolerance():
    layers = [D + 1, 128, 128, 1]  # the Pallas kernels need 128-multiple hidden widths
    net, params, *batch = _case(layers, seed=1)
    res_j, g_j = _jax(net, params, batch, JaxConfig(remat=False, fused_net_u="pallas_interpret"))
    res_p, g_p = _port(params, batch, SolverConfig(remat=False, fused_net_u="cuda"))
    # bf16 dot operands on both sides; a bf16 tie that flips in one
    # summation order moves what follows by about one bf16 step of one term
    _assert_matches(res_p, g_p, res_j, g_j, rtol=0, atol_rel=1e-2)


@pytest.mark.parametrize("fused", [False, "torch"])
def test_remat_matches_no_remat(fused):
    layers = [D + 1, 16, 16, 1]
    _, params, *batch = _case(layers, seed=2)
    res_a, g_a = _port(params, batch, SolverConfig(remat=True, fused_net_u=fused))
    res_b, g_b = _port(params, batch, SolverConfig(remat=False, fused_net_u=fused))
    _assert_matches(res_a, g_a, res_b, g_b, rtol=1e-6, atol_rel=1e-7)


def test_path_loss_shapes_and_value():
    layers = [D + 1, 16, 16, 1]
    _, params, ts, dWs, X0 = _case(layers, seed=3)
    net = from_flax_params(params, "sine", device="cpu")
    prob = BlackScholesBarenblatt(D=D)
    t = torch.from_numpy(ts).transpose(0, 1)
    W = torch.cat([torch.zeros(M, 1, D), torch.from_numpy(dWs).transpose(0, 1).cumsum(1)], 1)
    res = make_path_loss_fn(prob, net, SolverConfig(remat=False))(net, t, W, prob.x0[None])
    assert res.X.shape == (M, N + 1, D) and res.Y.shape == (M, N + 1, 1)
    assert res.loss.shape == () and res.Y0.shape == ()
    ref = make_loss_fn(prob, net, SolverConfig(remat=False))(
        net, torch.from_numpy(ts), torch.from_numpy(dWs), prob.x0.expand(M, D))
    torch.testing.assert_close(res.loss, ref.loss, rtol=1e-5, atol=0)


def test_later_options_raise():
    prob, net = BlackScholesBarenblatt(D=D), from_flax_params(_case([D + 1, 8, 1])[1], "sine",
                                                               device="cpu")
    # remat_policy and unroll are ported (test_torch_remat_policy.py): they change no number
    _, _, ts, dWs, X0 = _case([D + 1, 8, 1])
    batch = [torch.from_numpy(a) for a in (ts, dWs, X0)]
    ref = make_loss_fn(prob, net, SolverConfig())(net, *batch).loss
    for cfg in (SolverConfig(remat_policy="dots_saveable"), SolverConfig(unroll=4)):
        assert torch.equal(make_loss_fn(prob, net, cfg)(net, *batch).loss, ref)
    # stochastic nets are ported (test_torch_sdenet.py), but not on the fused path
    make_loss_fn(prob, net, SolverConfig(stochastic_net=True))
    with pytest.raises(ValueError, match="plain MLPs"):
        make_loss_fn(prob, net, SolverConfig(stochastic_net=True, fused_net_u=True))
    # the loss options of the local objective are ported (test_torch_stopping_loss.py)
    for cfg in (SolverConfig(objective="local"), SolverConfig(objective="local",
                                                              z_match_weight=1.0),
                SolverConfig(path_weight_fn=lambda x: x)):
        make_loss_fn(prob, net, cfg)
    with pytest.raises(ValueError, match="z_match_weight requires"):
        make_loss_fn(prob, net, SolverConfig(z_match_weight=1.0))
    with pytest.raises(ValueError, match="objective"):
        make_loss_fn(prob, net, SolverConfig(objective="other"))
    with pytest.raises(ValueError, match="backend"):
        make_loss_fn(prob, net, SolverConfig(fused_net_u="pallas"))
