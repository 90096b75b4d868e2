"""The port's serving path against the JAX package's: the same weights go
through ``save_solution``/``load_solution`` here and ``export_solution`` /
``ServedSolution`` there, and both serve (u, Z = ∇ₓu) at the same (t, X).

Both serve in f32 for every activation (the port through the fused
``mlp_u_z``, JAX through its exported program), so sine and tanh are
compared at f32 tolerance, and FC-Sine also at the flagship's full width.
The last test runs the slice end to end on the flagship BSB problem, cut to
a small width."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.ops.rollout_kernel import rollout_paths_xla
from dnnpde_tpu.serve import export_solution
from dnnpde_tpu.serve.export import ServedSolution as JaxServed
from dnnpde_tpu_torch.ops.rollout_kernel import predict_paths_fast
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.serve import ServedSolution, load_solution, save_solution

D = 4
LAYERS = [D + 1, 32, 32, 1]


def _jax_net(act, seed=0, layers=LAYERS):
    net = jax_build_network("FC", layers, act)
    params = net.init(jax.random.PRNGKey(seed), jnp.ones((1, layers[0])))
    return net, params


def _served_pair(act, tmp_path, layers=LAYERS):
    net, params = _jax_net(act, layers=layers)
    jax_sol = JaxServed(jax.export.deserialize(export_solution(net, params, layers[0] - 1)))
    port = from_flax_params(jax.tree.map(np.asarray, params), act, device="cpu")
    path = tmp_path / "solution.pt"
    save_solution(str(path), port, layers[0] - 1)
    return jax_sol, load_solution(str(path), device="cpu")


def _request(batch, seed=0, dim=D):
    rng = np.random.default_rng(seed)
    t = rng.uniform(size=(batch, 1)).astype(np.float32)
    X = (1.0 + 0.3 * rng.normal(size=(batch, dim))).astype(np.float32)
    return t, X


def test_save_load_roundtrip(tmp_path):
    net, params = _jax_net("Sine")
    port = from_flax_params(jax.tree.map(np.asarray, params), "Sine", device="cpu")
    path = tmp_path / "s.pt"
    save_solution(str(path), port, D)
    sol = load_solution(str(path), device="cpu")
    assert isinstance(sol, ServedSolution)
    assert sol.dim == D and sol.layers == tuple(LAYERS) and sol.activation == "sine"
    assert sol.device == torch.device("cpu")
    for k, (W, b) in enumerate(zip(sol.Ws, sol.bs)):
        inner = params["params"][f"Dense_{k}"]["Dense_0"]
        np.testing.assert_array_equal(W.numpy(), np.asarray(inner["kernel"]))
        np.testing.assert_array_equal(b.numpy(), np.asarray(inner["bias"]))


@pytest.mark.parametrize("batch", [1, 3, 17])
def test_sine_u_and_grad_matches_jax_served(tmp_path, batch):
    jax_sol, sol = _served_pair("Sine", tmp_path)
    t, X = _request(batch, seed=batch)
    u_ref, Z_ref = jax_sol.u_and_grad(t, X)
    u, Z = sol.u_and_grad(t, X)
    assert u.shape == (batch, 1) and Z.shape == (batch, D)
    assert isinstance(u, np.ndarray) and u.dtype == np.float32
    np.testing.assert_allclose(u, u_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Z, Z_ref, rtol=1e-5, atol=1e-6)


def test_tanh_u_and_grad_matches_jax_served_in_f32(tmp_path):
    jax_sol, sol = _served_pair("Tanh", tmp_path)
    t, X = _request(9)
    u_ref, Z_ref = jax_sol.u_and_grad(t, X)
    u, Z = sol.u_and_grad(t, X)
    np.testing.assert_allclose(u, u_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Z, Z_ref, rtol=1e-5, atol=1e-6)


def test_full_width_sine_matches_jax_served(tmp_path):
    """FC-Sine [101, 256 x 4, 1] with JAX's initial weights (seed 0) at 4096
    states X = exp(0.2 xi): f32 against f32, within 1e-5 of max|.| (the bf16
    K1 this path served before was 7e-3 off)."""
    dim = 100
    jax_sol, sol = _served_pair("Sine", tmp_path, layers=[dim + 1, 256, 256, 256, 256, 1])
    rng = np.random.default_rng(0)
    t = rng.uniform(size=(4096, 1)).astype(np.float32)
    X = np.exp(0.2 * rng.normal(size=(4096, dim))).astype(np.float32)
    u_ref, Z_ref = jax_sol.u_and_grad(t, X)
    u, Z = sol.u_and_grad(t, X)
    assert u.shape == (4096, 1) and Z.shape == (4096, dim)
    for a, r in ((u, u_ref), (Z, Z_ref)):
        assert np.abs(a - r).max() <= 1e-5 * np.abs(r).max()


def test_scalar_time_surface_and_device_path(tmp_path):
    _, sol = _served_pair("Sine", tmp_path)
    u, Z = sol.u_and_grad(0.5, np.zeros((7, D)))
    assert u.shape == (7, 1) and Z.shape == (7, D)
    np.testing.assert_allclose(u, np.broadcast_to(u[:1], u.shape), rtol=1e-6)
    xs = np.random.default_rng(0).normal(size=(5, D)).astype(np.float32)
    surf = sol.surface([0.0, 0.5, 1.0], xs)
    assert surf.shape == (3, 5)
    np.testing.assert_allclose(surf[1], sol.u(np.full((5, 1), 0.5), xs)[:, 0], rtol=1e-6, atol=1e-7)
    u_d, Z_d = sol.u_and_grad_device(0.1, xs)
    assert isinstance(u_d, torch.Tensor) and u_d.device == torch.device("cpu")
    u_h, Z_h = sol.u_and_grad(0.1, xs)
    np.testing.assert_array_equal(u_d.numpy(), u_h)
    np.testing.assert_array_equal(Z_d.numpy(), Z_h)


def test_what_is_not_ported_raises(tmp_path):
    from dnnpde_tpu_torch.nets import MLP

    net = MLP(LAYERS, "sine", device="cpu")
    with pytest.raises(NotImplementedError, match="stochastic"):
        save_solution(str(tmp_path / "a.pt"), net, D, stochastic=True)
    with pytest.raises(ValueError, match="do not map"):
        save_solution(str(tmp_path / "a.pt"), net, D + 1)


def test_bsb_slice_end_to_end(tmp_path):
    """The slice as a whole on BSB (D = 4, a narrow FC-Sine net): JAX-made
    weights served by the port against JAX's served solution, and the fast
    rollout's column means against the JAX rollout on numpy normals."""
    dim, N, M = 4, 5, 4096
    layers = [dim + 1, 64, 64, 64, 1]
    jax_sol, sol = _served_pair("Sine", tmp_path, layers=layers)
    prob = BlackScholesBarenblatt(D=dim)
    X = np.tile(prob.x0.numpy(), (6, 1)) * np.linspace(0.8, 1.2, 6, dtype=np.float32)[:, None]
    t = np.linspace(0.0, 1.0, 6, dtype=np.float32)[:, None]
    u_ref, Z_ref = jax_sol.u_and_grad(t, X)
    u, Z = sol.u_and_grad(t, X)
    np.testing.assert_allclose(u, u_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Z, Z_ref, rtol=1e-5, atol=1e-6)

    net, params = _jax_net("Sine", layers=layers)
    port = from_flax_params(jax.tree.map(np.asarray, params), "Sine", device="cpu")
    trainer = SimpleNamespace(problem=prob, params=port, N=N, mode="FC", activation="Sine",
                              chol=None)
    Y = predict_paths_fast(trainer, M=M, seed=3).numpy()
    rng = np.random.default_rng(4)
    dWs = (np.sqrt(1.0 / N) * rng.normal(size=(M, N, dim))).astype(np.float32)
    inner = params["params"]
    Ws = [inner[f"Dense_{k}"]["Dense_0"]["kernel"] for k in range(len(layers) - 1)]
    bs = [inner[f"Dense_{k}"]["Dense_0"]["bias"] for k in range(len(layers) - 1)]
    Y_ref = np.asarray(rollout_paths_xla(Ws, bs, jnp.asarray(prob.x0.numpy()), N=N, dt=1.0 / N,
                                         mu_c=0.0, sig_c=0.4, dWs=jnp.asarray(dWs)))
    assert Y.shape == (M, N + 1) and np.isfinite(Y).all()
    se = np.sqrt(Y.var(axis=0) / M + Y_ref.var(axis=0) / M)
    assert np.all(np.abs(Y.mean(axis=0) - Y_ref.mean(axis=0)) <= 4 * se + 1e-6)


SERVED_CASES = {
    # name: (mode, activation, problem factory in each package)
    "naisnet-hjb": ("Naisnet", "ReLU", "HamiltonJacobiBellman", dict(D=3)),
    "heston-bs": ("FC", "Sine", "HestonPDE", {}),
    "heston-hard-naisnet": ("Naisnet", "Sine", "HestonPDE", dict(clamp_smoothing="hard")),
    "resnet-basket": ("Resnet", "Tanh", "BasketCallOption", dict(D=3)),
    "verlet-heston-anchor": ("Verlet", "Sine", "HestonPDE", dict(clamp_smoothing="anchor")),
}


@pytest.mark.parametrize("case", list(SERVED_CASES))
def test_transforms_and_residual_nets_match_jax_served(tmp_path, case):
    """JAX-made weights behind the problem's output transform: the port's
    artifact (net + problem rebuilt on load) against the JAX artifact
    (``export_solution(transform=problem.transform_u)``), u and Z within
    1e-5 of max|·| (f32 on both sides)."""
    import dnnpde_tpu.pde as jax_pde

    import dnnpde_tpu_torch.pde as pde

    mode, act, cls, kw = SERVED_CASES[case]
    jprob, prob = getattr(jax_pde, cls)(**kw), getattr(pde, cls)(**kw)
    layers = [prob.dim + 1, 16, 16, 16, 1]
    net = jax_build_network(mode, layers, act)
    params = net.init(jax.random.PRNGKey(3), jnp.ones((1, layers[0])))
    transform = jprob.transform_u if jprob.has_output_transform else None
    jax_sol = JaxServed(jax.export.deserialize(
        export_solution(net, params, prob.dim, transform=transform)))
    port = from_flax_params(jax.tree.map(np.asarray, params), act, mode=mode, device="cpu")
    path = tmp_path / "s.pt"
    save_solution(str(path), port, prob.dim,
                  transform=prob.transform_u if prob.has_output_transform else None)
    sol = load_solution(str(path), device="cpu")
    assert sol.mode == mode and (sol.problem == prob) == prob.has_output_transform
    rng = np.random.default_rng(5)
    t = rng.uniform(size=(33, 1)).astype(np.float32)
    t[:3] = 1.0  # the heads' terminal values
    X = np.abs(1.0 + 0.3 * rng.normal(size=(33, prob.dim))).astype(np.float32)
    if cls == "HestonPDE":
        X[:, 1] = rng.uniform(0.01, 0.4, size=33)
    u_ref, Z_ref = jax_sol.u_and_grad(t, X)
    u, Z = sol.u_and_grad(t, X)
    assert u.dtype == np.float32 and u.shape == (33, 1) and Z.shape == (33, prob.dim)
    for a, r in ((u, u_ref), (Z, Z_ref)):
        assert np.abs(a - r).max() <= 1e-5 * np.abs(r).max()


def test_save_solution_from_a_trainer_and_its_ema(tmp_path):
    from dnnpde_tpu_torch.pde import HestonPDE
    from dnnpde_tpu_torch.solver import make_net_u
    from dnnpde_tpu_torch.train import Trainer

    tr = Trainer(HestonPDE(), M=8, N=4, layers=[3, 16, 16, 1], mode="Naisnet", device="cpu",
                 ema_decay=0.5)
    tr.train(6, 1e-2, log_every=3, verbose=False)
    t = np.array([[0.0], [0.5], [1.0]], np.float32)
    X = np.array([[1.0, 0.2], [0.9, 0.1], [1.2, 0.3]], np.float32)
    for use_ema, net in ((False, tr.params), (True, tr.ema_params)):
        path = tmp_path / f"t{use_ema}.pt"
        save_solution(str(path), tr, use_ema=use_ema)
        u, Z = load_solution(str(path), device="cpu").u_and_grad(t, X)
        with torch.no_grad():
            u_ref, Z_ref = make_net_u(net, tr.problem.transform_u)(torch.from_numpy(t),
                                                                   torch.from_numpy(X))
        np.testing.assert_array_equal(u, u_ref.numpy())
        np.testing.assert_array_equal(Z, Z_ref.numpy())
    assert not np.array_equal(*(load_solution(str(tmp_path / f"t{e}.pt"), device="cpu")
                                .u(t, X) for e in (False, True)))
    with pytest.raises(ValueError, match="transform_u"):
        save_solution(str(tmp_path / "b.pt"), tr.params, 2, transform=lambda t, x, u: u)

