"""The port's composition API (``compat.py``), ``paths_to_increments`` and
``as_callable_problem`` against the JAX package's, on the CPU.

``tests/test_compat.py``'s four tests run on the port as they run on JAX;
then, on the same numpy-seeded weights and paths in both packages:
``LossFunction.compute`` (loss within rtol 1e-5, X and Y within 1e-5 of
max|·|), ``heston_predict`` (within 1e-5 of max|·|), ``paths_to_increments``
(equal), and a callable problem's loss (within 1e-5)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.compat import LossFunction as JaxLossFunction
from dnnpde_tpu.compat import heston_predict as jax_heston_predict
from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu.pde import HestonPDE as JaxHeston
from dnnpde_tpu.pde import as_callable_problem as jax_as_callable_problem
from dnnpde_tpu.sim import paths_to_increments as jax_paths_to_increments
from dnnpde_tpu.solver import SolverConfig as JaxConfig
from dnnpde_tpu.solver import make_loss_fn as jax_make_loss_fn
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch.compat import (
    EulerMaruyamaScheme,
    LossFunction,
    NeuralNetworkTraining,
    heston_predict,
)
from dnnpde_tpu_torch.nets import build_network
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt, CallableProblem, HestonPDE
from dnnpde_tpu_torch.pde import as_callable_problem
from dnnpde_tpu_torch.sim import paths_to_increments
from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn
from dnnpde_tpu_torch.train import Trainer

LAYERS = [4, 16, 16, 16, 16, 1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(actual, reference, tol):
    actual, reference = np.asarray(actual, np.float64), np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.abs(actual - reference).max() <= tol * (np.abs(reference).max() + 1e-30)


def _paths(M, N, D, seed=0):
    """(t (M, N+1, 1), W (M, N+1, D)) from numpy normals, W[:, 0] = 0."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.linspace(0, 1, N + 1, dtype=np.float32)[None, :, None],
                        (M, N + 1, 1)).copy()
    dW = (np.sqrt(1.0 / N) * rng.normal(size=(M, N, D))).astype(np.float32)
    W = np.concatenate([np.zeros((M, 1, D), np.float32), np.cumsum(dW, axis=1)], axis=1)
    return t, W


# ---- tests/test_compat.py on the port ---------------------------------------


def test_scheme_simulate_shapes():
    sim = EulerMaruyamaScheme(np.ones((1, 3)), T=1.0, M=8, N=4, D=3, seed=0, device="cpu")
    t, W = sim.simulate()
    assert t.shape == (8, 5, 1) and W.shape == (8, 5, 3)
    t2, W2 = sim.simulate()
    assert not np.allclose(W.numpy(), W2.numpy())  # the stream advances
    again = EulerMaruyamaScheme(np.ones((1, 3)), T=1.0, M=8, N=4, D=3, seed=0, device="cpu")
    assert torch.equal(again.simulate()[1], W)  # the seed fixes the stream


def test_loss_function_compute():
    prob = BlackScholesBarenblatt(D=3)
    net = build_network("FC", LAYERS, "Sine", device="cpu")
    lf = LossFunction(prob, net, net.state_dict())
    sim = EulerMaruyamaScheme(np.ones((1, 3)), 1.0, 8, 4, 3, device="cpu")
    t, W = sim.simulate()
    loss, X, Y, Y0 = lf.compute(t, W, sim.Xi)
    assert np.isfinite(loss)
    assert X.shape == (8, 5, 3) and Y.shape == (8, 5, 1)
    assert Y0 == float(Y[0, 0, 0])


def test_neural_network_training_end_to_end():
    prob = BlackScholesBarenblatt(D=3)
    sim = EulerMaruyamaScheme(prob.x0.numpy()[None, :], 1.0, 8, 4, 3, device="cpu")
    nnt = NeuralNetworkTraining(prob, sim, layers=LAYERS, seed=0)
    graph = nnt.train(6, 1e-3)
    assert graph.shape[0] == 2
    assert np.isfinite(graph[1]).all()
    t, W = sim.simulate()
    X, Y = nnt.predict(sim.Xi, t, W)
    assert X.shape == (8, 5, 3)
    assert nnt.model is nnt.trainer and nnt.trainer.device == torch.device("cpu")


def test_heston_predict_layout():
    tr = Trainer(HestonPDE(), M=6, N=3, layers=[3, 16, 16, 16, 16, 1], seed=0, device="cpu")
    t, W = tr.fetch_minibatch()
    S, v, Y = heston_predict(tr, tr.problem.x0.numpy()[None, :], t, W)
    assert S.shape == (6, 4, 1) and v.shape == (6, 4, 1) and Y.shape == (6, 4, 1)
    assert (S > 0).all()


# ---- against JAX on the same weights and paths ------------------------------


def test_loss_function_compute_matches_jax():
    """JAX's (t, W) and weights through both LossFunctions: loss rtol 1e-5;
    X, Y within 1e-5 of max|·|; Y0 = Y[0, 0, 0]."""
    jnet = jax_build_network("FC", LAYERS, "Sine")
    params = jnet.init(jax.random.PRNGKey(0), jnp.ones((1, 4)))
    t, W = _paths(8, 4, 3, seed=1)
    Xi = np.asarray(JaxBSB(D=3).x0)[None, :]
    ref = JaxLossFunction(JaxBSB(D=3), jnet, params).compute(jnp.asarray(t), jnp.asarray(W), Xi)
    port = from_flax_params(jax.tree.map(np.asarray, params), "Sine", device="cpu")
    loss, X, Y, Y0 = LossFunction(BlackScholesBarenblatt(D=3), port).compute(
        torch.from_numpy(t), torch.from_numpy(W), Xi)
    np.testing.assert_allclose(loss, ref[0], rtol=1e-5)
    _close(X, ref[1], 1e-5)
    _close(Y, ref[2], 1e-5)
    assert Y0 == float(Y[0, 0, 0])
    np.testing.assert_allclose(Y0, ref[3], rtol=1e-5)
    # params as a state dict to load, the JAX signature's third argument
    other = build_network("FC", LAYERS, "Sine", device="cpu")
    assert LossFunction(BlackScholesBarenblatt(D=3), other, port.state_dict()).compute(
        t, W, Xi)[0] == loss


def test_heston_predict_matches_jax():
    """The same Heston weights along the same paths: S, v and Y paths within
    1e-5 of max|·| of JAX's."""
    jtr = JaxTrainer(JaxHeston(), M=6, N=3, layers=[3, 16, 16, 16, 16, 1], seed=0)
    tr = Trainer(HestonPDE(), M=6, N=3, layers=[3, 16, 16, 16, 16, 1], seed=0, device="cpu")
    src = from_flax_params(jax.tree.map(np.asarray, jtr.params), "Sine", device="cpu")
    with torch.no_grad():
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    t, W = _paths(6, 3, 2, seed=2)
    x0 = np.asarray(jtr.problem.x0)[None, :]
    for a, r in zip(heston_predict(tr, x0, t, W), jax_heston_predict(jtr, x0, t, W)):
        _close(a, np.asarray(r), 1e-5)


def test_paths_to_increments_equals_jax():
    t, W = _paths(5, 6, 3, seed=3)
    for a, r in zip(paths_to_increments(torch.from_numpy(t), torch.from_numpy(W)),
                    jax_paths_to_increments(jnp.asarray(t), jnp.asarray(W))):
        assert a.shape == r.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_as_callable_problem_trains():
    """``tests/test_solver.py::test_as_callable_problem_trains`` on the port:
    plain functions on tensors make a problem that trains, hashable with its
    x0 kept as a tuple."""
    prob = as_callable_problem(
        dim=2, T=1.0, x0=[1.0, 1.0],
        mu=lambda t, X, Y, Z: 0.05 * X,
        sigma=lambda t, X, Y: 0.2 * X,
        phi=lambda t, X, Y, Z: 0.05 * Y,
        g=lambda X: torch.sum(X**2, dim=-1, keepdim=True),
        name="custom-test",
    )
    assert isinstance(prob, CallableProblem) and prob.dim == 2 and prob.sigma_kind == "diag"
    assert prob.x0_ == (1.0, 1.0) and hash(prob) == hash(prob)
    assert torch.equal(prob.x0, torch.ones(2)) and prob.exact_solution(None, None) is None
    tr = Trainer(prob, M=8, N=3, layers=[3, 16, 16, 16, 16, 1], seed=0, device="cpu")
    res = tr.train(4, 1e-3, log_every=2, verbose=False)
    assert np.isfinite(res.graph[1]).all()


def _linmart(pkg_tensor, make, s=(1.0, 0.4), a=0.7, b=0.3):
    """``tests/test_solver.py``'s 2-D martingale (mu = phi = 0, constant
    diagonal sigma, g = a x1 + b x2), in one package's tensors."""
    s = pkg_tensor(np.asarray(s, np.float32))
    return make(
        dim=2, T=1.0, x0=(1.0, 1.0),
        mu=lambda t, X, Y, Z: 0 * X,
        sigma=lambda t, X, Y: s + 0 * X,
        phi=lambda t, X, Y, Z: 0 * Y,
        g=lambda X: a * X[..., 0:1] + b * X[..., 1:2],
        name="linmart",
    )


@pytest.mark.parametrize("objective", ["global", "local"])
def test_linmart_loss_matches_jax(objective):
    """The same weights, increments and X0 through both packages' losses on
    their callable linmart problem: loss and Y0 within 1e-5 relative."""
    jprob = _linmart(jnp.asarray, jax_as_callable_problem)
    prob = _linmart(torch.from_numpy, as_callable_problem)
    jnet = jax_build_network("FC", [3, 16, 16, 1], "Sine")
    params = jnet.init(jax.random.PRNGKey(4), jnp.ones((1, 3)))
    rng = np.random.default_rng(5)
    M, N = 16, 4
    ts = np.broadcast_to(np.linspace(0, 1, N + 1, dtype=np.float32)[:, None, None],
                         (N + 1, M, 1)).copy()
    dWs = (np.sqrt(1.0 / N) * rng.normal(size=(N, M, 2))).astype(np.float32)
    X0 = np.ones((M, 2), np.float32)
    ref = jax_make_loss_fn(jprob, jnet, JaxConfig(remat=False, objective=objective))(
        params, ts, dWs, X0)
    port = from_flax_params(jax.tree.map(np.asarray, params), "Sine", device="cpu")
    res = make_loss_fn(prob, port, SolverConfig(remat=False, objective=objective))(
        port, *(torch.from_numpy(x) for x in (ts, dWs, X0)))
    np.testing.assert_allclose(float(res.loss), float(ref.loss), rtol=1e-5)
    np.testing.assert_allclose(float(res.Y0), float(ref.Y0), rtol=1e-5)
