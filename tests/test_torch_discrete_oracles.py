"""The port's discrete-N BSDE oracles against the JAX package's, on the
CPU: the Euler + post_step chain on JAX's increments (X_N within 1e-5 of
max(1, max|ref|)), ``discrete_bsde_value`` (within 4 combined standard
errors at 65,536 paths: the port draws its own increments), the refusal of
Z-coupled drivers, and the QMC oracle, whose Sobol points come from the
same scipy code on both sides (bridge order identical, increments within
1e-6, values within 1e-5 relative)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu import numerics as jnum
from dnnpde_tpu import pde as jpde
from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.solver import SolverConfig as JaxConfig
from dnnpde_tpu.solver import make_loss_fn as jax_make_loss_fn
from dnnpde_tpu_torch import numerics, pde
from dnnpde_tpu_torch.numerics.discrete_bsde import euler_terminal_states

N = 8
PROBLEMS = {
    "barrier": (jpde.UpAndOutCall(), pde.UpAndOutCall()),
    "barrier-hard": (jpde.UpAndOutCall(smooth_beta=None), pde.UpAndOutCall(smooth_beta=None)),
    "asian": (jpde.AsianCallOption(N_samples=N), pde.AsianCallOption(N_samples=N)),
    "lookback": (jpde.LookbackCallOption(), pde.LookbackCallOption()),
    "call1d": (jpde.CallOption1D(), pde.CallOption1D()),
}


@pytest.mark.parametrize("case", list(PROBLEMS))
def test_euler_chain_on_jax_increments_matches_the_jax_rollout(case):
    """X_N of the port's chain on the increments the JAX solver's rollout
    is given: the rollout's X does not depend on the net for these
    problems (μ and σ read neither Y nor Z)."""
    jprob, prob = PROBLEMS[case]
    M, D = 64, prob.dim
    rng = np.random.default_rng(3)
    dWs = (np.sqrt(1.0 / N) * rng.normal(size=(N, M, D))).astype(np.float32)
    ts = np.broadcast_to(np.linspace(0.0, 1.0, N + 1, dtype=np.float32)[:, None, None],
                         (N + 1, M, 1)).copy()
    X0 = np.broadcast_to(np.asarray(jprob.x0), (M, D)).copy()
    net = jax_build_network("FC", [D + 1, 8, 1], "Sine")
    params = net.init(jax.random.PRNGKey(0), jnp.ones((1, D + 1)))
    ref = np.asarray(jax_make_loss_fn(jprob, net, JaxConfig(remat=False))(
        params, ts, dWs, X0).X[:, -1])
    ours = euler_terminal_states(prob, torch.from_numpy(X0), torch.from_numpy(dWs), N)
    assert ours.shape == ref.shape
    assert np.abs(ours.numpy() - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("case", ["barrier", "asian", "lookback", "call1d"])
def test_discrete_value_agrees_with_jax_within_4_se(case):
    jprob, prob = PROBLEMS[case]
    ref = jnum.discrete_bsde_value(jprob, N=N, n_paths=65_536, seed=0, batch=32_768)
    ours = numerics.discrete_bsde_value(prob, N=N, n_paths=65_536, seed=0, batch=32_768,
                                        device="cpu")
    assert (ours.n_paths, ours.N) == (ref.n_paths, ref.N)
    assert ours.rate == pytest.approx(ref.rate, abs=1e-7)
    assert 0.0 < ours.standard_error < 0.01 * ours.value
    z = abs(ours.value - ref.value) / np.hypot(ours.standard_error, ref.standard_error)
    assert z < 4.0, (ours, ref)


def test_pair_mean_se_is_smaller_than_the_pooled_se():
    """Antithetic pairs of the 1-D call: the reported SE is that of the pair
    means, below the i.i.d. error of as many plain paths."""
    prob = pde.CallOption1D()
    anti = numerics.discrete_bsde_value(prob, N=N, n_paths=65_536, seed=1, device="cpu")
    plain = numerics.discrete_bsde_value(prob, N=N, n_paths=65_536, seed=1, antithetic=False,
                                         device="cpu")
    assert anti.n_paths == plain.n_paths == 65_536
    assert anti.standard_error < 0.8 * plain.standard_error
    z = abs(anti.value - plain.value) / np.hypot(anti.standard_error, plain.standard_error)
    assert z < 4.0


def test_surface_keys_each_state_on_its_own_stream():
    prob = pde.CallOption1D()
    x0s = np.array([[0.9], [1.0], [1.1]], np.float32)
    vals = numerics.discrete_bsde_surface(prob, N=N, x0s=x0s, n_paths=8192, device="cpu")
    assert [v.value for v in vals] == sorted(v.value for v in vals)
    one = numerics.discrete_bsde_value(prob, N=N, n_paths=8192, seed=1000, x0=x0s[1],
                                       device="cpu")
    assert vals[1].value == one.value
    with pytest.raises(ValueError, match="x0s must be"):
        numerics.discrete_bsde_surface(prob, N=N, x0s=np.ones((2, 3)), device="cpu")


@pytest.mark.parametrize("prob", [pde.BlackScholesBarenblatt(D=3),
                                  pde.HamiltonJacobiBellman(D=3)], ids=["bsb", "hjb"])
def test_z_coupled_drivers_are_refused(prob):
    with pytest.raises(ValueError):
        numerics.discrete_bsde_value(prob, N=4, n_paths=64, device="cpu")
    with pytest.raises(ValueError):
        numerics.discrete_bsde_value_qmc(prob, N=4, n_paths=64, n_replicates=2, device="cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 50, 64, 100])
def test_brownian_bridge_order_is_jaxs(n):
    ours = numerics.brownian_bridge_order(n)
    np.testing.assert_array_equal(ours, jnum.brownian_bridge_order(n))
    assert sorted(ours.tolist()) == list(range(n))


@pytest.mark.parametrize("bridge", [True, False])
def test_sobol_increments_are_jaxs(bridge):
    kw = dict(n=1000, N=6, Dw=2, dt=1 / 6, seed=5, bridge=bridge)
    ours = numerics.sobol_brownian_increments(**kw)
    ref = jnum.sobol_brownian_increments(**kw)
    assert ours.shape == ref.shape == (1024, 6, 2) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-6


@pytest.mark.parametrize("case", ["barrier", "asian", "lookback", "call1d"])
def test_qmc_value_equals_jaxs_on_the_same_points(case):
    jprob, prob = PROBLEMS[case]
    kw = dict(N=N, n_paths=2048, n_replicates=4, seed=3)
    ref = jnum.discrete_bsde_value_qmc(jprob, **kw)
    ours = numerics.discrete_bsde_value_qmc(prob, **kw, device="cpu")
    assert (ours.n_paths, ours.n_replicates) == (ref.n_paths, ref.n_replicates) == (8192, 4)
    assert ours.value == pytest.approx(ref.value, rel=1e-5)
    assert ours.standard_error == pytest.approx(ref.standard_error, rel=1e-3, abs=1e-7)
