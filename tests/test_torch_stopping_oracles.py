"""The port's optimal-stopping oracles against the JAX package's, on the CPU:
the Longstaff–Schwartz host pieces (``_basis``, ``_fit``, ``_predict``,
``basis_size``) equal on shared numpy inputs; ``lsmc_value`` (plain and
CV-boosted, with the net's weights carried across by ``from_flax_params``)
and ``policy_value`` within 4 combined standard errors of JAX's at a small
path count (the two draw different random streams); and the JAX tests of
``test_lsmc.py``, ``test_maxcall.py`` and ``test_policy_value.py`` held on
the port (the never-exercise policy against JAX's ``discrete_bsde_value``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.evals import policy_value as jax_policy_value
from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.numerics import discrete_bsde_value as jax_discrete_bsde_value
from dnnpde_tpu.numerics import longstaff_schwartz as jax_ls
from dnnpde_tpu.numerics import lsmc_value as jax_lsmc_value
from dnnpde_tpu.pde import AmericanPutOption as JaxAmericanPut
from dnnpde_tpu.pde import BermudanMaxCall as JaxMaxCall
from dnnpde_tpu.pde import HestonAmericanPut as JaxHestonAmerican
from dnnpde_tpu.solver import make_net_u as jax_make_net_u
from dnnpde_tpu_torch.evals import policy_value, policy_value_from_trainer
from dnnpde_tpu_torch.numerics import basis_size, crr_binomial, lsmc_value
from dnnpde_tpu_torch.numerics import longstaff_schwartz as ls
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import (
    AmericanPutOption,
    BermudanMaxCall,
    BlackScholesBarenblatt,
    CallOption1D,
    HestonAmericanPut,
)
from dnnpde_tpu_torch.train import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with several test workers on one host, PyTorch's
    default of one thread per core makes these small CPU ops many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 10
SMALL = dict(n_regression=32_768, n_pricing=65_536)


def _z(a, b):
    """|a − b| in combined standard errors of two estimates."""
    return abs(a.value - b.value) / np.hypot(a.standard_error, b.standard_error)


class _Const(torch.nn.Module):
    """A 'net' whose raw output is the constant c everywhere."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.anchor = torch.nn.Parameter(torch.zeros(()))  # gives the module a device

    def forward(self, x):
        return torch.full((x.shape[0], 1), self.c, dtype=x.dtype, device=x.device)


def _net_pair(dim, seed=4, width=16):
    layers = [dim + 1, width, width, 1]
    net = jax_build_network("FC", layers, "Sine")
    params = net.init(jax.random.PRNGKey(seed), jnp.ones((1, layers[0])))
    port = from_flax_params(jax.tree.map(np.asarray, params), "sine", device="cpu")
    return net, params, port


@pytest.mark.parametrize("D,degree,basis", [(1, 3, "monomial"), (2, 3, "monomial"),
                                            (2, 2, "sorted"), (5, 3, "sorted"),
                                            (3, 2, "monomial")])
def test_basis_fit_predict_equal_jax(D, degree, basis):
    rng = np.random.default_rng(D * 10 + degree)
    X = rng.lognormal(0.0, 0.3, (512, D))
    g = np.maximum(X.max(axis=1) - 1.0, 0.0)
    y = g * 0.97 + 0.05 * rng.normal(size=512)
    w = (g > 0).astype(np.float64)
    Phi = ls._basis(X, g, degree, basis)
    np.testing.assert_array_equal(Phi, jax_ls._basis(X, g, degree, basis))
    assert Phi.shape[1] == basis_size(D, degree, basis) == jax_ls.basis_size(D, degree, basis)
    fit, jfit = ls._fit(Phi, y, w), jax_ls._fit(Phi, y, w)
    for a, b in zip(fit, jfit):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ls._predict(Phi, fit), jax_ls._predict(Phi, jfit))


def test_basis_cap_and_kind_raise_as_jax():
    X = np.random.default_rng(2).lognormal(0.0, 0.3, (8, 10))
    g = np.maximum(X.max(axis=1) - 1.0, 0.0)
    assert basis_size(10, 3) > ls._MAX_BASIS
    assert basis_size(5, 3, "sorted") == basis_size(500, 3, "sorted")
    with pytest.raises(ValueError, match="cap"):
        ls._basis(X, g, 3, basis="monomial")
    with pytest.raises(ValueError, match="basis must be"):
        ls._basis(X, g, 3, basis="legendre")


@pytest.mark.parametrize("name,jprob,prob,kw", [
    ("american-put", JaxAmericanPut(), AmericanPutOption(), dict(N=N)),
    ("heston-american", JaxHestonAmerican(), HestonAmericanPut(), dict(N=N)),
    ("max-call-sorted", JaxMaxCall(N_steps=9), BermudanMaxCall(N_steps=9),
     dict(N=9, basis="sorted")),
])
def test_lsmc_value_within_4_se_of_jax(name, jprob, prob, kw):
    ours = lsmc_value(prob, **kw, **SMALL, seed=0, device="cpu")
    ref = jax_lsmc_value(jprob, **kw, **SMALL, seed=0)
    assert (ours.N, ours.n_regression, ours.n_pricing) == (ref.N, ref.n_regression, ref.n_pricing)
    assert abs(ours.rate - ref.rate) < 1e-7
    assert _z(ours, ref) < 4.0, (ours.value, ref.value)
    assert ours.value <= ours.in_sample_value + 4 * ours.standard_error


def test_cv_boosted_lsmc_matches_jax_and_the_plain_read():
    """The same weights in both packages: the CV-boosted value within 4
    combined SE of JAX's; on the port, the CV value agrees with the plain
    LSMC of the same paths, reduces the variance, and a fixed c = 1 keeps
    the plain value."""
    jprob, prob = JaxAmericanPut(), AmericanPutOption()
    net, params, port = _net_pair(1)
    plain = lsmc_value(prob, N=N, **SMALL, seed=0, device="cpu")
    cv = lsmc_value(prob, N=N, **SMALL, seed=0, cv_net=port)
    ref = jax_lsmc_value(jprob, N=N, **SMALL, seed=0,
                         cv_net_u=jax_make_net_u(net, transform=jprob.transform_u),
                         cv_params=params)
    assert _z(cv, ref) < 4.0, (cv.value, ref.value)
    assert cv.cv_variance_reduction > 3.0, cv.cv_variance_reduction
    assert cv.plain_value == plain.value  # same paths, same policy
    assert _z(cv, plain) < 4.0
    fixed = lsmc_value(prob, N=N, **SMALL, seed=0, cv_net=port, cv_c=1.0)
    assert fixed.cv_c == 1.0 and fixed.plain_value == plain.value
    assert fixed.cv_variance_reduction > 2.0
    assert _z(fixed, plain) < 4.0


def test_lsmc_matches_the_bermudan_tree_and_sits_above_the_european():
    p = AmericanPutOption()
    v = lsmc_value(p, N=N, n_regression=65_536, n_pricing=131_072, seed=0, device="cpu")
    tree = crr_binomial(1.0, p.K, p.T, p.r, p.sigma_bar, n_steps=N * 100, exercise_every=100)
    assert abs(v.value - tree) / tree < 0.01, (v.value, tree)
    euro = jax_discrete_bsde_value(JaxAmericanPut(), N=N, n_paths=1_048_576, seed=9)
    assert v.value - euro.value > 4 * np.hypot(v.standard_error, euro.standard_error)
    again = lsmc_value(p, N=N, n_regression=65_536, n_pricing=131_072, seed=0, device="cpu")
    assert again.value == v.value  # deterministic given the seed


def test_lsmc_exercise_dates_x0_override_and_validation():
    p = BermudanMaxCall(D=2, N_steps=9)
    kw = dict(N=9, n_regression=16_384, n_pricing=32_768, seed=0, basis="sorted", device="cpu")
    b9, b3, eu = (lsmc_value(p, exercise_every=k, **kw) for k in (1, 3, 9))
    se = 4 * max(b9.standard_error, b3.standard_error, eu.standard_error)
    assert b3.value <= b9.value + se and eu.value <= b3.value + se
    with pytest.raises(ValueError, match="multiple"):
        lsmc_value(p, N=9, n_regression=4096, n_pricing=4096, exercise_every=4, device="cpu")
    with pytest.raises(ValueError):
        lsmc_value(BlackScholesBarenblatt(D=2), N=4, n_regression=1024, n_pricing=1024,
                   device="cpu")
    put = AmericanPutOption()
    kw = dict(N=N, n_regression=16_384, n_pricing=32_768, seed=3, device="cpu")
    itm = lsmc_value(put, x0=np.asarray([0.8], np.float32), **kw)
    atm = lsmc_value(put, **kw)
    assert itm.value >= 0.2 - 1e-6 and itm.value > atm.value


def test_max_call_d1_lsmc_matches_the_dividend_call_tree():
    p = BermudanMaxCall(D=1, N_steps=45)
    v = lsmc_value(p, N=45, n_regression=32_768, n_pricing=65_536, seed=0, device="cpu")
    tree = crr_binomial(p.S0, p.K, p.T, p.r, p.sigma_bar, n_steps=45 * 40, payoff="call",
                        american=True, exercise_every=5 * 40, q=p.delta)
    eu = crr_binomial(p.S0, p.K, p.T, p.r, p.sigma_bar, n_steps=45 * 40, payoff="call",
                      american=False, q=p.delta)
    assert abs(v.value - tree) / tree < 0.01, (v.value, tree)
    assert tree - eu > 1.5


def test_never_exercise_policy_equals_jaxs_european_discrete_value():
    """u ≡ +1e9 never exercises early: the policy value is the European leg
    of the same chain, JAX's ``discrete_bsde_value``."""
    p = AmericanPutOption(bs_head=False)
    pv = policy_value(p, _Const(1e9), N=N, n_paths=262_144, seed=0)
    eu = jax_discrete_bsde_value(JaxAmericanPut(bs_head=False), N=N, n_paths=1_048_576, seed=1)
    assert pv.exercise_fraction == 0.0 and not pv.immediate
    assert _z(pv, eu) < 4.0, (pv.value, eu.value)


def test_always_exercise_policy_and_masked_dates():
    p = AmericanPutOption(bs_head=False)
    greedy = policy_value(p, _Const(-1e9), N=N, n_paths=131_072, seed=0)
    tree = crr_binomial(1.0, p.K, p.T, p.r, p.sigma_bar, n_steps=N * 100, exercise_every=100)
    assert 0.0 < greedy.value < tree + 4 * greedy.standard_error
    assert greedy.exercise_fraction > 0.5
    mc = BermudanMaxCall(D=2, N_steps=N, n_exercise=2, head=False)
    masked = policy_value(mc, _Const(-1e9), N=N, n_paths=32_768, seed=3, exercise_every=N)
    hold = policy_value(mc, _Const(1e9), N=N, n_paths=32_768, seed=3)
    assert masked.exercise_fraction == 0.0
    assert masked.value == pytest.approx(hold.value, abs=1e-9)
    with pytest.raises(ValueError, match="optimal-stopping"):
        policy_value(CallOption1D(), _Const(0.0), N=N)
    with pytest.raises(ValueError, match="multiple"):
        policy_value(mc, _Const(0.0), N=N, exercise_every=3)


@pytest.mark.parametrize("name,jprob,prob,N_", [
    ("american-put-head", JaxAmericanPut(), AmericanPutOption(), N),
    ("max-call-head", JaxMaxCall(N_steps=9), BermudanMaxCall(N_steps=9), 9),
])
def test_policy_value_of_a_net_within_4_se_of_jax(name, jprob, prob, N_):
    """The same weights' stopping rule in both packages, through each
    problem's head."""
    net, params, port = _net_pair(prob.dim, seed=7)
    ours = policy_value(prob, port, N=N_, n_paths=131_072, batch=65_536, seed=0)
    ref = jax_policy_value(jprob, jax_make_net_u(net, transform=jprob.transform_u), params,
                           N=N_, n_paths=131_072, batch=65_536, seed=0)
    assert (ours.n_paths, ours.N) == (ref.n_paths, ref.N)
    assert _z(ours, ref) < 4.0, (ours.value, ref.value)
    se_frac = np.sqrt(ref.exercise_fraction * (1 - ref.exercise_fraction) / ref.n_paths)
    assert abs(ours.exercise_fraction - ref.exercise_fraction) < 6 * se_frac + 1e-3


def test_trained_max_call_policy_brackets_with_the_trees():
    """Short training on the D = 1 max-call: its policy value stays below
    the Bermudan tree and beats never exercising."""
    p = BermudanMaxCall(D=1, N_steps=9, n_exercise=9)
    tr = Trainer(p, M=64, N=9, layers=[2, 16, 16, 1], seed=0, ema_decay=0.999,
                 objective="local", device="cpu")
    tr.train(300, 1e-3, log_every=150, verbose=False)
    pv = policy_value_from_trainer(tr, n_paths=65_536, seed=5)
    n_tree = 9 * 200
    tree = crr_binomial(p.S0, p.K, p.T, p.r, p.sigma_bar, n_steps=n_tree, payoff="call",
                        american=True, exercise_every=n_tree // 9, q=p.delta)
    eu = crr_binomial(p.S0, p.K, p.T, p.r, p.sigma_bar, n_steps=n_tree, payoff="call",
                      american=False, q=p.delta)
    assert pv.value < tree + 4 * pv.standard_error
    assert pv.value > eu
