"""The port's neural control variate against the JAX package's, on the
CPU: on JAX's increments and the same net the estimator's value, SEs,
coefficient and variance reduction equal JAX's within 1e-5 (relative; f32
chains summed in other orders); with c = 1 it is unbiased, within 4
combined SE of the discrete oracle; early exercise is refused."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu import pde as jpde
from dnnpde_tpu.evals import neural_cv_value as jax_neural_cv_value
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch import pde
from dnnpde_tpu_torch.evals import control_variate, neural_cv_from_trainer, neural_cv_value
from dnnpde_tpu_torch.numerics import discrete_bsde_value
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.solver import make_net_u
from dnnpde_tpu_torch.train import Trainer

N = 8
CASES = {
    "barrier": (jpde.UpAndOutCall(), pde.UpAndOutCall()),
    "asian": (jpde.AsianCallOption(N_samples=N), pde.AsianCallOption(N_samples=N)),
    "call1d": (jpde.CallOption1D(), pde.CallOption1D()),
}


def _jax_increments(seed, n_batches, batch, Dw, dt):
    """The draws of the JAX estimator: batch b, step n from
    ``fold_in(split(PRNGKey(seed), n_batches)[b], n)``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_batches)
    sqrt_dt = np.sqrt(dt)
    return [[np.array(sqrt_dt * jax.random.normal(jax.random.fold_in(k, n), (batch, Dw),
                                                    jnp.float32)) for n in range(N)]
            for k in keys]


@pytest.mark.parametrize("case", list(CASES))
def test_estimator_on_jax_increments_equals_jaxs(case, monkeypatch):
    jprob, prob = CASES[case]
    jtr = JaxTrainer(jprob, M=8, N=N, layers=[prob.dim + 1, 16, 16, 1], seed=4)
    net = from_flax_params(jax.tree.map(np.asarray, jtr.params), "Sine", device="cpu")
    n_paths, batch = 4096, 2048
    draws = iter(_jax_increments(11, 2, batch, prob.noise_dim, prob.T / N))
    monkeypatch.setattr(control_variate, "_step_increments",
                        lambda *a, **k: (torch.from_numpy(d) for d in next(draws)))
    net_u = make_net_u(net, transform=prob.transform_u)
    ours = neural_cv_value(prob, net_u, N, n_paths=n_paths, seed=11, batch=batch, device="cpu")
    ref = jax_neural_cv_value(jprob, jtr.net_u, jtr.params, N, n_paths=n_paths, seed=11,
                              batch=batch)
    assert (ours.n_paths, ours.N) == (ref.n_paths, ref.N)
    for key in ("value", "plain_value", "standard_error", "plain_standard_error", "c",
                "variance_reduction"):
        assert getattr(ours, key) == pytest.approx(getattr(ref, key), rel=1e-5), key
    assert ours.martingale_mean == pytest.approx(ref.martingale_mean, rel=1e-4, abs=1e-7)


def test_unit_coefficient_is_unbiased_against_the_discrete_oracle():
    """c = 1 on a briefly trained barrier net: within 4 combined SE of the
    discrete oracle, and the fitted coefficient reduces the variance."""
    tr = Trainer(pde.UpAndOutCall(), M=64, N=N, layers=[3, 16, 16, 1], seed=0,
                 objective="local", device="cpu")
    tr.train(60, 1e-3, log_every=30, verbose=False)
    one = neural_cv_value(tr.problem, tr.net_u, N, n_paths=65_536, seed=2, c=1.0,
                          device="cpu")
    oracle = discrete_bsde_value(tr.problem, N=N, n_paths=262_144, seed=9, device="cpu")
    assert one.c == 1.0
    z = abs(one.value - oracle.value) / np.hypot(one.standard_error, oracle.standard_error)
    assert z < 4.0, (one, oracle)
    fitted = neural_cv_from_trainer(tr, use_ema=False, n_paths=65_536, seed=2)
    assert fitted.plain_value == one.plain_value
    assert fitted.variance_reduction >= one.variance_reduction
    assert fitted.variance_reduction > 1.0


@pytest.mark.parametrize("prob", [pde.AmericanPutOption(), pde.BermudanMaxCall()],
                         ids=["american_put", "max_call"])
def test_early_exercise_is_refused(prob):
    net_u = make_net_u(torch.nn.Linear(prob.dim + 1, 1), transform=prob.transform_u)
    with pytest.raises(ValueError, match="early exercise"):
        neural_cv_value(prob, net_u, 9, n_paths=64, device="cpu")


def test_z_coupled_driver_is_refused():
    prob = pde.BlackScholesBarenblatt(D=2)
    with pytest.raises(ValueError, match="depends on Z"):
        neural_cv_value(prob, make_net_u(torch.nn.Linear(3, 1)), 4, n_paths=64, device="cpu")
