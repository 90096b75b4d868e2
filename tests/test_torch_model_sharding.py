"""The port's tensor parallelism (``parallel/model_sharding.py``): the plan
against JAX's ``plan_tp_specs`` on the same shapes, and the cases of
``tests/test_model_sharding.py`` on a 2 × 2 (dp × tp) mesh of gloo ranks on
the CPU:

- the wide layers shard and the narrow ones stay replicated;
- the sharded MLP's output within 1e-5 relative of the unsharded one's (the
  JAX test's rtol), and so are its Z = ∇ₓu and the gradient of Σu² + ΣZ²
  through Z (a double backward across Megatron's f and g) of each
  parameter, relative to its max;
- four iterations of the dp × tp trainer against the unsharded one at rtol
  1e-3 (``test_tp_training_matches_replicated``), the ranks of one "tp"
  index bitwise equal, the checkpoint's full weights read by an unsharded
  trainer;
- NAIS-Net, SDENet, ResNet and Verlet (their wide weights gathered before
  use) against the same nets unsharded: initial weights bitwise, the first
  gradient within 1e-5 of each tensor's max, two iterations at rtol 1e-3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dnnpde_tpu.nets import MLP as JaxMLP
from dnnpde_tpu.parallel import plan_tp_specs as jax_plan_tp_specs
from dnnpde_tpu.parallel.model_sharding import _natural_key
from dnnpde_tpu_torch.nets import MLP
from dnnpde_tpu_torch.parallel import plan_tp_specs
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.train import Trainer
from torch_parallel_workers import run_job

SHAPES = [(9, 512, 512, 1), (9, 32, 32, 1), (9, 512, 512, 512, 1), (9, 512, 32, 32, 512, 1),
          (3, 512, 512, 512, 512, 1), (101, 256, 256, 256, 256, 1)]


def _as_jax(spec) -> P:
    """The port's placement of an ``nn.Linear.weight`` as JAX's kernel spec."""
    if spec.is_shard(0):
        return P(None, "tp")
    if spec.is_shard(1):
        return P("tp", None)
    return P()


@pytest.mark.parametrize("layers", SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("min_shard_dim", [512, 256])
def test_plan_is_jaxs(layers, min_shard_dim):
    """The same placements, weight by weight in forward order, the
    narrow-layer skip included (``test_plan_alternation_skips_narrow_layers``)."""
    params = JaxMLP(layers=layers, activation="sine").init(jax.random.PRNGKey(0),
                                                           jnp.ones((1, layers[0])))
    ref = jax_plan_tp_specs(params, min_shard_dim=min_shard_dim)
    ref_specs = [ref[k] for k in sorted(ref, key=_natural_key)]
    ours = plan_tp_specs(MLP(layers, device="cpu"), min_shard_dim=min_shard_dim)
    assert [_as_jax(s) for s in ours.values()] == ref_specs
    assert list(ours) == [("dense", str(k), "linear", "weight") for k in range(len(layers) - 1)]


def test_plan_alternation_skips_narrow_layers():
    plan = plan_tp_specs(MLP((9, 512, 32, 32, 512, 1), device="cpu"))
    assert [_as_jax(s) for s in plan.values()] == [
        P(None, "tp"), P("tp", None), P(), P(None, "tp"), P("tp", None)]


def test_plan_reads_a_state_dict_and_jax_layout_kernels():
    """A state dict plans as its module does; a kernel stored in JAX's
    (in, out) layout (Verlet, SDENet) shards along JAX's dims."""
    net = MLP((9, 512, 512, 1), device="cpu")
    assert plan_tp_specs(dict(net.named_parameters())) == plan_tp_specs(net)
    plan = plan_tp_specs({"a.kernel": torch.zeros(9, 512), "b.kernel": torch.zeros(512, 4)})
    assert plan[("a", "kernel")].is_shard(1) and plan[("b", "kernel")].is_shard(0)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    return run_job("tp", 4, tmp_path_factory.mktemp("tp"))


def test_mesh_2d_shape_and_groups(tp):
    r = tp[0]
    assert r["shape"] == {"dp": 2, "tp": 2}
    assert "need" in r["too_many"] or "only" in r["too_many"]
    assert r["backends"] == ["gloo", "gloo"]  # DeviceMesh's subgroups of a gloo world
    assert [x["groups"] for x in tp] == [[[0, 2], [0, 1]], [[1, 3], [0, 1]],
                                         [[0, 2], [2, 3]], [[1, 3], [2, 3]]]


def _rel_close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * (np.abs(b).max() + 1e-30)


@pytest.mark.parametrize("name", ["wide", "deep", "skip"])
def test_wide_kernels_get_tp_sharded_and_compute_the_same(tp, name):
    r = tp[0][name]
    assert any("Shard" in s for s in r["summary"].values()), r["summary"]
    plain, sharded = r["apply"]
    np.testing.assert_allclose(sharded.numpy(), plain.numpy(), rtol=1e-5)
    (u, Z, grads), (u_tp, Z_tp, grads_tp) = r["plain"], r["sharded"]
    _rel_close(u_tp, u, 1e-5)
    _rel_close(Z_tp, Z, 1e-5)
    for g, g_tp in zip(grads, grads_tp):
        _rel_close(g_tp, g, 1e-5)


def test_narrow_kernels_stay_replicated(tp):
    assert all(s == "Replicate()" for s in tp[0]["narrow"]["summary"].values())


def test_tp_alternates_column_and_row(tp):
    specs = [s for k, s in tp[0]["deep"]["summary"].items() if k.endswith("weight")]
    assert specs == ["Shard(dim=0)", "Shard(dim=1)", "Shard(dim=0)", "Shard(dim=1)"]


def test_tp_training_matches_replicated(tp):
    plain, sharded = tp[0]["training"]
    np.testing.assert_allclose(sharded, plain, rtol=1e-3)
    ref, ours = tp[0]["weights"]
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), v.detach().numpy(), rtol=1e-3, atol=1e-5)


def test_tp_ranks_of_one_shard_are_bitwise_equal(tp):
    by_shard = {}
    for r in tp:
        by_shard.setdefault(r["tp_index"], []).append(r["local"])
    for a, b in by_shard.values():
        for key in a:
            assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), key


def test_tp_checkpoint_holds_the_full_weights(tp):
    plain = Trainer(BlackScholesBarenblatt(D=8), M=8, N=3, layers=[9, 512, 512, 1], seed=0,
                    device="cpu")
    plain.load_model(tp[0]["checkpoint"])
    for k, v in plain.net.named_parameters():
        assert torch.equal(v, tp[0]["weights"][1][k])


@pytest.mark.parametrize("mode,extra", [("Naisnet", "blocks.0.weight"),
                                        ("SDEnet", "brownian.0"),
                                        ("Resnet", "blocks.0.linear.weight"),
                                        ("Verlet", "kernels.0")])
def test_tp_irregular_nets_step(tp, mode, extra):
    """A net whose sharded weights are gathered before use, on the 2 × 2
    mesh against the same net unsharded from the same seed: the gathered
    initial weights bitwise (the shards' ``right_inverse``), the first
    gradient gathered whole within 1e-5 of each tensor's max (the gather's
    backward keeps the right slice), two iterations' losses and weights at
    the MLP case's rtol 1e-3."""
    for r in tp:
        r = r[mode]
        assert extra in r["summary"], r["summary"]
        assert any("Shard" in s for s in r["summary"].values())
        plain, sharded = r["plain"], r["sharded"]
        assert set(sharded["initial"]) == set(plain["initial"])
        for k, v in plain["initial"].items():
            assert torch.equal(sharded["initial"][k], v), k
        assert set(sharded["grads"]) == set(plain["grads"])
        for k, g in plain["grads"].items():
            _rel_close(sharded["grads"][k], g, 1e-5)
        assert np.isfinite(sharded["losses"]).all()
        np.testing.assert_allclose(sharded["losses"], plain["losses"], rtol=1e-3)
        for k, v in plain["weights"].items():
            np.testing.assert_allclose(sharded["weights"][k].numpy(), v.numpy(),
                                       rtol=1e-3, atol=1e-5)
