"""The port's ``train/diagnostics.py`` and orbax-style checkpoints against
the JAX package's, on the CPU: ``detect_anomalies`` raises
``FloatingPointError`` on a NaN or an Inf made in the forward or the
backward pass (JAX's ``jax_debug_nans``/``jax_debug_infs``), leaves the
previous state on exit and keeps a Trainer off captured chunks;
``StepTimer`` as JAX's; ``device_memory_stats`` under JAX's keys;
``profile_trace`` writes a trace; the directory checkpoints round-trip as
JAX's do."""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.train import StepTimer as JaxStepTimer
from dnnpde_tpu.train import detect_anomalies as jax_detect_anomalies
from dnnpde_tpu.train import device_memory_stats as jax_device_memory_stats
from dnnpde_tpu.train import restore_checkpoint_orbax as jax_restore
from dnnpde_tpu.train import save_checkpoint_orbax as jax_save
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.train import (
    StepTimer,
    Trainer,
    detect_anomalies,
    device_memory_stats,
    profile_trace,
    restore_checkpoint_orbax,
    save_checkpoint_orbax,
)
from dnnpde_tpu_torch.train.diagnostics import anomalies_checked


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_raises(fn) -> bool:
    try:
        with jax_detect_anomalies():
            jax.block_until_ready(jax.jit(fn)(jnp.asarray([-1.0, 0.0])))
    except FloatingPointError:
        return True
    return False


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_forward_nan_and_inf_raise_as_in_jax(kind):
    """log(−1) is NaN, 1/0 is Inf: both packages raise FloatingPointError
    inside the context and not outside it."""
    fn = (lambda x: jnp.log(x)) if kind == "nan" else (lambda x: 1.0 / x)
    tfn = (lambda x: torch.log(x)) if kind == "nan" else (lambda x: 1.0 / x)
    assert _jax_raises(fn)
    x = torch.tensor([-1.0, 0.0])
    with pytest.raises(FloatingPointError, match=kind.capitalize() if kind == "inf" else "NaN"):
        with detect_anomalies():
            tfn(x)
    tfn(x)  # unchecked outside
    assert not anomalies_checked()


def test_backward_nan_and_inf_raise():
    """sqrt at 0 is finite forward; its backward divides by 2·sqrt(0): Inf,
    and NaN when the incoming gradient is 0."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="Inf"):
        with detect_anomalies():
            torch.sqrt(x).sum().backward()
    x.grad = None
    y = torch.sqrt(x) * 0.0
    with pytest.raises(FloatingPointError, match="NaN"):
        with detect_anomalies(nans=True, infs=False):
            y.sum().backward()
    # the JAX package raises on the same backward NaN
    assert _jax_raises(lambda v: jax.grad(lambda z: jnp.sum(jnp.sqrt(z) * 0.0))(v * 0.0))


def test_switches_and_state_restored():
    """``nans=False`` lets a NaN through, ``infs=False`` an Inf; the checks
    nest, and each exit restores the state before it."""
    x = torch.tensor([-1.0, 0.0])
    with detect_anomalies(nans=False, infs=True):
        assert torch.isnan(torch.log(x[:1])).all()
        with pytest.raises(FloatingPointError):
            1.0 / x
    with detect_anomalies(nans=True, infs=False):
        assert torch.isinf(1.0 / x[1:]).all()
        with detect_anomalies():
            assert anomalies_checked()
        assert anomalies_checked()
    assert not anomalies_checked()
    torch.empty(4)  # uninitialized memory is never checked
    with detect_anomalies():
        torch.empty(1000).fill_(1.0)


def test_trainer_runs_checked_and_eagerly():
    """A Trainer inside the context trains (every op checked), and a NaN in
    its loss raises there; outside, the same run trains unchecked."""
    prob = BlackScholesBarenblatt(D=2)
    tr = Trainer(prob, M=4, N=2, layers=[3, 8, 8, 1], seed=0, device="cpu")
    with detect_anomalies():
        res = tr.train(2, 1e-3, log_every=1, verbose=False)
    assert np.isfinite(res.graph[1]).all()
    assert all(c.graph is None for c in tr._chunk_cache.values())
    bad = Trainer(prob, M=4, N=2, layers=[3, 8, 8, 1], seed=0, device="cpu")
    with torch.no_grad():
        next(bad.net.parameters()).fill_(float("nan"))
    with pytest.raises(FloatingPointError):
        with detect_anomalies():
            bad.train(1, 1e-3, log_every=1, verbose=False)
    assert np.isnan(bad.train(1, 1e-3, log_every=1, verbose=False).graph[1]).all()


def test_step_timer_as_jax():
    for timer in (StepTimer(), JaxStepTimer()):
        assert timer.lap() >= 0.0
        timer.lap()
        assert len(timer.laps) == 2 and len(timer.cumulative) == 2
        assert timer.cumulative[-1] >= timer.cumulative[0]


def test_device_memory_stats_keys_as_jax():
    """JAX's three keys; on the CPU every value is None, as JAX's CPU
    device reports."""
    ours = device_memory_stats("cpu")
    ref = jax_device_memory_stats(jax.devices("cpu")[0])
    assert list(ours) == list(ref)
    assert all(v is None for v in ours.values()) and all(v is None for v in ref.values())


def test_profile_trace_writes_a_trace(tmp_path):
    """A Chrome-trace JSON file in the directory (what TensorBoard's plugin
    and Perfetto read), holding the block's ops."""
    with profile_trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(Path(tmp_path).glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_orbax_checkpoint_roundtrip(tmp_path):
    """``tests/test_train.py``'s orbax test in both packages on the same
    state: restored with the template, and (the port) without one; a second
    save overwrites; the template is left as it was."""
    state = {"w": np.arange(4.0, dtype=np.float32), "step": np.asarray(3)}
    jax_save(str(tmp_path / "jax"), {k: jnp.asarray(v) for k, v in state.items()})
    jref = jax_restore(str(tmp_path / "jax"), {k: jnp.asarray(v) for k, v in state.items()})
    ours = {"w": torch.from_numpy(state["w"]), "step": torch.tensor(3),
            "nested": {"b": torch.ones(2, 3, dtype=torch.float64)}}
    path = str(tmp_path / "orbax_ckpt")
    save_checkpoint_orbax(path, ours)
    template = {"w": torch.zeros(4), "step": torch.tensor(0),
                "nested": {"b": torch.zeros(2, 3, dtype=torch.float64)}}
    restored = restore_checkpoint_orbax(path, template)
    bare = restore_checkpoint_orbax(path)
    for tree in (restored, bare):
        np.testing.assert_array_equal(tree["w"].numpy(), np.asarray(jref["w"]))
        assert int(tree["step"]) == int(jref["step"])
        assert torch.equal(tree["nested"]["b"], ours["nested"]["b"])
    assert torch.equal(template["w"], torch.zeros(4))
    save_checkpoint_orbax(path, {"w": torch.arange(3.0)})
    assert torch.equal(restore_checkpoint_orbax(path)["w"], torch.arange(3.0))


def test_orbax_checkpoint_of_a_trainer_state(tmp_path):
    """A trained Trainer's parameters and Adam state round-trip bit for bit."""
    tr = Trainer(BlackScholesBarenblatt(D=2), M=4, N=2, layers=[3, 8, 8, 1], seed=0, device="cpu")
    tr.train(2, 1e-3, log_every=1, verbose=False)
    state = {"params": {k: v.detach() for k, v in tr.net.named_parameters()},
             "mu": {str(i): t for i, t in enumerate(tr._opt_state["mu"])},
             "count": tr._opt_state["count"], "generator": tr.generator.get_state()}
    save_checkpoint_orbax(str(tmp_path / "tr"), state)
    back = restore_checkpoint_orbax(str(tmp_path / "tr"))
    flat, spec = torch.utils._pytree.tree_flatten(state)
    flat_b, spec_b = torch.utils._pytree.tree_flatten(back)
    assert spec == spec_b and all(torch.equal(a, b) for a, b in zip(flat, flat_b))


def test_orbax_checkpoint_keeps_plain_values_in_json(tmp_path):
    """Plain values and the tree's shape go into the JSON file beside the
    tensors, so DCP stores tensors only (it would pickle any other value);
    a restore without a template gives back tuples, lists and values as
    saved."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    state = {"step": 3, "name": "bsb", "rate": 1.5e-3, "flag": None,
             "pair": (torch.arange(3), [torch.ones(2, dtype=torch.float64), True])}
    path = tmp_path / "plain"
    save_checkpoint_orbax(str(path), state)
    tree = json.loads((path / "tree.json").read_text())
    assert tree["dict"]["step"] == {"value": 3} and tree["dict"]["name"] == {"value": "bsb"}
    meta = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
    assert len(meta) == 2 and all(isinstance(m, TensorStorageMetadata) for m in meta.values())
    back = restore_checkpoint_orbax(str(path))
    assert {k: back[k] for k in ("step", "name", "rate", "flag")} == \
        {"step": 3, "name": "bsb", "rate": 1.5e-3, "flag": None}
    assert isinstance(back["pair"], tuple) and isinstance(back["pair"][1], list)
    assert torch.equal(back["pair"][0], torch.arange(3)) and back["pair"][1][1] is True
    assert back["pair"][1][0].dtype == torch.float64 and torch.equal(back["pair"][1][0],
                                                                     torch.ones(2, dtype=torch.float64))
