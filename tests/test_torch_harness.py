"""The port's oracle-gated harness against the JAX package's: ``_run`` at a
tiny size on the CPU (phases, the legacy two-phase form, the EMA headline),
and each of the five rows handing ``_run`` exactly the constants the JAX
row hands its ``_run`` (both ``_run`` replaced, so nothing trains). The
oracles: closed forms within 1e-5 relative (f32 on both sides), the
Monte-Carlo ones (200k and 1e5 draws, standard errors ≤ 0.1 %) within 1 %,
since the two packages draw other streams."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from dnnpde_tpu.bench import harness as jax_harness
from dnnpde_tpu_torch.bench import harness
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.solver import make_net_u
from dnnpde_tpu_torch.train import Trainer

TINY = dict(M=8, N=4, layers=[3, 8, 8, 1], device="cpu")


@pytest.fixture
def trainers(monkeypatch):
    """Every Trainer ``harness._run`` builds, in order."""
    made = []

    class Recording(Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(harness, "Trainer", Recording)
    return made


def test_run_phases_warm_up_and_row(trainers):
    prob = BlackScholesBarenblatt(D=2)
    row = harness._run("tiny", prob, 1.0, phases=((200, 1e-3), (300, 1e-4)), seed=3, **TINY)
    (tr,) = trainers
    assert tr._next_it == 100 + 500  # the warm-up trains too, outside the timed window
    assert tr.iteration[-5:] == [100, 200, 300, 400, 500]
    assert row.learned_y0 == float(np.mean(tr.y0_log[-3:]))
    assert row.rel_error == abs(row.learned_y0 - 1.0)
    assert row.config == dict(M=8, N=4, D=2, mode="FC", activation="Sine",
                              phases=[[200, 1e-3], [300, 1e-4]])
    assert row.iters_per_sec == pytest.approx(500 / row.wall_time_s)
    assert row.paths_steps_per_sec == pytest.approx(500 * 8 * 4 / row.wall_time_s)
    assert list(row.as_dict()) == [f.name for f in dataclasses.fields(jax_harness.BenchRow)]
    json.dumps(row.as_dict())


def test_run_legacy_two_phase_form_and_short_tail(trainers):
    prob = BlackScholesBarenblatt(D=2)
    row = harness._run("tiny", prob, 2.0, iters=(100, 100), lrs=(1e-3, 1e-5), **TINY)
    (tr,) = trainers
    assert row.config["phases"] == [[100, 1e-3], [100, 1e-5]]
    assert tr._next_it == 300
    # a 100-iteration last phase logs once: its tail is that one log
    assert row.learned_y0 == tr.y0_log[-1]


def test_run_default_budget_is_2000_then_500(monkeypatch):
    calls = []

    class Stub:
        def __init__(self, problem, **kw):
            self.device, self.y0_log = torch.device("cpu"), [0.5]

        def train(self, n_iter, lr, **kw):
            calls.append((n_iter, lr))

    monkeypatch.setattr(harness, "Trainer", Stub)
    row = harness._run("tiny", BlackScholesBarenblatt(D=2), 2.0, M=8, N=4)
    assert calls == [(100, 1e-3), (2000, 1e-3), (500, 1e-5)]
    assert row.config["phases"] == [[2000, 1e-3], [500, 1e-5]] and row.learned_y0 == 0.5


def test_run_ema_headline_reads_the_ema_shadow(trainers):
    prob = BlackScholesBarenblatt(D=2)
    row = harness._run("tiny", prob, 1.0, phases=((200, 1e-3),), ema_decay=0.99, **TINY)
    (tr,) = trainers
    with torch.no_grad():
        u, _ = make_net_u(tr.ema_params, prob.transform_u)(torch.zeros(1, 1), prob.x0[None])
    assert row.learned_y0 == float(u[0, 0])
    assert row.config["ema_decay"] == 0.99
    assert row.config["raw_tail_y0"] == float(np.mean(tr.y0_log[-2:]))
    assert row.learned_y0 != row.config["raw_tail_y0"]


def _captured(module, monkeypatch, fn, **kw):
    seen = {}

    def fake_run(name, problem, oracle_y0, **kwargs):
        seen.update(name=name, problem=problem, oracle=float(oracle_y0), **kwargs)

    monkeypatch.setattr(module, "_run", fake_run)
    fn(**kw)
    return seen


@pytest.mark.parametrize("iters", [None, (30, 20)], ids=["default", "legacy"])
@pytest.mark.parametrize("row", list(jax_harness.ALL_BENCHES))
def test_rows_hand_run_the_jax_constants(monkeypatch, row, iters):
    assert list(harness.ALL_BENCHES) == list(jax_harness.ALL_BENCHES)
    ours = _captured(harness, monkeypatch, harness.ALL_BENCHES[row], iters=iters, seed=5,
                     device="cpu")
    ref = _captured(jax_harness, monkeypatch, jax_harness.ALL_BENCHES[row], iters=iters, seed=5)
    assert ours.pop("device") == "cpu"
    p, jp = ours.pop("problem"), ref.pop("problem")
    assert type(p).__name__ == type(jp).__name__
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    o, jo = ours.pop("oracle"), ref.pop("oracle")
    mc = row in ("basket_100d", "hjb_100d")
    assert o == pytest.approx(jo, rel=1e-2 if mc else 1e-5)
    assert ours == ref


def test_main_names_rows_and_needs_a_card(monkeypatch, capsys):
    assert harness.main(["nope"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["heston"]) == 1
    assert "is_available" in capsys.readouterr().err
