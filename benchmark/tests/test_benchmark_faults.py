"""The check that decides ``correct`` fails what it must: a run with the
timed path broken underneath (the harness's look for a card skipped, each
cell at a small size on the CPU, its limits as committed) comes out not
correct for each fault the cell can have, and so does the control, the
reference in the precision below the configuration's put in the program's
place. A sound run at the same size comes out correct."""

import time

import pytest
import torch

from benchmark.calibrate import control_precision
from benchmark.core import spec as specs
from benchmark.core.runner import driver, run_cell

SPEC = specs.load_spec()
# a cell whose files are kept for a later benchmark PR, but which BENCHMARK.json leaves out
HESTON = {"name": "heston-train-m500", "config": "heston-fcsine256", "traffic": "train-m500",
          "chips": 1}
CELLS = [w["name"] for w in SPEC["workloads"]] + [HESTON["name"]]
TRAIN = ["bsb100-train-m100", HESTON["name"]]
SMALL_LAYERS = {101: [17, 64, 64, 64, 1], 3: [3, 64, 64, 64, 1]}


def _small(cell: str):
    w = HESTON if cell == HESTON["name"] else specs.workload(SPEC, cell)
    cfg, mix = specs.data("configs", w["config"]), specs.data("traffic", w["traffic"])
    cfg["layers"] = SMALL_LAYERS[cfg["layers"][0]]
    cfg["N"] = 8
    for part in ("problem", "reference"):
        if "D" in cfg[part]["args"]:
            cfg[part]["args"]["D"] = 16
    mix.update({"train": dict(M=16, chunk=4, trace_iterations=4),
                "serve": dict(b_min=8, b_max=256, sizes=8, pool=1024, sample=6, sample_of=24,
                              plan=4000),
                "rollout": dict(M=64, sample=3, sample_of=6, trace_requests=2)}[mix["driver"]])
    return w, cfg, mix


def _run(cell: str, seed: int = 2**31 + 11):
    w, cfg, mix = _small(cell)
    result, checks = run_cell(SPEC, w, seed, 0.2, False, "cpu", time.perf_counter(),
                              cfg=cfg, mix=mix)
    return result["correct"], checks


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    correct, checks = _run(cell)
    assert correct, checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    w, cfg, mix = _small(cell)
    d = driver(mix)
    limits = specs.data("limits", cell)
    for seed in (1, 2, 3):
        inp = d.inputs(cfg, mix, seed, "cpu")
        numbers = d.compare(d.reference(cfg, mix, inp, control_precision(d, cfg)),
                            d.reference(cfg, mix, inp, "f32"))
        assert any(v > limits[k] for k, v in numbers.items()), (seed, numbers, limits)


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    from dnnpde_tpu_torch.train import optimizers

    def update(self, grads, state, params):
        return [torch.zeros_like(p) for p in params], state

    monkeypatch.setattr(optimizers.Optimizer, "update", update)
    correct, checks = _run(cell)
    assert not correct and checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out(cell, monkeypatch):
    from dnnpde_tpu_torch.train import trainer

    make = trainer.make_loss_fn

    def half_loss_fn(problem, net, config):
        inner = make(problem, net, config)

        def loss(module, ts, dWs, X0, **kw):
            m = X0.shape[0] // 2
            res = inner(module, ts[:, :m], dWs[:, :m], X0[:m], **kw)
            return res._replace(loss=2.0 * res.loss)  # the mean over the rest

        return loss

    monkeypatch.setattr(trainer, "make_loss_fn", half_loss_fn)
    correct, checks = _run(cell)
    assert not correct, checks


def _served_fault(monkeypatch, fault):
    from dnnpde_tpu_torch.serve import export

    call = export.ServedSolution.u_and_grad_device

    def broken(self, t, X):
        u, Z = call(self, t, X)
        u, Z = u.clone(), Z.clone()
        if fault == "half":
            u[u.shape[0] // 2:] = 0.0
            Z[Z.shape[0] // 2:] = 0.0
        else:  # one answer altered, by 1 % of the largest
            u[0] += 0.01 * u.abs().max()
        return u, Z

    monkeypatch.setattr(export.ServedSolution, "u_and_grad_device", broken)


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_serving_faults(fault, monkeypatch):
    _served_fault(monkeypatch, fault)
    correct, checks = _run("bsb100-serve-greeks")
    assert not correct, checks


@pytest.mark.parametrize("fault", ["half", "altered", "unchanged"])
def test_rollout_faults(fault, monkeypatch):
    from dnnpde_tpu_torch.ops import rollout_kernel

    if fault == "unchanged":  # the path's state is never stepped
        monkeypatch.setattr(rollout_kernel, "philox_normals",
                            lambda seed, M, n, D, device=None: torch.zeros(M, D, device=device))
    else:
        fast = rollout_kernel.predict_paths_fast

        def broken(trainer, M, seed=0):
            Y = fast(trainer, M, seed).clone()
            if fault == "half":
                Y[M // 2:] = 0.0
            else:  # one answer altered, by 20 % of the largest: past bf16's rounding
                Y[0, 1] += 0.2 * Y.abs().max()
            return Y

        monkeypatch.setattr(rollout_kernel, "predict_paths_fast", broken)
    correct, checks = _run("bsb100-rollout-m16384")
    assert not correct, checks


@pytest.mark.cuda
def test_a_cell_on_the_card(card, tmp_path):
    """One short run and one traced run of the flagship on the card."""
    import json
    import subprocess
    import sys

    for trace in ("0", "1"):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "bsb100-train-m100",
             "--seed", "2147483659", "--seconds", "2", "--trace", trace],
            capture_output=True, text=True, cwd=specs.ROOT, timeout=600, check=True)
        result = json.loads(out.stdout.splitlines()[-1])
        assert result["correct"] and result["device"]["platform"] == "gpu"
        assert result["metrics"]


@pytest.mark.parametrize("cell", TRAIN)
def test_the_checked_steps_run_on_the_windows_chunk(cell):
    """Set-up's checked steps and the window's chunks are one chunk: the one
    graph that is checked is the one that is timed."""
    w, cfg, mix = _small(cell)
    d = driver(mix)
    state = d.setup(cfg, mix, 2**31 + 5, torch.device("cpu"))
    assert state.chunk.capacity == mix["chunk"] and d.window_chunk_kept(state)
    d.window(state, 0.1)
    assert d.window_chunk_kept(state)
    assert list(state.trainer._chunk_cache.values()) == [state.chunk]
