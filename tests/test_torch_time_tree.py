"""``scripts/time_tree.py``'s basket mode on the CPU at a small size: one
basket training on the K1 + K2 path (their plain versions here) per seed,
with the layers, batch, steps and iterations of the tree's ``chip_smoke``."""

from __future__ import annotations

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _time_tree():
    spec = importlib.util.spec_from_file_location("time_tree", ROOT / "scripts" / "time_tree.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_basket_falls_trains_one_run_per_seed():
    settings = types.SimpleNamespace(D=4, TRAIN_M=8, N_STEPS=4, LAYERS=[5, 16, 16, 1],
                                     TRAIN_ITERS=20, TRAIN_LOG_EVERY=10)
    runs = _time_tree().basket_falls(settings, torch.device("cpu"), range(1, 3))
    assert sorted(runs) == [1, 2]
    for run in runs.values():
        assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
        assert run["fall"] == pytest.approx(run["losses"][0] / run["losses"][-1], rel=1e-6)
        assert np.isfinite(run["y0"])
    assert runs[1]["losses"] != runs[2]["losses"]  # the seed reaches the trainer
