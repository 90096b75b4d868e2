"""``dnnpde_tpu_torch.bench.run`` and ``scripts/anneal_20k.py``'s ``anneal``
on the CPU at a tiny size: the bench's line has ``bench.py``'s keys, for both
paths, with finite positive rates; the anneal runs its four phases."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

from dnnpde_tpu_torch import bench


def test_bench_prints_bench_py_line_at_a_tiny_size():
    line = json.loads(json.dumps(bench.run(dim=3, steps=2, width=8, scale=0.002, device="cpu")))
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert line["metric"] == "bsb100d_train_iters_per_sec" and line["value"] > 0
    extra = line["extra"]
    for prefix in ("", "kernel_"):
        for row in ("m512", "m2048"):
            assert extra[f"{prefix}{row}_iters_per_sec"] > 0
            assert np.isclose(extra[f"{prefix}{row}_path_steps_per_sec"],
                              extra[f"{prefix}{row}_iters_per_sec"] * int(row[1:]) * 2)
        runs = extra[f"{prefix}m2048_runs_iters_per_sec"]
        assert len(runs) == 3 and extra[f"{prefix}m2048_iters_per_sec"] == sorted(runs)[1]
        assert len(extra["spread"][f"{prefix}m100_chunks_iters_per_sec"]) == 3
    assert extra["kernel_iters_per_sec"] > 0 and extra["m2048_bf16_iters_per_sec"] > 0
    assert np.isfinite(line["vs_baseline"]) and extra["device"] == "cpu"
    assert extra["vs_reference_style_on_card"] is None


def test_anneal_runs_the_four_phases_at_a_tiny_size():
    path = Path(__file__).resolve().parents[1] / "scripts" / "anneal_20k.py"
    spec = importlib.util.spec_from_file_location("anneal_20k", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = json.loads(json.dumps(module.anneal(dim=3, width=16, M=8, N=4, scale=0.02,
                                              device="cpu")))
    assert out["phases"] == [[100, 1e-3], [100, 1e-4], [100, 1e-5], [100, 1e-6]]
    assert out["iterations"] == 400 and len(out["y0_at_phase_ends"]) == 4
    assert np.isfinite(out["learned_y0"]) and out["it_per_s"] > 0
