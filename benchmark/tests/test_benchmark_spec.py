"""Every cell, configuration, traffic mix, limit file and metric reader is
found as data by the names in BENCHMARK.json, and the file keeps to the
benchmark's contract."""

import json
import re

import pytest

from benchmark.core import spec as specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = specs.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["per_layer"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((specs.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (specs.ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for entry in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in seen
        seen.add(entry["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    w = specs.workload(SPEC, cell)
    cfg = specs.data("configs", w["config"])
    mix = specs.data("traffic", w["traffic"])
    limits = specs.data("limits", cell)
    assert cfg["name"] == w["config"]
    assert (specs.HERE / "reference" / f"{cfg['reference']['module']}.py").is_file()
    assert mix["driver"] in ("train", "serve", "rollout")
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in specs.metrics_of(SPEC, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert specs.metrics_of(SPEC, "per_layer", cell)


@pytest.mark.parametrize("name", METRICS)
def test_every_per_layer_metric_has_a_reader(name):
    assert callable(specs.reader(name))


def test_config_files_are_their_names():
    for c in SPEC["configs"]:
        with open(specs.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_sub_seeds_differ_by_tag_and_fit_a_generator():
    a, b = specs.sub_seed(2**31 + 7, "weights"), specs.sub_seed(2**31 + 7, "feed")
    assert a != b and 0 <= a < 2**62 and specs.sub_seed(2**31 + 7, "weights") == a
