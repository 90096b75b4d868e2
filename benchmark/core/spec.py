"""Where the benchmark's data lives, and how a cell's pieces are found by
name: ``BENCHMARK.json`` at the checkout's root; ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json`` and
``metrics/<metric>.py`` under ``benchmark/``."""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def data(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def metrics_of(spec: dict, section: str, cell: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def sub_seed(seed: int, tag: str) -> int:
    """A 62-bit seed for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 2
