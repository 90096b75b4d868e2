"""What a run loads: nothing whose top-level name is jax, jaxlib, flax or
dnnpde_tpu (the port, dnnpde_tpu_torch, is what runs), and a reference that
loads nothing of the port. And the command refuses to run without a card
or without the program beside it."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.core import spec as specs
from benchmark.core.runner import forbidden_modules


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["dnnpde_tpu_torch", "dnnpde_tpu_torch.train", "jaxtyping",
                              "flaxx", "torch"]) == []
    assert forbidden_modules(["dnnpde_tpu", "dnnpde_tpu.train", "jax.numpy", "jaxlib",
                              "flax.linen"]) == ["dnnpde_tpu", "dnnpde_tpu.train", "flax.linen",
                                                 "jax.numpy", "jaxlib"]


def _modules_after(code: str) -> list[str]:
    """The modules loaded in a fresh interpreter after ``code``."""
    prog = (f"import sys; sys.path.insert(0, {str(specs.ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         check=True, cwd=specs.ROOT, env={**os.environ, "PYTHONNOUSERSITE": "1"})
    return json.loads(out.stdout.splitlines()[-1])


def test_the_runs_module_graph_loads_no_jax():
    code = "\n".join([
        "import benchmark.run, benchmark.calibrate, benchmark.core.runner",
        "from benchmark.core import spec",
        "for d in ('train', 'serve', 'rollout'): __import__('benchmark.drivers.' + d)",
        "for m in spec.load_spec()['per_layer']: spec.reader(m['name'])",
        # what the drivers call in the port
        "import dnnpde_tpu_torch.train, dnnpde_tpu_torch.serve, dnnpde_tpu_torch.nets",
        "import dnnpde_tpu_torch.ops.rollout_kernel, dnnpde_tpu_torch.ops.mlp_kernel",
        "import dnnpde_tpu_torch.sim, dnnpde_tpu_torch.solver, torch.profiler, torch.export",
    ])
    loaded = _modules_after(code)
    assert "dnnpde_tpu_torch.train" in loaded
    assert forbidden_modules(loaded) == []


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules_after("\n".join(
        f"import benchmark.reference.{m}" for m in
        ("bsb", "heston", "bsde", "mlp", "philox", "precision", "rollout")))
    assert not [m for m in loaded if m.split(".")[0] in ("dnnpde_tpu_torch", "dnnpde_tpu")]


def _run(cwd, *extra):
    cmd = [sys.executable, "benchmark/run.py", "--workload", "bsb100-train-m100",
           "--seed", "2147483659", "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=cwd, timeout=300)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(specs.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(specs.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(specs.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
