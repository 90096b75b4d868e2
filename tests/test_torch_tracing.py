"""The port's spans and counters (``dnnpde_tpu_torch/tracing.py``) on the
CPU: with no profiler a span is one shared no-op that reads no clock and
keeps nothing, while counters count; under ``profile_trace`` the trainer's
chunk boundaries, the served requests and the rollouts land in the Chrome
trace as ``user_annotation`` ranges and in the in-memory store with the same
nesting, on the same clock; the trainer's and the replica program's
counters count their eager iterations, and the kernel wrappers' counters
stay at 0 on the CPU."""

from __future__ import annotations

import json
import statistics
import time
import tracemalloc

import pytest
import torch

from dnnpde_tpu_torch import tracing
from dnnpde_tpu_torch.nets import MLP
from dnnpde_tpu_torch.ops.rollout_kernel import predict_paths_fast
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.serve import export_solution, load_solution
from dnnpde_tpu_torch.train import ReplicaProgram, Trainer, profile_trace

KERNELS = ("mlp_u_z_fwd", "mlp_u_z_bwd", "rollout_paths", "gbm_terminal")
TRAIN_SPANS = ("dnnpde.train", "dnnpde.train.chunk", "dnnpde.train.eager",
               "dnnpde.train.read_out", "dnnpde.train.drain", "dnnpde.train.wait")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _trainer(D=3, N=4, M=8):
    return Trainer(BlackScholesBarenblatt(D=D), M=M, N=N, layers=[D + 1, 16, 16, 1],
                   seed=3, device="cpu")


def _traced(tmp_path, work):
    """Run ``work`` under ``profile_trace``; returns (the kept spans, the
    Chrome trace's ``user_annotation`` events, its ``baseTimeNanoseconds``)."""
    with profile_trace(str(tmp_path)):
        work()
    (path,) = tmp_path.glob("*.pt.trace.json")
    trace = json.loads(path.read_text())
    events = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"
              and e.get("ph") == "X" and str(e.get("name", "")).startswith("dnnpde.")]
    return tracing.spans(), events, int(trace["baseTimeNanoseconds"])


def _pairs(spans, events):
    """Each kept span with its Chrome event: the i-th of a name with the i-th."""
    out = {}
    for name in {s.name for s in spans}:
        kept = [i for i, s in enumerate(spans) if s.name == name]
        seen = sorted((e for e in events if e["name"] == name), key=lambda e: float(e["ts"]))
        assert len(kept) == len(seen), name
        out.update(zip(kept, seen))
    return out


def _children(spans, parent: int) -> list[str]:
    return [s.name for s in spans if s.parent == parent]


def test_without_a_profiler_a_span_is_one_shared_no_op(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(time, "time_ns", no_clock)
    first = tracing.span("dnnpde.serve.request", request=0, rows=5)
    assert tracing.span("dnnpde.train") is first
    with first, tracing.span("dnnpde.train.chunk", it=0, k=2):
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for i in range(10_000):
            with tracing.span("dnnpde.rollout.request", request=i, M=4):
                pass
        kept = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert kept < 1024  # 10 000 kept records would hold hundreds of KiB
    assert tracing.spans() == []
    tracing.count("ops.nvcc_builds")
    tracing.count("ops.nvcc_builds", 2)
    assert tracing.counters() == {"ops.nvcc_builds": 3}


def test_counters_are_a_copy_and_clear_sets_them_to_zero():
    tracing.count("train.graph_replays", 5)
    got = tracing.counters()
    got["train.graph_replays"] = 0
    assert tracing.counters() == {"train.graph_replays": 5}
    tracing.clear()
    assert tracing.counters() == {} and tracing.spans() == []


def test_a_full_store_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            with tracing.span("dnnpde.rollout.request", request=i, M=1):
                pass
    assert [s.ids["request"] for s in tracing.spans()] == [0, 1, 2]
    assert tracing.counters()["tracing.spans_dropped"] == 2


def test_training_spans_land_in_the_trace_and_the_store(tmp_path):
    tr = _trainer()
    spans, events, base = _traced(tmp_path, lambda: tr.train(3, 1e-3, log_every=2, verbose=False))
    assert {e["name"] for e in events} == set(TRAIN_SPANS)
    names = [s.name for s in spans]
    assert sorted(names) == sorted(["dnnpde.train"] + 2 * list(TRAIN_SPANS[1:]))
    (train,) = [i for i, s in enumerate(spans) if s.name == "dnnpde.train"]
    assert spans[train].ids == {"it": 0, "n_iter": 3} and spans[train].parent == -1
    chunks = [i for i, s in enumerate(spans) if s.name == "dnnpde.train.chunk"]
    assert [spans[i].ids for i in chunks] == [{"it": 0, "k": 2}, {"it": 2, "k": 1}]
    for i, k in zip(chunks, (2, 1)):
        assert spans[i].parent == train
        assert _children(spans, i) == ["dnnpde.train.eager", "dnnpde.train.read_out"]
        (eager,) = [s for s in spans if s.parent == i and s.name == "dnnpde.train.eager"]
        assert eager.ids == {"iterations": k}
    drains = [i for i, s in enumerate(spans) if s.name == "dnnpde.train.drain"]
    assert [spans[i].ids for i in drains] == [{"it": 0}, {"it": 2}]
    for i in drains:
        assert spans[i].parent == train and _children(spans, i) == ["dnnpde.train.wait"]
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)

    pairs = _pairs(spans, events)
    offsets = [abs(float(e["ts"]) * 1e3 + base - spans[i].start_ns) for i, e in pairs.items()]
    assert statistics.median(offsets) < 50e3  # ns
    for i, e in pairs.items():  # the store's nesting is the trace's
        p = spans[i].parent
        if p >= 0:
            q = pairs[p]
            assert float(q["ts"]) <= float(e["ts"])
            assert float(e["ts"]) + float(e["dur"]) <= float(q["ts"]) + float(q["dur"])


@pytest.mark.parametrize("n_iter, log_every", [(3, 2), (5, 5)])
def test_the_trainer_counts_its_eager_iterations_and_no_kernel_call(n_iter, log_every):
    before = tracing.counters()
    _trainer().train(n_iter, 1e-3, log_every=log_every, verbose=False)
    after = tracing.counters()
    assert after.get("train.eager_iterations", 0) - before.get("train.eager_iterations", 0) \
        == n_iter
    for name in ("train.graph_captures", "train.graph_replays",
                 *(f"ops.{k}.calls" for k in KERNELS)):
        assert after.get(name, 0) == before.get(name, 0) == 0, name


def test_a_replica_run_counts_and_traces_its_eager_iterations(tmp_path):
    D = 3
    prog = ReplicaProgram(BlackScholesBarenblatt(D=D), (0, 1), M=8, N=4,
                          layers=[D + 1, 16, 16, 1], capacity=3, device="cpu")
    prog.new_phase(1e-3)
    before = tracing.counters()
    spans, _, _ = _traced(tmp_path, lambda: prog.run(3))
    after = tracing.counters()
    assert after.get("train.eager_iterations", 0) - before.get("train.eager_iterations", 0) == 3
    for name in ("train.graph_captures", "train.graph_replays"):
        assert after.get(name, 0) == before.get(name, 0) == 0, name
    assert [(s.name, s.ids) for s in spans] == [("dnnpde.train.eager", {"iterations": 3})]


def test_served_requests_are_numbered_with_their_rows(tmp_path):
    D = 3
    net = MLP([D + 1, 16, 16, 1], "sine", generator=torch.Generator().manual_seed(0),
              device="cpu")
    (tmp_path / "a").mkdir()
    path = tmp_path / "a" / "s.pt2"
    sol = {}

    def export_and_load():
        path.write_bytes(export_solution(net, D))
        sol["s"] = load_solution(str(path), device="cpu")

    spans, events, _ = _traced(tmp_path / "export", export_and_load)
    assert [s.name for s in spans] == ["dnnpde.serve.export", "dnnpde.serve.load"]
    tracing.clear()
    rows = [5, 1, 12]
    X = torch.rand(max(rows), D) + 0.5

    def serve():
        for b in rows:
            sol["s"].u_and_grad_device(torch.rand(b, 1), X[:b])
        sol["s"].u_and_grad_device(0.5, X[0].numpy())  # a scalar t, one state as a vector

    spans, events, _ = _traced(tmp_path / "serve", serve)
    requests = [i for i, s in enumerate(spans) if s.name == "dnnpde.serve.request"]
    assert [spans[i].ids for i in requests] == [{"request": n, "rows": b}
                                                for n, b in enumerate(rows + [1])]
    assert _children(spans, requests[0]) == ["dnnpde.serve.inputs", "dnnpde.serve.graph"]
    (graph,) = [i for i, s in enumerate(spans) if s.parent == requests[0]
                and s.name == "dnnpde.serve.graph"]
    assert _children(spans, graph) == ["dnnpde.serve.fold"]  # the first request builds it
    for i in requests[1:]:
        assert _children(spans, i) == ["dnnpde.serve.inputs", "dnnpde.serve.graph"]
    assert len(_pairs(spans, events)) == len(spans)


def test_a_rollout_request_holds_its_prepare_and_launch(tmp_path):
    tr = _trainer()
    spans, events, _ = _traced(tmp_path, lambda: [predict_paths_fast(tr, M=6, seed=s)
                                                  for s in range(2)])
    requests = [i for i, s in enumerate(spans) if s.name == "dnnpde.rollout.request"]
    assert len(requests) == 2 and [spans[i].ids["M"] for i in requests] == [6, 6]
    first = spans[requests[0]].ids["request"]
    assert spans[requests[1]].ids["request"] == first + 1
    for i in requests:
        assert _children(spans, i) == ["dnnpde.rollout.prepare", "dnnpde.rollout.launch"]
    assert len(_pairs(spans, events)) == len(spans)
    assert tracing.counters().get("ops.rollout_paths.calls", 0) == 0


def _nais_trainer(fused, D=3, N=4, M=8):
    from dnnpde_tpu_torch.pde import BasketCallOption
    from dnnpde_tpu_torch.solver import SolverConfig

    return Trainer(BasketCallOption(D=D), M=M, N=N, layers=[D + 1, 16, 16, 16, 1],
                   mode="Naisnet", activation="Sine", seed=3, device="cpu",
                   solver_config=SolverConfig(fused_net_u=fused, remat=False))


@pytest.mark.parametrize("fused", ["torch", "cuda"])
def test_the_nais_projection_is_one_span_a_loss(tmp_path, fused):
    """The fused NAIS-Net's projections run once a loss, under
    ``dnnpde.nets.nais_project``: one span an iteration, inside the chunk's
    eager iterations; none without a profiler. On the CPU the kernels' NAIS
    counters stay at 0 (their plain versions run)."""
    tr = _nais_trainer(fused)
    before = tracing.counters()
    tr.train(2, 1e-3, log_every=2, verbose=False)
    assert tracing.spans() == []
    spans, events, _ = _traced(tmp_path, lambda: tr.train(3, 1e-3, log_every=3, verbose=False))
    projections = [s for s in spans if s.name == "dnnpde.nets.nais_project"]
    assert len(projections) == 3
    assert sum(e["name"] == "dnnpde.nets.nais_project" for e in events) == 3
    (eager,) = [i for i, s in enumerate(spans) if s.name == "dnnpde.train.eager"]
    assert all(s.parent == eager for s in projections)
    after = tracing.counters()
    for name in ("ops.mlp_u_z_fwd.nais_calls", "ops.mlp_u_z_bwd.nais_calls"):
        assert after.get(name, 0) == before.get(name, 0) == 0, name


@pytest.mark.cuda
def test_the_nais_counters_count_a_captured_iteration_and_no_replay():
    """On the card a chunk of k iterations calls each NAIS wrapper N + 1
    times in its eager warm-up and N + 1 in its capture, and not in its
    k − 1 replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from dnnpde_tpu_torch.pde import BasketCallOption
    from dnnpde_tpu_torch.solver import SolverConfig

    N, k = 4, 5
    tr = Trainer(BasketCallOption(D=3), M=8, N=N, layers=[4, 16, 16, 16, 1], mode="Naisnet",
                 activation="Sine", seed=3, device="cuda",
                 solver_config=SolverConfig(fused_net_u="cuda", remat=False))
    names = [f"ops.{kern}.{c}" for kern in ("mlp_u_z_fwd", "mlp_u_z_bwd")
             for c in ("calls", "nais_calls")] + ["train.graph_captures", "train.graph_replays"]
    before = tracing.counters()
    tr.train(k, 1e-3, log_every=k, verbose=False)
    torch.cuda.synchronize()
    after = tracing.counters()
    assert [after.get(n, 0) - before.get(n, 0) for n in names] == [2 * (N + 1)] * 4 + [1, k - 1]
