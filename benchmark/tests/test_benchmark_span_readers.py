"""The readers of the program's own spans and counters
(``dnnpde_tpu_torch.tracing``): None where the program has no tracing module
(an older commit) or kept no span of their kind, the expected ratio on a
made-up store, and the same ratio when the window was traced twice."""

import sys

import pytest

from benchmark.core import spec as specs

READERS = ("train_launch_ms_per_it", "train_overhead_ms_per_chunk", "train_graph_captures",
           "serve_request_host_ms", "rollout_request_host_ms", "rollout_prepare_ms")
MS = 1_000_000  # ns


def _span(name, start_ms, end_ms, parent=-1, **ids):
    from dnnpde_tpu_torch.tracing import Span

    return Span(name, int(start_ms * MS), int(end_ms * MS), parent, ids)


def _window(base=0):
    """One traced window of each kind: a ``train`` call of two chunks (the
    first a capture and 3 replays, the second 4 replays), two served requests
    and two rollouts; ``base`` offsets the indices of a second window."""
    p = lambda i: base + i  # noqa: E731
    return [
        _span("dnnpde.train", 0, 30, it=0, n_iter=8),                       # 0
        _span("dnnpde.train.chunk", 1, 12, p(0), it=0, k=4),                # 1
        _span("dnnpde.train.capture", 2, 5, p(1), it=0),                    # 2
        _span("dnnpde.train.replay", 5, 8, p(1), replays=3),                # 3
        _span("dnnpde.train.read_out", 9, 10, p(1), it=0),                  # 4
        _span("dnnpde.train.chunk", 12, 20, p(0), it=4, k=4),               # 5
        _span("dnnpde.train.replay", 13, 17, p(5), replays=4),              # 6
        _span("dnnpde.train.read_out", 17, 18, p(5), it=4),                 # 7
        _span("dnnpde.train.drain", 20, 28, p(0), it=0),                    # 8
        _span("dnnpde.train.wait", 20, 26, p(8), it=0),                     # 9
        _span("dnnpde.serve.request", 40, 41, request=0, rows=8),           # 10
        _span("dnnpde.serve.graph", 40.5, 41, p(10)),                       # 11
        _span("dnnpde.serve.request", 42, 45, request=1, rows=9),           # 12
        _span("dnnpde.rollout.request", 50, 50.5, request=0, M=4),          # 13
        _span("dnnpde.rollout.prepare", 50, 50.25, p(13)),                  # 14
        _span("dnnpde.rollout.request", 51, 51.25, request=1, M=4),         # 15
        _span("dnnpde.rollout.prepare", 51, 51.15, p(15)),                  # 16
    ]


# train: 7 ms of replays over 7 replays; 30 ms less replays 7, capture 3 and
# wait 6 over 2 chunks; serving 2 ms; rollout 0.375 ms, prepare 0.2 ms
EXPECTED = {"train_launch_ms_per_it": 1.0, "train_overhead_ms_per_chunk": 7.0,
            "train_graph_captures": 1, "serve_request_host_ms": 2.0,
            "rollout_request_host_ms": 0.375, "rollout_prepare_ms": 0.2}


@pytest.fixture
def store(monkeypatch):
    import dnnpde_tpu_torch.tracing as tracing

    kept = {"spans": [], "counters": {}}
    monkeypatch.setattr(tracing, "spans", lambda: list(kept["spans"]))
    monkeypatch.setattr(tracing, "counters", lambda: dict(kept["counters"]))
    return kept


@pytest.mark.parametrize("name", READERS)
def test_an_empty_store_reads_none(store, name):
    store["counters"]["train.graph_captures"] = 1
    assert specs.reader(name)(None) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_tracing_reads_none(store, monkeypatch, name):
    store["spans"] = _window()
    monkeypatch.setitem(sys.modules, "dnnpde_tpu_torch.tracing", None)  # import fails
    assert specs.reader(name)(None) is None


@pytest.mark.parametrize("name", READERS)
def test_the_ratio_of_one_window_and_of_a_window_traced_again(store, name):
    store["spans"] = _window()
    store["counters"]["train.graph_captures"] = 1
    read = specs.reader(name)
    assert read(None) == pytest.approx(EXPECTED[name])
    store["spans"] = _window() + _window(base=len(_window()))
    assert read(None) == pytest.approx(EXPECTED[name])


def test_open_spans_and_other_kinds_are_not_read(store):
    store["spans"] = [_span("dnnpde.serve.request", 0, 1, request=0, rows=1)._replace(end_ns=None),
                      _span("dnnpde.rollout.request", 0, 1, request=0, M=1)]
    assert specs.reader("serve_request_host_ms")(None) is None
    assert specs.reader("train_graph_captures")(None) is None
    assert specs.reader("rollout_request_host_ms")(None) == pytest.approx(1.0)
