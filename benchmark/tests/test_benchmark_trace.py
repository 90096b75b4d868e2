"""The reading of a trace: the window, device intervals and their union,
kernels by name, the idle gaps and what the host did in them, and the
readers that use them."""

from types import SimpleNamespace

import pytest

from benchmark.core import spec as specs
from benchmark.core.readers import ShortTrace
from benchmark.core.trace import WINDOW, short_name, summarize


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _k(WINDOW, 100.0, 100.0, "user_annotation"),
    _k(WINDOW, 101.0, 98.0, "gpu_user_annotation"),
    _k("void mlp_u_z_fwd_kernel(float const*, float*)", 90.0, 20.0),  # clipped to 100..110
    _k("void mlp_u_z_bwd_rows(float const*)", 105.0, 10.0),  # overlaps: union 100..115
    _k("ampere_sgemm_64x64_nn", 140.0, 20.0),
    _k("Memcpy DtoH", 170.0, 10.0, "gpu_memcpy"),
    _k("late_kernel", 250.0, 5.0),  # after the window: not read
    _k("cudaStreamSynchronize", 118.0, 20.0, "cuda_runtime"),
    _k("aten::mm", 110.0, 60.0, "cpu_op"),
]


def test_summarize_reads_the_window_only():
    tr = summarize(EVENTS)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((15 + 20 + 10) * 1e-6)
    assert tr.kernel("mlp_u_z_fwd_kernel") == (1, pytest.approx(10e-6))
    assert tr.kernel("late_kernel") == (0, 0)
    assert tr.kernels["gpu_memcpy"][0] == 1
    assert [name for name, _ in tr.device_ops][0] == "ampere_sgemm_64x64_nn"
    # gaps: 115..140 (host in the sync), 180..200, 160..170 (both in aten::mm or nothing)
    assert tr.idle_gaps[0] == ["cudaStreamSynchronize", pytest.approx(25e-6)]
    assert tr.idle_gaps[1] == ["(nothing traced)", pytest.approx(20e-6)]
    assert tr.idle_gaps[2] == ["aten::mm", pytest.approx(10e-6)]


def test_short_kernel_names():
    assert short_name("void mlp_u_z_fwd_kernel(float const*, int)") == "mlp_u_z_fwd_kernel"
    assert short_name("void (anonymous namespace)::rollout_kernel<Tiling<2, 4>, true>"
                      "(float const*)") == "(anonymous namespace)::rollout_kernel<Tiling<2, 4>, true>"


def _run(events, iterations=1, layers=(5, 8, 8, 1), M=4, N=1):
    return SimpleNamespace(cfg={"layers": list(layers), "N": N, "precision": "bf16"},
                           mix={"M": M}, counts={"iterations": iterations, "requests": 1,
                                                 "states": 10},
                           host={}, trace=summarize(events))


def test_rooflines_demand_every_record():
    k1 = specs.reader("k1_roofline")
    ok = [EVENTS[0], _k("mlp_u_z_fwd_kernel", 110.0, 4.0), _k("mlp_u_z_fwd_kernel", 120.0, 4.0)]
    assert 0 < k1(_run(ok)) < 100
    with pytest.raises(ShortTrace, match="expected 2"):
        k1(_run(ok[:2]))
    assert k1(_run([EVENTS[0], _k("other", 110.0, 4.0)])) is None


def test_idle_share_and_aten_time():
    run = _run(EVENTS)
    assert specs.reader("device_idle_share.train")(run) == pytest.approx(55.0)
    # the sgemm and the copy, not the hand kernels
    assert specs.reader("aten_ms_per_it")(run) == pytest.approx(30e-3)


class _FakeDriver:
    """A driver whose traced windows come back short of K1 records ``short`` times."""

    def __init__(self, short):
        self.short, self.windows = short, 0

    def setup(self, cfg, mix, seed, device):
        return SimpleNamespace(host={})

    def traced_window(self, state, traced):
        self.windows += 1
        n = 1 if self.windows <= self.short else 2
        traced.trace = summarize([EVENTS[0]] + [_k("mlp_u_z_fwd_kernel", 110.0 + 5 * i, 4.0)
                                                for i in range(n)])
        return {"iterations": 1, "failed": 0}

    def outputs(self, state):
        return {}

    def inputs(self, cfg, mix, seed, device):
        return {}


@pytest.mark.parametrize("short, ok", [(0, True), (2, True), (3, False)])
def test_a_trace_short_of_records_is_taken_again_then_fails(short, ok, monkeypatch):
    from benchmark.core import runner

    fake = _FakeDriver(short)
    monkeypatch.setattr(runner, "driver", lambda mix: fake)
    monkeypatch.setattr(runner, "Traced", SimpleNamespace)
    monkeypatch.setattr(runner, "check", lambda *a: {"n": {"value": 0.0, "limit": 1.0}})
    spec = {"per_layer": [{"name": "k1_roofline", "unit": "%", "workloads": ["c"]}],
            "end_to_end": []}
    cfg = {"layers": [5, 8, 8, 1], "N": 1, "precision": "bf16"}
    args = (spec, {"name": "c"}, 1, 1.0, True, "cpu", 0.0)
    if ok:
        result, _ = runner.run_cell(*args, cfg=cfg, mix={"M": 4}, limits={"n": 1.0})
        assert "k1_roofline" in result["metrics"] and fake.windows == short + 1
    else:
        with pytest.raises(ShortTrace):
            runner.run_cell(*args, cfg=cfg, mix={"M": 4}, limits={"n": 1.0})
        assert fake.windows == 3
