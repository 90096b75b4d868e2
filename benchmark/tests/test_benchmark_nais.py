"""The NAIS-Net cell (``basket100-nais-train-m100``): its driver at a small
size on the CPU against the plain reference; the check failing the fp8
control and both planted faults under the committed limits, through
``run_cell`` as ``test_benchmark_faults.py`` checks the flagship's; the
reference against the port; and the cell's readers (``k1_nais_roofline``,
``k2_nais_roofline``, ``mfu.train_nais``) on made-up traces, as
``test_benchmark_trace.py`` reads the flagship's."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import reference as ref
from benchmark.calibrate import control_precision
from benchmark.core import spec as specs
from benchmark.core.readers import ShortTrace
from benchmark.core.runner import driver, run_cell
from benchmark.core.trace import WINDOW, summarize
from benchmark.drivers import train_nais
from benchmark.reference import bsde, naisnet, training
from benchmark.roofline import PEAK_FLOPS, bound_s
from benchmark.roofline import nais as rf

SPEC = specs.load_spec()
CELL = "basket100-nais-train-m100"
FULL = [101, 256, 256, 256, 256, 1]


def _small():
    """The cell at the size of ``test_benchmark_faults.py::_small``: two
    blocks of 64, D = 16, N = 8, M = 16, chunks of 4."""
    w = specs.workload(SPEC, CELL)
    cfg, mix = specs.data("configs", w["config"]), specs.data("traffic", w["traffic"])
    cfg["layers"] = [17, 64, 64, 64, 1]
    cfg["N"] = 8
    for part in ("problem", "reference"):
        cfg[part]["args"]["D"] = 16
    mix.update(M=16, chunk=4, trace_iterations=4)
    return w, cfg, mix


def _run(seed: int = 2**31 + 11):
    """One run of the cell at ``_small``'s size, under the committed limits."""
    w, cfg, mix = _small()
    result, checks = run_cell(SPEC, w, seed, 0.2, False, "cpu", time.perf_counter(),
                              cfg=cfg, mix=mix)
    return result["correct"], checks


def test_the_cell_is_declared_as_issued():
    w = specs.workload(SPEC, CELL)
    cfg, mix = specs.data("configs", w["config"]), specs.data("traffic", w["traffic"])
    assert (w["config"], w["traffic"], w["chips"]) == ("basket100-naisnet-sine",
                                                       "train-nais-m100", 1)
    assert cfg["layers"] == FULL and cfg["mode"] == "Naisnet" and cfg["N"] == 50
    assert cfg["solver_config"] == {"fused_net_u": "cuda", "remat": False}
    assert mix == {"driver": "train_nais", "M": 100, "chunk": 100, "check_steps": 3,
                   "trace_iterations": 100}


def test_a_sound_run_is_correct():
    correct, checks = _run()
    assert correct, checks


def test_the_control_reads_above_the_program_seed_by_seed():
    """The fp8 control against the program at the same seeds: above it on
    every compared number, by 15x to 200x at this size, and above the
    committed limit on one at least."""
    w, cfg, mix = _small()
    d = driver(mix)
    limits = specs.data("limits", CELL)
    for seed in (1, 2, 3):
        inp = d.inputs(cfg, mix, seed, "cpu")
        f32 = d.reference(cfg, mix, inp, "f32")
        program = d.compare(d.outputs(d.setup(cfg, mix, seed, torch.device("cpu"))), f32)
        control = d.compare(d.reference(cfg, mix, inp, control_precision(d, cfg)), f32)
        assert all(control[k] > 2.0 * program[k] for k in program), (seed, program, control)
        assert any(control[k] > limits[k] for k in limits), (seed, control, limits)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(seed, monkeypatch):
    """The reference in fp8 in the program's place: the run comes out not
    correct under the committed limits."""
    w, cfg, mix = _small()
    inp = train_nais.inputs(cfg, mix, seed, "cpu")
    control = train_nais.reference(cfg, mix, inp, control_precision(train_nais, cfg))
    monkeypatch.setattr(train_nais, "outputs", lambda state: control)
    correct, checks = _run(seed)
    assert not correct, checks


def test_the_check_takes_the_nearer_reference_run():
    """The f32 reference also runs in the configuration's precision, and a
    program that computes either run reads 0 on every number; the control
    and the faults carry no second run."""
    w, cfg, mix = _small()
    inp = train_nais.inputs(cfg, mix, 4, "cpu")
    f32 = train_nais.reference(cfg, mix, inp, "f32")
    assert "at_precision" not in train_nais.reference(cfg, mix, inp, "f32", fault="half")
    assert "at_precision" not in train_nais.reference(cfg, mix, inp, "fp8")
    low = train_nais.reference(cfg, mix, inp, cfg["precision"])
    assert low["losses"] == f32["at_precision"]["losses"] != f32["losses"]
    for run in (f32, low):
        assert set(train_nais.compare(run, f32).values()) == {0.0}


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from dnnpde_tpu_torch.train import optimizers

    def update(self, grads, state, params):
        return [torch.zeros_like(p) for p in params], state

    monkeypatch.setattr(optimizers.Optimizer, "update", update)
    correct, checks = _run()
    assert not correct and checks["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
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
    correct, checks = _run()
    assert not correct, checks


def test_the_checked_steps_run_on_the_windows_chunk():
    w, cfg, mix = _small()
    d = driver(mix)
    state = d.setup(cfg, mix, 2**31 + 5, torch.device("cpu"))
    assert state.chunk.capacity == mix["chunk"] and d.window_chunk_kept(state)
    d.window(state, 0.1)
    assert list(state.trainer._chunk_cache.values()) == [state.chunk]


def _port_net(layers, seed=5):
    from dnnpde_tpu_torch.nets.networks import build_network

    Ws, bs = train_nais.weights(layers, seed, "cpu")
    net = build_network("Naisnet", layers, "Sine", device="cpu")
    train_nais.load_nais(net, Ws, bs)
    return Ws, bs, net


def test_the_leaves_are_the_ports_parameters_in_order():
    layers = [5, 16, 16, 16, 1]
    Ws, bs, net = _port_net(layers)
    params = list(net.parameters())
    assert [tuple(p.shape) for p in params[0::2]] == [(b, a) for a, b in train_nais.shapes(layers)]
    for p, W in zip(params[0::2], Ws, strict=True):
        assert torch.equal(p.detach(), W.T)


def test_u_and_z_and_the_basket_loss_are_the_ports():
    from dnnpde_tpu_torch.pde import BasketCallOption
    from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn, make_net_u

    D, N, M = 4, 6, 8
    Ws, bs, net = _port_net([D + 1, 16, 16, 16, 1])
    t, X = torch.rand(M, 1), 0.5 + torch.rand(M, D)
    u, Z = naisnet.u_and_z(Ws, bs, t, X, create_graph=False)
    u_p, Z_p = make_net_u(net)(t, X)
    torch.testing.assert_close(u, u_p.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(Z, Z_p.detach(), rtol=1e-6, atol=1e-6)
    problem = ref.problem("basket", {"D": D})
    (dWs, X0), = bsde.draws(11, 1, M, N, D, 1.0, "cpu", x0=problem.x0("cpu"))
    ts = bsde.time_grid(N, 1.0, "cpu")
    ours = training.loss(problem, naisnet.u_and_z, Ws, bs, ts, dWs, X0, "global")
    cfg = SolverConfig(remat=False)
    theirs = make_loss_fn(BasketCallOption(D=D), net, cfg)(
        net, ts.reshape(-1, 1, 1).expand(-1, M, 1), dWs, X0, paths=False).loss
    torch.testing.assert_close(ours, theirs.detach(), rtol=1e-5, atol=0)


def test_the_forward_macs_and_the_iterations_flops():
    assert rf.macs(FULL) == 101 * 256 + 3 * (256 + 101) * 256 + 256 == 300_288
    projections = 3 * 3 * 2 * 256**3
    assert rf.train_nais_flops(FULL, 100, 50) == 12 * 300_288 * 100 * 51 + projections
    assert rf.train_nais_flops(FULL, 100, 50) == pytest.approx(18.38e9 + 0.30e9, rel=1e-3)


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _traced(kernels, iterations=1, layers=(17, 8, 8, 8, 1), M=4, N=1):
    events = [_k(WINDOW, 100.0, 100.0, "user_annotation")] + kernels
    return SimpleNamespace(cfg={"layers": list(layers), "N": N, "precision": "bf16"},
                           mix={"M": M}, counts={"iterations": iterations}, host={},
                           trace=summarize(events))


K1 = "void (anonymous namespace)::mlp_u_z_fwd_nais_kernel(float const*, float*)"
ROWS = "void (anonymous namespace)::mlp_u_z_bwd_rows_nais(float const*)"
WGRAD = "void (anonymous namespace)::mlp_u_z_bwd_wgrad(float const*)"


def test_the_nais_rooflines_read_their_kernels_and_demand_every_record():
    layers, M = (17, 8, 8, 8, 1), 4
    # N = 1: two launches an iteration, 4 µs each of K1, 3 + 1 µs of K2's two
    run = _traced([_k(K1, 110.0, 4.0), _k(K1, 120.0, 4.0), _k(ROWS, 130.0, 3.0),
                   _k(ROWS, 140.0, 3.0), _k(WGRAD, 150.0, 1.0), _k(WGRAD, 160.0, 1.0)])
    k1 = specs.reader("k1_nais_roofline")(run)
    k2 = specs.reader("k2_nais_roofline")(run)
    assert k1 == pytest.approx(100.0 * bound_s(*rf.k1_work(layers, M)) / 4e-6)
    assert k2 == pytest.approx(100.0 * bound_s(*rf.k2_work(layers, M)) / 4e-6)
    with pytest.raises(ShortTrace, match="expected 2"):
        specs.reader("k1_nais_roofline")(_traced([_k(K1, 110.0, 4.0)]))
    # the MLP's K1 is not the NAIS-Net's
    mlp = _traced([_k("void mlp_u_z_fwd_kernel(float const*)", 110.0, 4.0)])
    assert specs.reader("k1_nais_roofline")(mlp) is None
    assert specs.reader("k2_nais_roofline")(mlp) is None


def test_the_nais_mfu_reads_the_window():
    run = _traced([_k(K1, 110.0, 4.0)], iterations=3)
    flops = rf.train_nais_flops([17, 8, 8, 8, 1], 4, 1) * 3
    assert specs.reader("mfu.train_nais")(run) == pytest.approx(
        100.0 * flops / 100e-6 / PEAK_FLOPS["bf16"])
