"""Each plain reference against the port at small sizes on the CPU: the net's
(u, Z), the BSB and Heston losses, Philox and the rollout, and the lower
precisions of the control. The reference itself imports nothing of the
port; only these tests hold the two side by side."""

import torch

from benchmark import reference as ref
from benchmark.drivers.common import load_mlp, weights
from benchmark.reference import bsde, mlp, philox, rollout
from benchmark.reference.precision import round_to


def _net(layers, seed=5):
    from dnnpde_tpu_torch.nets import MLP

    Ws, bs = weights(layers, seed, "cpu")
    net = MLP(layers, "sine", device="cpu")
    load_mlp(net, Ws, bs)
    return Ws, bs, net


def test_u_and_z_is_the_ports_solution():
    from dnnpde_tpu_torch.solver import make_net_u

    Ws, bs, net = _net([5, 16, 16, 1])
    t, X = torch.rand(7, 1), torch.rand(7, 4) + 0.5
    u, Z = mlp.u_and_z(Ws, bs, t, X, create_graph=False)
    u_p, Z_p = make_net_u(net)(t, X)
    torch.testing.assert_close(u, u_p.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(Z, Z_p.detach(), rtol=1e-6, atol=1e-6)


def _port_loss(problem, net, ts, dWs, X0, objective):
    from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn

    cfg = SolverConfig(remat=False, objective=objective)
    M = X0.shape[0]
    ts_m = ts.reshape(-1, 1, 1).expand(-1, M, 1)
    return make_loss_fn(problem, net, cfg)(net, ts_m, dWs, X0, paths=False).loss


def test_bsb_loss_is_the_ports():
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt

    D, N, M = 4, 6, 8
    Ws, bs, net = _net([D + 1, 16, 16, 1])
    problem = ref.problem("bsb", {"D": D})
    (dWs, X0), = bsde.draws(11, 1, M, N, D, 1.0, "cpu", x0=problem.x0("cpu"))
    ts = bsde.time_grid(N, 1.0, "cpu")
    ours = bsde.loss(problem, Ws, bs, ts, dWs, X0, "global")
    theirs = _port_loss(BlackScholesBarenblatt(D=D), net, ts, dWs, X0, "global")
    torch.testing.assert_close(ours, theirs.detach(), rtol=1e-5, atol=0)


def test_heston_local_loss_is_the_ports():
    from dnnpde_tpu_torch.pde import HestonPDE

    N, M = 6, 16
    Ws, bs, net = _net([3, 16, 16, 1])
    problem = ref.problem("heston", {})
    (dWs, X0), = bsde.draws(12, 1, M, N, 2, 1.0, "cpu", {"scale": 0.3}, problem.x0("cpu"))
    ts = bsde.time_grid(N, 1.0, "cpu")
    ours = bsde.loss(problem, Ws, bs, ts, dWs, X0, "local")
    theirs = _port_loss(HestonPDE(), net, ts, dWs, X0, "local")
    torch.testing.assert_close(ours, theirs.detach(), rtol=1e-5, atol=0)


def test_the_feed_is_the_trainers():
    from dnnpde_tpu_torch.pde import HestonPDE
    from dnnpde_tpu_torch.sim import lognormal_x0
    from dnnpde_tpu_torch.train import Trainer

    p = HestonPDE()
    tr = Trainer(p, M=8, N=4, layers=[3, 8, 1], seed=20, device="cpu",
                 x0_sampler=lognormal_x0(p.x0, 0.3), objective="local")
    batches = bsde.draws(21, 2, 8, 4, 2, 1.0, "cpu", {"scale": 0.3}, p.x0)
    for dWs, X0 in batches:
        _, dWs_p, X0_p = tr._batch()
        assert torch.equal(dWs, dWs_p) and torch.equal(X0, X0_p)


def test_philox_is_the_kernels_stream():
    from dnnpde_tpu_torch.ops.rollout_kernel import philox_normals

    seed = 2**33 + 12345
    assert torch.equal(philox.normals(seed, 0, 37, 3, 101, "cpu"),
                       philox_normals(seed, 37, 3, 101))
    assert torch.equal(philox.normals(7, 5, 10, 3, 9, "cpu"), philox_normals(7, 15, 3, 9)[5:])


def test_rollout_in_bf16_is_the_kernels_plain_version():
    from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths_reference

    Ws, bs, _ = _net([9, 16, 16, 1])
    x0 = ref.problem("bsb", {"D": 8}).x0("cpu")
    ours = rollout.paths(Ws, bs, x0, 0.0, 0.4, 5, 1.0, 40, seed=99, precision="bf16", block=16)
    theirs = rollout_paths_reference(Ws, bs, x0, N=5, dt=0.2, mu_c=0.0, sig_c=0.4, seed=99, M=40)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_lower_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -1.0 - 2.0**-11, 3.0e-3])
    t = round_to(x, "tf32")
    assert t[0] == 1.0 and t[1] == 1.0 + 2.0**-9 and t[2] == -1.0  # ties to even
    assert (t[3] - x[3]).abs() <= 2.0**-11 * x[3]
    assert round_to(torch.tensor([1.0 + 2.0**-8]), "bf16")[0] == 1.0
    assert round_to(torch.tensor([1.0625]), "fp8")[0] == 1.0
    assert torch.equal(round_to(x, "f32"), x)
