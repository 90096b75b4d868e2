"""The NAIS-Net on the fused path (``SolverConfig(fused_net_u=...)``)
against the plain reference of the benchmark (``benchmark/reference/
naisnet.py``, f32 from the published equations, importing nothing of the
port), at a small size on seeded weights: the port's autograd ``NaisNet``,
the ``"torch"`` backend (the f32 ``nais_u_z``), and the kernels' plain CPU
versions in their bf16-operand math (``"cuda"`` on CPU tensors), for (u, Z),
one loss and its gradients; each with the blocks' Frobenius clip active and
inactive. The kernels themselves are held to the plain versions on the card
by ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import pytest
import torch

import dnnpde_tpu_torch.ops.mlp_kernel as mk
from benchmark import reference as ref
from benchmark.drivers.train_nais import load_nais, weights
from benchmark.reference import bsde, naisnet, training
from dnnpde_tpu_torch.nets.networks import build_network
from dnnpde_tpu_torch.ops.fused_net_u import fused_u_z
from dnnpde_tpu_torch.params import extract_nais_params
from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn, make_net_u

LAYERS = [5, 16, 16, 16, 16, 1]
D, M, N = 4, 8, 4
DELTA = 1.0 - 2.0 * naisnet.EPS
# the blocks' kernels as drawn (‖KKᵀ‖_F ≈ 5.5 > δ: the clip rescales) and
# scaled by 0.3 (≈ 0.5 < δ: it does not)
CLIPS = {"clip-active": 1.0, "clip-inactive": 0.3}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(clip: str, seed: int = 7):
    """Seeded leaves (``parameters()`` order), the port's net holding them,
    and a batch of (t, X)."""
    Ws, bs = weights(LAYERS, seed, "cpu")
    blocks = len(LAYERS) - 3
    for i in range(1, 1 + blocks):
        Ws[i] = Ws[i] * CLIPS[clip]
        norm = float(torch.linalg.norm(Ws[i] @ Ws[i].T))
        assert (norm > DELTA) == (clip == "clip-active"), norm
    net = build_network("Naisnet", LAYERS, "Sine", device="cpu")
    load_nais(net, Ws, bs)
    gen = torch.Generator().manual_seed(seed)
    t, X = torch.rand(M, 1, generator=gen), 0.5 + torch.rand(M, D, generator=gen)
    return Ws, bs, net, t, X


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("clip", CLIPS)
def test_u_and_z_match_the_plain_reference(clip):
    Ws, bs, net, t, X = _setup(clip)
    u, Z = naisnet.u_and_z(Ws, bs, t, X, create_graph=False)
    u_b, Z_b = naisnet.u_and_z(Ws, bs, t, X, "bf16", create_graph=False)
    # the port's autograd net and the f32 fused form: the same f32 math
    # summed in other orders, a few ulps of the largest value
    u_p, Z_p = make_net_u(net)(t, X)
    Wk, bk = extract_nais_params(net)
    u_t, Z_t = fused_u_z(Wk, bk, t, X, "sine", "torch", nais=True)
    for a, b in ((u_p, u), (Z_p, Z), (u_t, u), (Z_t, Z)):
        assert _rel(a.detach(), b) <= 2e-6
    # the kernels' plain versions round every dot operand to bf16, as the
    # reference's bf16 mode does in its forward products: u from the same
    # rounded operands, the sums in other orders (f32 ulps); Z from the
    # sweep, whose q_k the kernels round where the reference's backward
    # keeps its cotangent unrounded: a bf16 step (2^-8) of a few terms
    u_k, Z_k = fused_u_z([w.detach() for w in Wk], [b.detach() for b in bk], t, X, "sine",
                         "cuda", nais=True)
    assert _rel(u_k, u_b) <= 1e-5
    assert _rel(Z_k, Z_b) <= 2e-2
    # and against f32: bf16's rounding of each operand (2^-9) through four
    # layers and the head
    assert _rel(u_k, u) <= 3e-2 and _rel(Z_k, Z) <= 3e-2


def _losses(clip: str, backend):
    """(loss, gradients by leaf in ``parameters()`` order) of one batch: the
    port's loss with ``fused_net_u=backend``, and the reference's."""
    from dnnpde_tpu_torch.pde import BasketCallOption

    Ws, bs, net, _, _ = _setup(clip)
    problem = ref.problem("basket", {"D": D})
    (dWs, X0), = bsde.draws(11, 1, M, N, D, 1.0, "cpu", x0=problem.x0("cpu"))
    ts = bsde.time_grid(N, 1.0, "cpu")
    leaves = [p.clone().requires_grad_(True) for pair in zip(Ws, bs) for p in pair]
    theirs = training.loss(problem, naisnet.u_and_z, leaves[0::2], leaves[1::2], ts, dWs, X0,
                           "global")
    their_grads = torch.autograd.grad(theirs, leaves)
    loss_fn = make_loss_fn(BasketCallOption(D=D), net,
                           SolverConfig(fused_net_u=backend, remat=False))
    ours = loss_fn(net, ts.reshape(-1, 1, 1).expand(-1, M, 1), dWs, X0, paths=False).loss
    our_grads = torch.autograd.grad(ours, list(net.parameters()))
    our_grads = [g.t() if g.dim() == 2 else g for g in our_grads]  # to the (in, out) layout
    return (float(ours.detach()), our_grads), (float(theirs.detach()), their_grads)


@pytest.mark.parametrize("backend", [False, "torch", "cuda"])
@pytest.mark.parametrize("clip", CLIPS)
def test_one_loss_and_its_gradients_match_the_plain_reference(clip, backend):
    (loss, grads), (ref_loss, ref_grads) = _losses(clip, backend)
    norms = torch.stack([torch.linalg.vector_norm(g) for g in ref_grads])
    # f32 paths: the same math in other orders (readings: 2e-7); the
    # kernels' plain versions: bf16 dot operands, whose rounding the loss's
    # differences of nearby Y amplify (readings at this size: the loss up to
    # 6e-3, a leaf up to 8e-3 of the largest leaf's norm)
    tol = 2e-2 if backend == "cuda" else 1e-5
    assert abs(loss - ref_loss) <= tol * abs(ref_loss)
    for g, r in zip(grads, ref_grads, strict=True):
        assert g.shape == r.shape
        assert float(torch.linalg.vector_norm(g - r)) <= tol * float(norms.max())


def test_the_hand_derived_backward_is_the_gradient_of_the_plain_forward(monkeypatch):
    """In exact arithmetic (every dot an f64 product) K2's plain version is
    the gradient of <u, u_bar> + <Z, z_bar> for K1's plain version, Z by
    autograd: to f64 round-off."""
    monkeypatch.setattr(mk, "bf16_dot", lambda a, w: a @ w)
    gen = torch.Generator().manual_seed(3)
    n0, H, B = 5, 16, 7
    dt = torch.float64
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=dt)  # noqa: E731
    Ws = [rnd(n0, H) * 0.5] + [mk.nais_block_weight(rnd(n0, H) * 0.5, -0.3 * rnd(H, H))
                               for _ in range(3)] + [rnd(H, 1)]
    bs = [0.1 * rnd(W.shape[1]) for W in Ws]
    x, u_bar, z_bar = rnd(B, n0), rnd(B, 1), rnd(B, n0)
    leaves = [w.clone().requires_grad_(True) for w in (*Ws, *bs)]
    xr = x.clone().requires_grad_(True)

    def net(Ws, bs, x):
        a = torch.sin(x @ Ws[0] + bs[0])
        for k in range(1, len(Ws) - 1):
            a = torch.sin(x @ Ws[k][:n0] + a @ Ws[k][16:] + bs[k]) + a
        return a @ Ws[-1] + bs[-1]

    u = net(leaves[:5], leaves[5:], xr)
    (z,) = torch.autograd.grad(u.sum(), xr, create_graph=True)
    u_k, z_k = mk.mlp_u_z_fwd_reference(Ws, bs, x, nais=True)
    assert float((u_k - u.detach()).abs().max()) < 1e-12
    assert float((z_k - z.detach()).abs().max()) < 1e-12
    grads = torch.autograd.grad((u * u_bar).sum() + (z * z_bar).sum(), [*leaves, xr])
    W_bars, b_bars, x_bar = mk.mlp_u_z_bwd_reference(Ws, bs, x, u_bar, z_bar, nais=True)
    for got, want in zip([*W_bars, *b_bars, x_bar], grads, strict=True):
        assert float((got - want).abs().max()) < 1e-10


def test_the_wrappers_take_only_nais_weights():
    Ws, bs, net, t, X = _setup("clip-active")
    Wk, bk = (tuple(w.detach() for w in ws) for ws in extract_nais_params(net))
    x = torch.cat([t, X], dim=-1)
    assert mk.check_mlp(Wk, bk, x.device, nais=True) == LAYERS
    # K2's row chain on clusters of 16 CTAs at this batch, on one block above the crossover
    assert mk.bwd_takes_cluster(LAYERS, M, nais=True)
    assert not mk.bwd_takes_cluster(LAYERS, mk.NAIS_CLUSTER_MAX_ROWS + 1, nais=True)
    with pytest.raises(ValueError, match="expected"):
        mk.mlp_u_z_fwd(Wk, bk, x)  # the blocks' [U; 0; -A] is no MLP layer
    with pytest.raises(ValueError, match="need 3"):
        mk.mlp_u_z_fwd((Wk[0], Wk[-1]), (bk[0], bk[-1]), x, nais=True)
    from dnnpde_tpu_torch.pde import BasketCallOption

    with pytest.raises(ValueError, match="fused_net_u supports"):
        make_loss_fn(BasketCallOption(D=D),  # a NAIS-Net with no block
                     build_network("Naisnet", [5, 16, 1], "Sine", device="cpu"),
                     SolverConfig(fused_net_u="cuda", remat=False))
