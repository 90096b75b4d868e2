"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with ``nvcc`` (marker ``cuda``) and skips
without one. The file imports neither JAX nor the JAX package, so on a machine
without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import pytest
import torch

from dnnpde_tpu_torch import tracing
from dnnpde_tpu_torch.ops.fused_net_u import FusedMlpUZ, FusedNaisUZ
from dnnpde_tpu_torch.ops.mlp_kernel import (
    MAX_SMEM,
    NAIS_CLUSTER_MAX_ROWS,
    _bwd_launch,
    _lib,
    bwd_cluster_smem_bytes,
    bwd_takes_cluster,
    check_mlp,
    mlp_u_z_bwd,
    mlp_u_z_bwd_reference,
    mlp_u_z_fwd,
    mlp_u_z_fwd_reference,
)
from dnnpde_tpu_torch.ops.path_kernel import gbm_terminal, gbm_terminal_reference
from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths, rollout_paths_reference
from dnnpde_tpu_torch.sim import cholesky_factor, generate_correlation_matrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
    return torch.device("cuda")


def _calls(kernel: str, path: str = "calls") -> int:
    """The kernel wrapper's calls so far (the ``ops.<kernel>.calls`` counter;
    ``path="cluster_calls"``: those of K2's clustered row chain)."""
    return tracing.counters().get(f"ops.{kernel}.{path}", 0)


def _on(device, arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _assert_kernel_close(actual, plain):
    """Both round dot operands to bf16 but sum in other orders, so a value
    near a bf16 tie may flip and move what follows by about a bf16 step of
    one term: at most 1e-2 of max|plain| anywhere, 1e-4 on average."""
    scale = float(plain.abs().max())
    assert actual.shape == plain.shape and bool(torch.isfinite(actual).all())
    assert float((actual - plain).abs().max()) <= 1e-2 * scale
    assert float((actual - plain).abs().mean()) <= 1e-4 * scale


@pytest.mark.parametrize("B", [1, 37, 300])
def test_k1_matches_plain_version(cuda_device, B):
    rng = np.random.default_rng(5)
    layers = [101, 256, 256, 1]
    Ws = _on(cuda_device, [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
                           for a, b in zip(layers[:-1], layers[1:])])
    bs = _on(cuda_device, [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in layers[1:]])
    (x,) = _on(cuda_device, [rng.normal(size=(B, layers[0])).astype(np.float32)])
    before = _calls("mlp_u_z_fwd")
    u, z = mlp_u_z_fwd(Ws, bs, x)
    torch.cuda.synchronize()
    assert _calls("mlp_u_z_fwd") == before + 1
    u_ref, z_ref = mlp_u_z_fwd_reference(Ws, bs, x)
    _assert_kernel_close(u, u_ref)
    _assert_kernel_close(z, z_ref)


# Ragged widths for K1's tensor-core layers: inputs and hidden widths that are
# not multiples of 16 (zero-padded k rows and n columns in shared memory), a
# 2-wide input as CallOption1D has, and a 300-wide layer that takes two
# 256-column passes in both the forward and the sweep.
RAGGED_NETS = {"7-40-24": [7, 40, 24, 1], "2-16-16": [2, 16, 16, 1], "9-300-40": [9, 300, 40, 1]}


@pytest.mark.parametrize("B", [1, 17, 300, 4096])
@pytest.mark.parametrize("net", list(RAGGED_NETS))
def test_k1_matches_plain_version_at_ragged_widths(cuda_device, net, B):
    layers = RAGGED_NETS[net]
    rng = np.random.default_rng(B + len(net))
    Ws = _on(cuda_device, [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
                           for a, b in zip(layers[:-1], layers[1:])])
    bs = _on(cuda_device, [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in layers[1:]])
    (x,) = _on(cuda_device, [rng.normal(size=(B, layers[0])).astype(np.float32)])
    u, z = mlp_u_z_fwd(Ws, bs, x)
    torch.cuda.synchronize()
    u_ref, z_ref = mlp_u_z_fwd_reference(Ws, bs, x)
    _assert_kernel_close(u, u_ref)
    _assert_kernel_close(z, z_ref)


def test_k1_dots_are_as_close_to_exact_as_sequential_f32(cuda_device):
    """K1's tensor-core dots against the exact sums of the same bf16 products.
    With x = 0 and zero biases, cos p = 1 and K1's Z is the raw sweep dot
    Z_i = sum_j bf16(W1[j]) bf16(W0[i, j]), 256 terms whose magnitudes spread
    over 2^-10 .. 1 with random signs. Its mean error, relative to
    sum_j |term|, must not exceed that of a sequential f32 sum of the same
    (exact) products."""
    rng = np.random.default_rng(3)
    n0, H = 101, 256
    errs = {"k1": [], "sequential": []}
    for _ in range(3):
        W0 = (rng.normal(size=(n0, H)) * np.exp2(rng.uniform(-10, 0, (n0, H)))).astype(np.float32)
        W1 = (rng.normal(size=(H, 1)) * np.exp2(rng.uniform(-10, 0, (H, 1)))).astype(np.float32)
        Ws = _on(cuda_device, [W0, W1])
        bs = [torch.zeros(H, device=cuda_device), torch.zeros(1, device=cuda_device)]
        _, z = mlp_u_z_fwd(Ws, bs, torch.zeros(16, n0, device=cuda_device))
        terms = Ws[0].bfloat16().double() * Ws[1][:, 0].bfloat16().double()
        exact, mag = terms.sum(1), terms.abs().sum(1)
        seq = torch.zeros(n0, dtype=torch.float32, device=cuda_device)
        for j in range(H):
            seq = seq + terms[:, j].float()  # each product is exact in f32
        errs["k1"].append((z[0].double() - exact).abs() / mag)
        errs["sequential"].append((seq.double() - exact).abs() / mag)
    k1, sequential = (float(torch.cat(errs[k]).mean()) for k in ("k1", "sequential"))
    assert k1 <= sequential, (k1, sequential)


def test_k1_rows_do_not_depend_on_their_tile(cuda_device):
    """A row's (u, Z) is the same bit for bit whatever the other rows of its
    16-row tile hold."""
    Ws, bs, x, _, _ = _full_width(cuda_device, 16, seed=4)
    u1, z1 = mlp_u_z_fwd(Ws, bs, x)
    x2 = x.clone()
    x2[1:] *= 100.0
    u2, z2 = mlp_u_z_fwd(Ws, bs, x2)
    assert torch.equal(u1[0], u2[0]) and torch.equal(z1[0], z2[0])


def test_k1_rejects_what_it_does_not_take(cuda_device):
    Ws = [torch.zeros(5, 8, device=cuda_device), torch.zeros(8, 1, device=cuda_device)]
    bs = [torch.zeros(8, device=cuda_device), torch.zeros(1, device=cuda_device)]
    with pytest.raises(ValueError, match="cpu"):
        mlp_u_z_fwd(Ws, bs, torch.zeros(3, 5))  # weights on the card, x on the CPU


@pytest.mark.parametrize("variant", ["dWs", "seed"])
def test_k3_matches_plain_version(cuda_device, variant):
    rng = np.random.default_rng(2)
    D, H, N, M = 100, 256, 6, 300
    Ws = _on(cuda_device, [(0.1 * rng.normal(size=(D + 1, H))).astype(np.float32),
                           (0.05 * rng.normal(size=(H, H))).astype(np.float32),
                           (0.1 * rng.normal(size=(H, 1))).astype(np.float32)])
    bs = _on(cuda_device, [(0.1 * rng.normal(size=(n,))).astype(np.float32) for n in (H, H, 1)])
    (x0,) = _on(cuda_device, [np.tile([1.0, 0.5], D // 2).astype(np.float32)])
    kw = dict(N=N, dt=1.0 / N, mu_c=0.05, sig_c=0.2)
    if variant == "dWs":
        (kw["dWs"],) = _on(cuda_device, [(0.4 * rng.normal(size=(M, N, D))).astype(np.float32)])
    else:
        kw.update(seed=99, M=M)
    before = _calls("rollout_paths")
    y = rollout_paths(Ws, bs, x0, **kw)
    torch.cuda.synchronize()
    assert _calls("rollout_paths") == before + 1
    _assert_kernel_close(y, rollout_paths_reference(Ws, bs, x0, **kw))


def _rollout_net(device, rng, D, H):
    Ws = _on(device, [(0.5 * rng.normal(size=(D + 1, H)) / np.sqrt(D + 1)).astype(np.float32),
                      (rng.normal(size=(H, H)) / np.sqrt(H)).astype(np.float32),
                      (rng.normal(size=(H, 1)) / np.sqrt(H)).astype(np.float32)])
    bs = _on(device, [(0.1 * rng.normal(size=(n,))).astype(np.float32) for n in (H, H, 1)])
    (x0,) = _on(device, [rng.uniform(0.5, 1.5, size=D).astype(np.float32)])
    return Ws, bs, x0


# K3 takes 128 paths a block, or 16 when a net is too wide for a 128-path
# tile in shared memory; M is no multiple of the tile, so the last block is
# ragged. 128-path tiles: D = 1 with H = 40 pads k and n; H = 300 takes two
# column passes. 16-path tiles: H = 400 at D = 1 and H = 512 at D = 100.
@pytest.mark.parametrize("variant", ["dWs", "seed"])
@pytest.mark.parametrize("D, H, M", [(1, 40, 1000), (1, 300, 200), (100, 256, 300),
                                     (1, 400, 37), (100, 512, 50)])
def test_k3_matches_plain_version_at_ragged_tiles(cuda_device, D, H, M, variant):
    rng = np.random.default_rng(D + H)
    Ws, bs, x0 = _rollout_net(cuda_device, rng, D, H)
    N = 5
    kw = dict(N=N, dt=1.0 / N, mu_c=0.05, sig_c=0.2)
    if variant == "dWs":
        (kw["dWs"],) = _on(cuda_device, [(0.4 * rng.normal(size=(M, N, D))).astype(np.float32)])
    else:
        kw.update(seed=7, M=M)
    y = rollout_paths(Ws, bs, x0, **kw)
    torch.cuda.synchronize()
    _assert_kernel_close(y, rollout_paths_reference(Ws, bs, x0, **kw))


def test_k3_rejects_a_net_too_wide_for_shared_memory(cuda_device):
    rng = np.random.default_rng(0)
    Ws, bs, x0 = _rollout_net(cuda_device, rng, 100, 3000)
    with pytest.raises(RuntimeError, match="rollout_paths"):
        rollout_paths(Ws, bs, x0, N=2, dt=0.5, mu_c=0.0, sig_c=0.2, seed=1, M=256)


FULL = [101, 256, 256, 256, 256, 1]


def _full_width(device, B, seed):
    rng = np.random.default_rng(seed)
    Ws = _on(device, [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
                      for a, b in zip(FULL[:-1], FULL[1:])])
    bs = _on(device, [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in FULL[1:]])
    x, u_bar, z_bar = _on(device, [rng.normal(size=s).astype(np.float32)
                                   for s in ((B, FULL[0]), (B, 1), (B, FULL[0]))])
    return Ws, bs, x, u_bar, z_bar


def _check_k2(Ws, bs, x, u_bar, z_bar, plain=True):
    """K2 through its wrapper, twice: close to the plain version (unless
    ``plain`` is false), the same bits both times, one ``cluster_calls`` a
    call where the wrapper takes the clustered row chain; and, where that
    chain fits the shape at any B, its bits through its C entry point equal
    the one-block row chain's through its own, and the C side's shared
    memory for it is the wrapper's. Returns whether the wrapper took the
    clustered row chain."""
    widths = check_mlp(Ws, bs, x.device)
    clustered = bwd_takes_cluster(widths, x.shape[0])
    before = (_calls("mlp_u_z_bwd"), _calls("mlp_u_z_bwd", "cluster_calls"))
    out = mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar)
    again = mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar)
    tiles = _bwd_launch("mlp_u_z_bwd", Ws, bs, x, u_bar, z_bar, widths)
    fits = bwd_cluster_smem_bytes(widths) <= MAX_SMEM
    chain = _bwd_launch("mlp_u_z_bwd_cluster", Ws, bs, x, u_bar, z_bar, widths) if fits else tiles
    torch.cuda.synchronize()
    assert (_calls("mlp_u_z_bwd"), _calls("mlp_u_z_bwd", "cluster_calls")) == (
        before[0] + 2, before[1] + 2 * clustered)
    smem = _lib("mlp_u_z_bwd").mlp_u_z_bwd_cluster_smem_bytes(
        (ctypes.c_int * len(widths))(*widths), len(Ws))
    assert smem == bwd_cluster_smem_bytes(widths)
    ref = mlp_u_z_bwd_reference(Ws, bs, x, u_bar, z_bar)
    for a, r, b, t, c in zip(*([*o[0], *o[1], o[2]] for o in (out, ref, again, tiles, chain))):
        if plain:
            _assert_kernel_close(a, r)
        # every sum in a fixed order, no atomics: no run-to-run change; and
        # both row chains sum every output in the same order
        assert torch.equal(a, b)
        assert torch.equal(a, t)
        assert torch.equal(c, t)
    return clustered


@pytest.mark.parametrize("B", [1, 17, 100, 129, 2048])
def test_k2_matches_plain_version_and_repeats_bitwise(cuda_device, B):
    # B = 129 (two row chains, one 1-row tile) is held to the one-block row
    # chain's bits only: on its inputs both chains, bit for bit alike, sit at
    # a mean of 1.16e-4 of max|plain| from the plain version in one bias
    # gradient, above _assert_kernel_close's 1e-4
    clustered = _check_k2(*_full_width(cuda_device, B, seed=B), plain=B != 129)
    assert clustered or B > 100  # the flagship's batch runs on clusters


# K2's row chain and weight-gradient kernel at ragged shapes: full width at a
# batch that is no multiple of its 16-row tile, and K1's ragged nets, whose
# inputs and hidden widths are no multiple of the gradient's 32 x 64 tiles
# (9-300-40's 300-wide layer also takes two passes of the one-block row
# chain's layers, and on a cluster its 38 tiles of 8 columns fill five CTAs'
# slices of 8 tiles, the last partly).
K2_RAGGED = [("full", 300)] + [
    (net, B) for net in RAGGED_NETS for B in (1, 17, 100, 300, 2048)
]


@pytest.mark.parametrize("net, B", K2_RAGGED)
def test_k2_matches_plain_version_and_repeats_bitwise_at_ragged_shapes(cuda_device, net, B):
    layers = FULL if net == "full" else RAGGED_NETS[net]
    rng = np.random.default_rng(B + len(net))
    Ws = _on(cuda_device, [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
                           for a, b in zip(layers[:-1], layers[1:])])
    bs = _on(cuda_device, [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in layers[1:]])
    x, u_bar, z_bar = _on(cuda_device, [rng.normal(size=s).astype(np.float32)
                                        for s in ((B, layers[0]), (B, 1), (B, layers[0]))])
    _check_k2(Ws, bs, x, u_bar, z_bar)


def test_k2_recomputes_k1s_forward_exactly(cuda_device):
    """K2 differentiates the forward that K1 ran, not a neighbour of it. With
    u_bar the one-hot of row r and z_bar = 0, K2's gradient of the head is the
    last hidden activation it recomputed for row r, bf16(sin p), exactly; K1's
    u[r] is the head over the activation K1 computed. The two agree to the f32
    rounding of K1's 256-term head sum (under 1e-6 of its terms' magnitude)
    only if every activation is equal: where the two sum a layer in other
    orders, bf16 roundings flip, and each flip moves u[r] by about 2^-8 of
    one term, some 1e-5 of the sum."""
    B = 64
    Ws, bs, x, _, _ = _full_width(cuda_device, B, seed=11)
    u, _ = mlp_u_z_fwd(Ws, bs, x)
    w_head = Ws[-1][:, 0].to(torch.bfloat16).double()
    z_bar = torch.zeros_like(x)
    clustered = _calls("mlp_u_z_bwd", "cluster_calls")
    for r in range(B):
        u_bar = torch.zeros(B, 1, device=cuda_device)
        u_bar[r] = 1.0
        W_bars, _, _ = mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar)
        a = W_bars[-1][:, 0]
        assert torch.equal(a, a.to(torch.bfloat16).float())
        terms = a.double() * w_head
        u_r = float(terms.sum()) + float(bs[-1][0])
        scale = float(terms.abs().sum()) + abs(float(bs[-1][0]))
        assert abs(float(u[r, 0]) - u_r) <= 1e-6 * scale, f"row {r}"
    assert _calls("mlp_u_z_bwd", "cluster_calls") == clustered + B  # on the clustered row chain


def test_fused_function_gradients_match_plain_function(cuda_device):
    """FusedMlpUZ on the card (K1 + K2) against the same Function on the
    CPU (the two plain versions), through a loss that feeds Z back in."""
    Ws, bs, x, _, _ = _full_width(cuda_device, 64, seed=9)

    def grads(device):
        wb = [t.detach().to(device).requires_grad_(True) for t in (*Ws, *bs)]
        x_d = x.detach().to(device).requires_grad_(True)
        u, z = FusedMlpUZ.apply(x_d, *wb)
        u2, z2 = FusedMlpUZ.apply((x_d + 0.1 * z).contiguous(), *wb)
        loss = (u2 * u).sum() + (z2 * z).sum()
        return [g.cpu() for g in torch.autograd.grad(loss, [x_d, *wb])]

    before = (_calls("mlp_u_z_fwd"), _calls("mlp_u_z_bwd"))
    on_card = grads(cuda_device)
    torch.cuda.synchronize()
    assert (_calls("mlp_u_z_fwd"), _calls("mlp_u_z_bwd")) == (before[0] + 2, before[1] + 2)
    for a, r in zip(on_card, grads("cpu")):
        _assert_kernel_close(a, r)


# K4 against its plain version, value by value: both draw the same Philox
# stream and sum and correlate in the same order; the kernel takes the SFU's
# log2, sqrt, sin, cos and exp where the plain version takes PyTorch's accurate
# ones (~1e-6 of a value over a 50-term sum, csrc/gbm_terminal.cu). 1e-5 of
# each value leaves room for that; one wrong normal moves a value by about
# σ√dt ≈ 3e-2.
K4_RTOL = 1e-5


def _k4_case(D, correlated, M, N, seed=2024):
    rng = np.random.default_rng(D)
    S0 = rng.uniform(0.5, 1.5, size=D).astype(np.float32)
    sigma = rng.uniform(0.1, 0.4, size=D).astype(np.float32)
    chol = None
    if correlated:
        chol = cholesky_factor(generate_correlation_matrix(D, "random_correlation", seed=D))
    return (seed, S0, 0.05, sigma, 1.0, N, M), chol


def _check_k4(device, args, chol, tile_m=256):
    before = _calls("gbm_terminal")
    out = gbm_terminal(*args, chol=chol, tile_m=tile_m, device=device)
    again = gbm_terminal(*args, chol=chol, tile_m=tile_m, device=device)
    other = gbm_terminal(args[0] + 1, *args[1:], chol=chol, tile_m=tile_m, device=device)
    torch.cuda.synchronize()
    assert _calls("gbm_terminal") == before + 3
    ref = gbm_terminal_reference(*args, chol=chol, device=device)
    assert out.shape == (args[-1], len(args[1])) and bool(torch.isfinite(out).all())
    assert float(((out - ref).abs() / ref.abs()).max()) <= K4_RTOL
    assert torch.equal(out, again)
    assert not torch.allclose(out, other)
    return out


# D = 256 and 1024: the correlated z-tile of 64 path pairs does not fit a
# block's 75 KB of shared memory, and the launcher shrinks it to 32 and 8
# pairs, whose micro-tiles no longer fill a warp with one asset group. D = 1
# and 7 are ragged: S_T's rows are not 16-byte aligned and the last group is
# partial.
# K1 and K2 of the MLP at full width (_full_width's inputs at seed B): the
# SHA-256 (first 16 hex digits) of (u, Z) and of (W_bars, b_bars, x_bar),
# as the kernels gave them before the NAIS-Net joined their sources (an
# H100 80GB HBM3): the MLP's instantiation is the same code, bit for bit.
MLP_DIGESTS = {
    1: ("eb81472b39ef8b7c", "0298a5c5d701fb85"),
    17: ("b791896393078e6f", "927a7d50de9ca048"),
    100: ("844930ee0e44734f", "a12e25f6b263b7dd"),
    129: ("fc942a0a0c85037b", "e3e07d27cb2c73e9"),
    512: ("43d4806e986ba859", "0a85bec4144d9454"),
    2048: ("58f5f1dbe48c6113", "bb30f5e2cd3e2679"),
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("B", sorted(MLP_DIGESTS))
def test_the_mlps_kernels_give_the_bits_they_gave(cuda_device, B):
    Ws, bs, x, u_bar, z_bar = _full_width(cuda_device, B, seed=B)
    u, z = mlp_u_z_fwd(Ws, bs, x)
    W_bars, b_bars, x_bar = mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar)
    torch.cuda.synchronize()
    assert (_digest([u, z]), _digest([*W_bars, *b_bars, x_bar])) == MLP_DIGESTS[B]


def _nais_full_width(device, B, seed, layers=FULL):
    """A NAIS-Net at [101, 256×4, 1] (or ``layers``) in the kernels' layout
    (the port's net drawn from ``seed``, biases N(0, 0.1²), its projections
    through ``extract_nais_params``), and inputs of B rows."""
    from dnnpde_tpu_torch.nets.networks import build_network
    from dnnpde_tpu_torch.params import extract_nais_params

    gen = torch.Generator().manual_seed(seed)
    net = build_network("Naisnet", layers, "Sine", generator=gen, device=device)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        Ws, bs = (tuple(t.detach().contiguous() for t in ts) for ts in extract_nais_params(net))
    rng = np.random.default_rng(seed)
    x, u_bar, z_bar = _on(device, [rng.normal(size=s).astype(np.float32)
                                   for s in ((B, layers[0]), (B, 1), (B, layers[0]))])
    return Ws, bs, x, u_bar, z_bar


def _nais_counts():
    return [_calls(k, c) for k in ("mlp_u_z_fwd", "mlp_u_z_bwd") for c in ("calls", "nais_calls")] \
        + [_calls("mlp_u_z_bwd", "cluster_calls")]


@pytest.mark.parametrize("B", [1, 17, 100, 129, 512])
def test_nais_k1_and_k2_match_their_plain_versions_and_repeat_bitwise(cuda_device, B):
    """K1's and K2's NAIS forms against their plain versions, twice each:
    close, and the same bits both times. K2's row chain runs on clusters of
    16 CTAs up to ``NAIS_CLUSTER_MAX_ROWS`` (the basket's B = 100 among
    them) and on one block a tile above; its NAIS calls count as K2 calls,
    and those on clusters as clustered."""
    Ws, bs, x, u_bar, z_bar = _nais_full_width(cuda_device, B, seed=B)
    assert check_mlp(Ws, bs, x.device, nais=True) == FULL
    clustered = bwd_takes_cluster(FULL, B, nais=True)
    assert clustered == (B <= NAIS_CLUSTER_MAX_ROWS)
    before = _nais_counts()
    fwd = [mlp_u_z_fwd(Ws, bs, x, nais=True) for _ in range(2)]
    bwd = [mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar, nais=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_nais_counts(), before)] == [2, 2, 2, 2, 2 * clustered]
    ref = [*mlp_u_z_fwd_reference(Ws, bs, x, nais=True),
           *(lambda o: [*o[0], *o[1], o[2]])(
               mlp_u_z_bwd_reference(Ws, bs, x, u_bar, z_bar, nais=True))]
    runs = [[*f, *b[0], *b[1], b[2]] for f, b in zip(fwd, bwd)]
    for a, again, r in zip(*runs, ref, strict=True):
        _assert_kernel_close(a, r)
        assert torch.equal(a, again)


@pytest.mark.parametrize("B", [1, 17, 100, NAIS_CLUSTER_MAX_ROWS, NAIS_CLUSTER_MAX_ROWS + 1])
def test_nais_k2_cluster_chain_gives_the_one_block_chains_bits(cuda_device, B):
    """K2's NAIS form with its row chain on clusters of 16 CTAs
    (``mlp_u_z_bwd_nais_cluster``) and on one block (``mlp_u_z_bwd_nais``),
    each through its C entry point twice, and through the wrapper: the same
    bits every time. The wrapper takes the cluster up to
    ``NAIS_CLUSTER_MAX_ROWS`` and counts it in ``cluster_calls``; the C side's
    shared memory of a CTA is the wrapper's."""
    Ws, bs, x, u_bar, z_bar = _nais_full_width(cuda_device, B, seed=1000 + B)
    widths = check_mlp(Ws, bs, x.device, nais=True)
    runs = [_bwd_launch(entry, Ws, bs, x, u_bar, z_bar, widths)
            for entry in ("mlp_u_z_bwd_nais", "mlp_u_z_bwd_nais_cluster") * 2]
    clustered = bwd_takes_cluster(widths, B, nais=True)
    assert clustered == (B <= NAIS_CLUSTER_MAX_ROWS)
    before = _nais_counts()
    runs.append(mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar, nais=True))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_nais_counts(), before)] == [0, 0, 1, 1, int(clustered)]
    smem = _lib("mlp_u_z_bwd").mlp_u_z_bwd_nais_cluster_smem_bytes(
        (ctypes.c_int * len(widths))(*widths), len(Ws))
    assert smem == bwd_cluster_smem_bytes(widths, nais=True) <= MAX_SMEM
    leaves = [[*o[0], *o[1], o[2]] for o in runs]
    for one_block, *others in zip(*leaves, strict=True):
        assert bool(torch.isfinite(one_block).all())
        assert all(torch.equal(one_block, t) for t in others)


# Ragged NAIS-Nets on clusters of 16 CTAs: 40 hidden columns fill five
# tiles and part of a sixth (ten CTAs own none), the 5-wide input one x tile;
# a single block at full width.
NAIS_RAGGED = [([5, 40, 40, 40, 1], 17), ([5, 40, 40, 40, 1], 100), ([101, 256, 256, 1], 100)]


@pytest.mark.parametrize("layers, B", NAIS_RAGGED)
def test_nais_k2_cluster_chain_at_ragged_shapes(cuda_device, layers, B):
    """The two row chains of K2's NAIS form give the same bits at ragged
    widths, and stay close to its plain version."""
    Ws, bs, x, u_bar, z_bar = _nais_full_width(cuda_device, B, seed=B + len(layers), layers=layers)
    widths = check_mlp(Ws, bs, x.device, nais=True)
    assert bwd_takes_cluster(widths, B, nais=True)
    runs = [_bwd_launch(entry, Ws, bs, x, u_bar, z_bar, widths)
            for entry in ("mlp_u_z_bwd_nais", "mlp_u_z_bwd_nais_cluster")]
    ref = mlp_u_z_bwd_reference(Ws, bs, x, u_bar, z_bar, nais=True)
    torch.cuda.synchronize()
    for one_block, chain, r in zip(*([*o[0], *o[1], o[2]] for o in (*runs, ref)), strict=True):
        _assert_kernel_close(chain, r)
        assert torch.equal(one_block, chain)


def test_nais_k2_recomputes_k1s_forward_exactly(cuda_device):
    """test_k2_recomputes_k1s_forward_exactly for the NAIS-Net: with u_bar
    the one-hot of row r and z_bar = 0, K2's gradient of the head is the
    bf16 of the f32 residual stream a_{L-1} it recomputed for row r, and
    K1's u[r] is the head over the stream K1 computed."""
    B = 32
    Ws, bs, x, _, _ = _nais_full_width(cuda_device, B, seed=11)
    u, _ = mlp_u_z_fwd(Ws, bs, x, nais=True)
    w_head = Ws[-1][:, 0].to(torch.bfloat16).double()
    z_bar = torch.zeros_like(x)
    for r in range(B):
        u_bar = torch.zeros(B, 1, device=cuda_device)
        u_bar[r] = 1.0
        W_bars, _, _ = mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar, nais=True)
        a = W_bars[-1][:, 0]
        assert torch.equal(a, a.to(torch.bfloat16).float())
        terms = a.double() * w_head
        u_r = float(terms.sum()) + float(bs[-1][0])
        scale = float(terms.abs().sum()) + abs(float(bs[-1][0]))
        assert abs(float(u[r, 0]) - u_r) <= 1e-6 * scale, f"row {r}"


def _nais_function_grads(device, Ws, bs, x):
    """The gradients of a loss that feeds Z back in, through FusedNaisUZ on
    ``device`` (K1 + K2 on the card, their plain versions on the CPU)."""
    wb = [t.detach().to(device).requires_grad_(True) for t in (*Ws, *bs)]
    x_d = x.detach().to(device).requires_grad_(True)
    u, z = FusedNaisUZ.apply(x_d, *wb)
    u2, z2 = FusedNaisUZ.apply((x_d + 0.1 * z).contiguous(), *wb)
    loss = (u2 * u).sum() + (z2 * z).sum()
    return [g.cpu() for g in torch.autograd.grad(loss, [x_d, *wb])]


def test_fused_nais_function_gradients_match_plain_function(cuda_device):
    """FusedNaisUZ on the card against the same Function on the CPU. Each
    gradient is a sum over the 64 rows and the loss's two passes, so one
    leaf can cancel to far below its terms (the head's bias: one element),
    and its error is a bf16 step of the terms, not of the sum: the bound is
    on each leaf's norm, relative to the larger of its own and the median
    leaf's, as the benchmark's leaf gaps are. On an H100 the largest leaf
    reads 1.2e-4; leaving one block's U_i term out of the plain version
    moves every leaf by 0.19 to 0.70."""
    Ws, bs, x, _, _ = _nais_full_width(cuda_device, 64, seed=9)
    before = (_calls("mlp_u_z_fwd", "nais_calls"), _calls("mlp_u_z_bwd", "nais_calls"))
    on_card = _nais_function_grads(cuda_device, Ws, bs, x)
    torch.cuda.synchronize()
    assert (_calls("mlp_u_z_fwd", "nais_calls"), _calls("mlp_u_z_bwd", "nais_calls")) == (
        before[0] + 2, before[1] + 2)
    plain = _nais_function_grads("cpu", Ws, bs, x)
    norms = [float(torch.linalg.vector_norm(r)) for r in plain]
    median = sorted(norms)[len(norms) // 2]
    for k, (a, r, n) in enumerate(zip(on_card, plain, norms, strict=True)):
        assert a.shape == r.shape and bool(torch.isfinite(a).all())
        gap = float(torch.linalg.vector_norm(a - r)) / max(n, median)
        assert gap <= 1e-2, (k, gap)


@pytest.mark.parametrize("D", [1, 7, 100, 256, 1024])
@pytest.mark.parametrize("correlated", [False, True])
def test_k4_matches_plain_version_and_repeats_bitwise(cuda_device, D, correlated):
    args, chol = _k4_case(D, correlated, M=2048, N=12)
    out = _check_k4(cuda_device, args, chol)
    # the values do not depend on tile_m
    assert torch.equal(out, gbm_terminal(*args, chol=chol, tile_m=64, device=cuda_device))


# The shapes chip_smoke.py runs: scripts/verify_tpu_kernels.py's M = 131072,
# N = 50, D = 100, and the basket path's N = 1 (fused_basket_call_mc), where
# the last correlated block is full and the uncorrelated grid has no tail.
@pytest.mark.parametrize("N", [1, 50])
@pytest.mark.parametrize("correlated", [False, True])
def test_k4_matches_plain_version_at_full_shape(cuda_device, N, correlated):
    args, chol = _k4_case(100, correlated, M=131072, N=N, seed=7)
    _check_k4(cuda_device, args, chol)


# M not a multiple of the correlated block's 128 paths nor of the uncorrelated
# block's 512 items: the last block holds fewer pairs.
@pytest.mark.parametrize("correlated", [False, True])
def test_k4_matches_plain_version_with_a_partial_last_block(cuda_device, correlated):
    args, chol = _k4_case(100, correlated, M=2 * 1001, N=3)
    _check_k4(cuda_device, args, chol, tile_m=2)


# ---- the training chunk as a CUDA graph -------------------------------------
#
# Trainer.train captures one iteration per chunk into a CUDA graph and replays
# it; Trainer.step runs the same iteration eagerly. On the same generator state
# the two must agree bit for bit: the same kernels on the same inputs, and the
# graph draws its increments from the trainer's registered generator.

CHUNK_D, CHUNK_M, CHUNK_N = 8, 16, 6
CHUNK_LAYERS = [CHUNK_D + 1, 64, 64, 1]
CHUNK_NAIS_LAYERS = [CHUNK_D + 1, 64, 64, 64, 1]


def _clamped_bsb():
    """BSB with u clamped at 0: an absorbing state once u < 0 everywhere."""
    import dataclasses

    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt

    @dataclasses.dataclass(frozen=True)
    class ClampedBSB(BlackScholesBarenblatt):
        @property
        def clamp_u(self):
            return 0.0

    return ClampedBSB(D=CHUNK_D)


def _chunk_trainer(device, backend, seed=0, remat=False, prob=None, remat_policy=None,
                   nais=False, **kw):
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    config = SolverConfig(fused_net_u=backend, remat=remat, remat_policy=remat_policy)
    if nais:  # a NAIS-Net of two blocks, sine
        kw.update(mode="Naisnet", activation="Sine")
    layers = CHUNK_NAIS_LAYERS if nais else CHUNK_LAYERS
    return Trainer(prob or BlackScholesBarenblatt(D=CHUNK_D), M=CHUNK_M, N=CHUNK_N, layers=layers,
                   seed=seed, device=device, ema_decay=0.9, solver_config=config, **kw)


def _eager_steps(tr, k, lr=1e-3):
    out = [tr.step(*tr._batch(), "Adam", lr) for _ in range(k)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def _assert_same_state(a, b):
    """Parameters, optimizer state, EMA and generator, bit for bit."""
    for x, y in zip(a._params, b._params):
        assert torch.equal(x, y)
    for k, v in a._opt_state.items():
        xs, ys = (v, b._opt_state[k]) if isinstance(v, list) else ([v], [b._opt_state[k]])
        for x, y in zip(xs, ys):
            assert torch.equal(x, y), k
    for x, y in zip(a.ema_params.parameters(), b.ema_params.parameters()):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _last_chunk(tr, k):
    chunk = next(iter(tr._chunk_cache.values()))
    assert chunk.graph is not None, "the chunk was not captured"
    return chunk.losses[:k], chunk.y0s[:k]


@pytest.mark.parametrize("backend,guard,best,remat,nais", [
    ("cuda", False, False, False, False), ("cuda", True, False, False, False),
    ("cuda", True, True, False, False),
    (False, False, False, False, False), (False, True, False, False, False),
    (False, False, True, False, False), (False, False, False, True, False),
    ("cuda", False, False, False, True), ("cuda", True, True, False, True),
    ("torch", False, False, False, True),
], ids=["k1k2", "k1k2-guard", "k1k2-guard-best", "f32", "f32-guard", "f32-best", "f32-remat",
        "nais-k1k2", "nais-k1k2-guard-best", "nais-torch"])
def test_captured_chunk_equals_eager_steps(cuda_device, backend, guard, best, remat, nais):
    k = 8
    kw = dict(nan_guard=guard, track_best=best, remat=remat, nais=nais)
    captured, eager = _chunk_trainer(cuda_device, backend, **kw), _chunk_trainer(cuda_device,
                                                                                   backend, **kw)
    fwd, bwd = _calls("mlp_u_z_fwd"), _calls("mlp_u_z_bwd")
    res = captured.train(k, 1e-3, log_every=k, verbose=False)
    # the wrappers count the eager warm-up iteration and the capture, not the replays
    per_iteration = (CHUNK_N + 1) if backend == "cuda" else 0
    assert _calls("mlp_u_z_fwd") - fwd == 2 * per_iteration
    assert _calls("mlp_u_z_bwd") - bwd == 2 * per_iteration
    losses, y0s = _eager_steps(eager, k)
    got_losses, got_y0s = _last_chunk(captured, k)
    assert torch.equal(got_losses, losses) and torch.equal(got_y0s, y0s)
    _assert_same_state(captured, eager)
    if best:
        assert res.min_loss == float(losses.min())
        X, Y = res.min_loss_state
        assert X.shape == (CHUNK_M, CHUNK_N + 1, CHUNK_D) and np.isfinite(Y).all()


@pytest.mark.parametrize("event", ["reset", "load", "lr", "reroll"])
def test_next_replayed_chunk_equals_the_eager_continuation(cuda_device, tmp_path, event):
    k = 6
    backend, kw = "cuda", {}
    if event == "reroll":  # one restart allowed, on a clamped BSB, which K1 + K2 do not serve
        backend = False
        kw = dict(prob=_clamped_bsb(), collapse_restart=True, collapse_max_restarts=1)
    captured = _chunk_trainer(cuda_device, backend, **kw)
    eager = _chunk_trainer(cuda_device, backend, **kw)
    if event == "reroll":
        with torch.no_grad():  # u well above the clamp: the first chunk is healthy
            for tr in (captured, eager):
                tr.params.dense[-1].linear.bias.add_(10.0)
    captured.train(k, 1e-3, log_every=k, verbose=False)
    _eager_steps(eager, k)
    chunk = next(iter(captured._chunk_cache.values()))
    lr = 1e-3
    if event == "reset":
        captured.reset(3)
        eager.reset(3)
    elif event == "load":
        captured.save_model(str(tmp_path / "c.pt"))
        loaded = _chunk_trainer(cuda_device, "cuda", seed=9)
        loaded.train(k, 1e-3, log_every=k, verbose=False)  # its own captured chunk
        chunk = next(iter(loaded._chunk_cache.values()))
        loaded.load_model(str(tmp_path / "c.pt"))
        captured = loaded
    elif event == "lr":
        lr = 1e-4  # a float lr change: a fresh optimizer state in the captured tensors
    else:  # a real collapse: train rolls the failed chunk back and re-rolls the stream
        with torch.no_grad():  # u <= 0 everywhere: Y0 is pinned at the clamp
            for tr in (captured, eager):
                tr.params.dense[-1].linear.bias.sub_(1e3)
        snap = eager._snapshot()
        _eager_steps(eager, k)  # the failed chunk
        seed = eager._reroll_seed(0)
        eager._restore(snap)
        eager.generator.manual_seed(seed)
    captured.train(k, lr, log_every=k, verbose=False)
    assert next(iter(captured._chunk_cache.values())) is chunk  # replayed, not captured again
    assert captured.collapse_restarts == ([k] if event == "reroll" else [])
    losses, y0s = _eager_steps(eager, k, lr)
    got_losses, got_y0s = _last_chunk(captured, k)
    assert torch.equal(got_losses, losses) and torch.equal(got_y0s, y0s)
    _assert_same_state(captured, eager)


def test_a_failed_capture_raises(cuda_device):
    tr = _chunk_trainer(cuda_device, False)

    def host_read_schedule(count):  # reads the device count back: no capture can hold that
        return 1e-3 + 0.0 * float(count)

    with pytest.raises(RuntimeError, match="CUDA graph"):
        tr.train(4, host_read_schedule, log_every=4, verbose=False)
    torch.cuda.synchronize()
    chunk = next(iter(tr._chunk_cache.values()))
    assert chunk.warm and chunk.graph is None  # the warm-up ran; nothing replays eagerly


def test_a_captured_replica_chunk_equals_eager_iterations(cuda_device):
    """The replica program runs the Trainer's captured chunk: a K = 2 chunk
    (an eager warm-up, a capture with both generators registered, replays)
    against as many eager iterations from the same state, bit for bit."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.train import ReplicaProgram

    k = 6
    captured, eager = (ReplicaProgram(BlackScholesBarenblatt(D=CHUNK_D), (0, 1), M=CHUNK_M,
                                      N=CHUNK_N, layers=CHUNK_LAYERS, ema_decay=0.9,
                                      capacity=k, device=cuda_device) for _ in range(2))
    for prog in (captured, eager):
        prog.new_phase(1e-3)
    names = ("train.graph_captures", "train.graph_replays", "train.eager_iterations")
    before = [tracing.counters().get(n, 0) for n in names]
    captured.run(k)
    assert [tracing.counters().get(n, 0) - b for n, b in zip(names, before)] == [1, k - 1, 1]
    assert captured.graph is not None and captured.compile_time > 0
    for _ in range(k):
        eager.iteration()
    torch.cuda.synchronize()
    assert torch.equal(captured.losses, eager.losses) and torch.equal(captured.y0s, eager.y0s)
    for a, b in ((captured.params, eager.params), (captured.ema, eager.ema)):
        for n in a:
            assert torch.equal(a[n], b[n]), n
    for key, v in captured.opt_state.items():
        xs, ys = (v, eager.opt_state[key]) if isinstance(v, list) else ([v], [eager.opt_state[key]])
        for x, y in zip(xs, ys):
            assert torch.equal(x, y), key
    for g, h in zip(captured.generators, eager.generators):
        assert torch.equal(g.get_state(), h.get_state())


# ---- the harness's nets and problems on the card -----------------------------


def _harness_trainer(device, case, **kw):
    from dnnpde_tpu_torch.pde import HamiltonJacobiBellman, HestonPDE
    from dnnpde_tpu_torch.train import Trainer

    if case == "naisnet-hjb":
        prob, mode, act = HamiltonJacobiBellman(D=CHUNK_D), "Naisnet", "ReLU"
    elif case == "verlet-hjb":
        prob, mode, act = HamiltonJacobiBellman(D=CHUNK_D), "Verlet", "Sine"
    else:
        prob, mode, act = HestonPDE(clamp_smoothing=case.split("-", 1)[1]), "FC", "Sine"
    layers = [prob.dim + 1, 64, 64, 64, 1]
    return Trainer(prob, M=CHUNK_M, N=CHUNK_N, layers=layers, mode=mode, activation=act,
                   seed=4, device=device, ema_decay=0.9, **kw)


@pytest.mark.parametrize("case", ["naisnet-hjb", "verlet-hjb", "heston-bs", "heston-hard"])
@pytest.mark.parametrize("remat", [False, True])
def test_harness_trainers_captured_chunk_equals_eager_steps(cuda_device, case, remat):
    from dnnpde_tpu_torch.solver import SolverConfig

    k = 8
    kw = dict(solver_config=SolverConfig(remat=remat), nan_guard=True)
    captured, eager = (_harness_trainer(cuda_device, case, **kw) for _ in range(2))
    captured.train(k, 1e-3, log_every=k, verbose=False)
    losses, y0s = _eager_steps(eager, k)
    got_losses, got_y0s = _last_chunk(captured, k)
    assert bool(torch.isfinite(losses).all())
    assert torch.equal(got_losses, losses) and torch.equal(got_y0s, y0s)
    _assert_same_state(captured, eager)


@pytest.mark.parametrize("row", ["bsb_100d", "call_1d", "basket_100d", "hjb_100d", "heston"])
def test_harness_rows_run_on_the_card(cuda_device, row):
    """Each row at a short legacy budget on cuda:0: finite Y0 near the
    oracle's scale, positive rates."""
    from dnnpde_tpu_torch.bench import harness

    res = harness.ALL_BENCHES[row](iters=(100, 100))
    assert np.isfinite(res.learned_y0) and np.isfinite(res.oracle_y0) and res.oracle_y0 > 0
    assert res.iters_per_sec > 0 and res.wall_time_s > 0
    assert res.config["phases"][0][0] == 100


# ---- the stopping slice on the card ------------------------------------------


def _stopping_trainer(device, remat, **kw):
    from dnnpde_tpu_torch.pde import HestonAmericanPut
    from dnnpde_tpu_torch.sim import lognormal_x0
    from dnnpde_tpu_torch.solver import SolverConfig, iv_space_weights
    from dnnpde_tpu_torch.train import Trainer

    prob = HestonAmericanPut()
    return Trainer(prob, M=CHUNK_M, N=CHUNK_N, layers=[3, 64, 64, 64, 1], seed=4, device=device,
                   ema_decay=0.9, objective="local_ema", antithetic=True,
                   x0_sampler=lognormal_x0(prob.x0, [0.1, 0.4]), z_match_weight=0.5,
                   z_match_mask=(0.0, 1.0), path_weight_fn=iv_space_weights(r=prob.r),
                   solver_config=SolverConfig(remat=remat), **kw)


@pytest.mark.parametrize("remat", [False, True])
def test_stopping_trainer_captured_chunk_equals_eager_steps(cuda_device, remat):
    """local_ema targets, a lognormal X0 sampler under antithetic
    increments, Z-matching and IV-space weights, all inside the captured
    iteration: the chunk equals eager steps bit for bit."""
    k = 8
    captured, eager = (_stopping_trainer(cuda_device, remat, nan_guard=True) for _ in range(2))
    captured.train(k, 1e-3, log_every=k, verbose=False)
    losses, y0s = _eager_steps(eager, k)
    got_losses, got_y0s = _last_chunk(captured, k)
    assert bool(torch.isfinite(losses).all())
    assert torch.equal(got_losses, losses) and torch.equal(got_y0s, y0s)
    _assert_same_state(captured, eager)


def test_local_step_on_kernels_matches_f32(cuda_device):
    """The local objective with sparse exercise dates on K1 + K2 against
    the f32 path: loss and every gradient within 2e-2 of max|f32|."""
    from dnnpde_tpu_torch.nets import MLP
    from dnnpde_tpu_torch.pde import BermudanMaxCall
    from dnnpde_tpu_torch.sim import time_major_batch
    from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn

    prob = BermudanMaxCall(D=2, N_steps=18, head=False)
    net = MLP([3, 256, 256, 256, 256, 1], "sine", generator=torch.Generator().manual_seed(0),
              device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ts, dWs = time_major_batch(gen, 256, 18, 2, prob.T)
    X0 = prob.x0.to(cuda_device).expand(256, 2)
    out = {}
    for backend in ("cuda", "torch"):
        res = make_loss_fn(prob, net, SolverConfig(fused_net_u=backend, remat=False,
                                                   objective="local"))(net, ts, dWs, X0)
        out[backend] = [res.loss.detach(), *torch.autograd.grad(res.loss, list(net.parameters()))]
    for a, ref in zip(out["cuda"], out["torch"]):
        assert bool(torch.isfinite(a).all())
        assert float((a - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


def _recorded(module, monkeypatch):
    """Record the normals ``module._normals`` draws; returns the record."""
    record, draw = [], module._normals

    def recording(*args):
        z = draw(*args)
        record.append(z.cpu())
        return z

    monkeypatch.setattr(module, "_normals", recording)
    return record


def _replayed(module, monkeypatch, record):
    it = iter(record)
    monkeypatch.setattr(module, "_normals", lambda *args: next(it).clone())


def test_lsmc_and_policy_value_on_the_card_match_their_cpu_runs(cuda_device, monkeypatch):
    """The oracles on the card against the same computation on the CPU fed
    the card's own normals: within 0.05 standard errors (the f32 states
    differ in the last bits, so a decision at a near-tie may flip)."""
    import copy
    import importlib

    from dnnpde_tpu_torch.nets import MLP
    from dnnpde_tpu_torch.pde import BermudanMaxCall, HestonAmericanPut

    # the modules (the packages export functions of the same names)
    pv_mod = importlib.import_module("dnnpde_tpu_torch.evals.policy_value")
    ls_mod = importlib.import_module("dnnpde_tpu_torch.numerics.longstaff_schwartz")

    net = MLP([3, 64, 64, 1], "sine", generator=torch.Generator().manual_seed(2),
              device=cuda_device)
    cpu_net = copy.deepcopy(net).cpu()
    prob = HestonAmericanPut()
    kw = dict(N=10, n_regression=16_384, n_pricing=32_768, seed=0)
    record = _recorded(ls_mod, monkeypatch)
    card = ls_mod.lsmc_value(prob, cv_net=net, **kw)
    _replayed(ls_mod, monkeypatch, record)
    cpu = ls_mod.lsmc_value(prob, cv_net=cpu_net, **kw)
    assert abs(card.value - cpu.value) <= 0.05 * cpu.standard_error
    assert abs(card.plain_value - cpu.plain_value) <= 0.05 * cpu.standard_error
    assert card.cv_variance_reduction > 1.0

    prob = BermudanMaxCall(D=2, N_steps=9)
    kw = dict(N=9, n_paths=65_536, batch=32_768, seed=3)
    record = _recorded(pv_mod, monkeypatch)
    card = pv_mod.policy_value(prob, net, **kw)
    _replayed(pv_mod, monkeypatch, record)
    cpu = pv_mod.policy_value(prob, cpu_net, **kw)
    assert abs(card.value - cpu.value) <= 0.05 * cpu.standard_error
    assert abs(card.exercise_fraction - cpu.exercise_fraction) <= 1e-3


def test_lbfgs_polish_on_the_card_matches_the_cpu(cuda_device):
    """Ten LBFGS steps of a frozen-batch polish of the 1-D call on a
    [2, 16, 16, 1] net: on the card (TF32 off inside polish) and on the CPU
    from the same weights and batch, each loss within 1e-4 relative."""
    from dnnpde_tpu_torch.pde import CallOption1D
    from dnnpde_tpu_torch.sim import brownian_increments, time_grid
    from dnnpde_tpu_torch.train import Trainer

    kw = dict(M=64, N=8, layers=[2, 16, 16, 1], seed=3)
    card = Trainer(CallOption1D(), device=cuda_device, **kw)
    cpu = Trainer(CallOption1D(), device="cpu", **kw)
    card.train(20, 1e-3, log_every=20, verbose=False)
    with torch.no_grad():
        for p, q in zip(cpu.params.parameters(), card.params.parameters()):
            p.copy_(q.cpu())
    M = 1024
    dWs = brownian_increments(torch.Generator().manual_seed(4), M, 8, 1, 1 / 8,
                              antithetic=True).transpose(0, 1)
    ts = time_grid(M, 8, 1.0, device="cpu").transpose(0, 1)
    X0 = CallOption1D().x0.expand(M, 1)
    ref = cpu._polish_on(ts, dWs, X0, n_iter=10)
    ours = card._polish_on(*(a.to(cuda_device) for a in (ts, dWs, X0)), n_iter=10)
    rel = np.abs(ours - ref) / np.abs(ref)
    assert rel.max() <= 1e-4, (ours, ref)
    assert ours[-1] < ours[0]
    assert not torch.backends.cuda.matmul.allow_tf32


def test_qmc_oracle_on_the_card_equals_the_cpu(cuda_device):
    """The same Sobol points through the chain on the card and on the CPU."""
    from dnnpde_tpu_torch.numerics import discrete_bsde_value_qmc
    from dnnpde_tpu_torch.pde import UpAndOutCall

    kw = dict(N=10, n_paths=4096, n_replicates=4, seed=1)
    card = discrete_bsde_value_qmc(UpAndOutCall(), device=cuda_device, **kw)
    cpu = discrete_bsde_value_qmc(UpAndOutCall(), device="cpu", **kw)
    assert card.value == pytest.approx(cpu.value, rel=1e-5)


def test_cli_runs_on_the_card_through_its_entry_point(cuda_device, tmp_path):
    """``python3 -m dnnpde_tpu_torch`` in a subprocess: the barrier call,
    objective resolved to local, graded against the discrete oracle, with
    the control-variate price and an exported solution."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "dnnpde_tpu_torch", "--problem", "barrier_call", "--M", "64",
           "--N", "10", "--width", "32", "--depth", "2", "--iters", "60", "20", "--log-every",
           "20", "--quiet", "--cv-price", "16384", "--out", str(out), "--export",
           str(tmp_path / "sol.pt")]
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    summary = json.loads((out / "summary.json").read_text())
    assert summary["problem"] == "barrier_call" and np.isfinite(summary["learned_y0"])
    assert 0.0 < summary["oracle_y0"] < 0.1
    assert summary["cv_price"]["n_paths"] == 16384
    assert (tmp_path / "sol.pt").exists()


@pytest.mark.parametrize("objective", ["global", "local_ema"])
def test_sdenet_captured_chunk_equals_eager_steps(cuda_device, objective):
    """An SDENet trainer draws its noise inside the captured iteration from
    its registered generator: 12 replayed iterations equal 12 eager steps bit
    for bit (losses, Y0s, parameters, generator state), and the evaluation
    paths leave the generator alone."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.train import Trainer

    kw = dict(M=32, N=8, layers=[11, 32, 32, 32, 1], mode="SDEnet", seed=4, ema_decay=0.9,
              objective=objective, device=cuda_device)
    captured, eager = (Trainer(BlackScholesBarenblatt(D=10), **kw) for _ in range(2))
    captured.train(12, 1e-3, log_every=12, verbose=False)
    chunk = next(iter(captured._chunk_cache.values()))
    assert chunk.graph is not None
    steps = [eager.step(*eager._batch(), "Adam", 1e-3) for _ in range(12)]
    assert torch.equal(chunk.losses[:12], torch.stack([s[0] for s in steps]))
    assert torch.equal(chunk.y0s[:12], torch.stack([s[1] for s in steps]))
    assert all(torch.equal(a, b) for a, b in zip(captured._params, eager._params))
    state = captured.generator.get_state()
    assert torch.equal(state, eager.generator.get_state())
    X = np.ones((4, 10), np.float32)
    u1, _ = captured.evaluate_u(np.zeros((4, 1)), X)
    u2, _ = captured.evaluate_u(np.zeros((4, 1)), X)
    np.testing.assert_array_equal(u1, u2)
    assert torch.equal(state, captured.generator.get_state())


def test_implied_vol_on_the_card_equals_the_cpu(cuda_device):
    """The safeguarded Newton solve and its implicit-function gradient on
    the card and on the CPU, within 1e-5 (σ) and 1e-4 relative (gradient)."""
    from dnnpde_tpu_torch.numerics import implied_vol

    rng = np.random.default_rng(0)
    K = rng.uniform(0.75, 1.3, 64).astype(np.float32)
    price = np.maximum(1.0 - K, 0.0) + rng.uniform(0.01, 0.1, 64).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = torch.tensor(price, device=dev, requires_grad=True)
        iv = implied_vol(p, 1.0, torch.tensor(K, device=dev), 1.0, 0.02)
        iv.sum().backward()
        out[dev.type] = (iv.detach().cpu().numpy(), p.grad.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)


@pytest.mark.parametrize("name", ["hjb", "heston", "surface"])
def test_executors_run_on_the_card(cuda_device, tmp_path, name):
    """The executors at tests/test_executors.py's tiny sizes on the card:
    each CSV complete, its graded numbers finite, its rows flagged."""
    import pandas as pd

    from dnnpde_tpu_torch import experiments as ex

    tiny = dict(Ms=(8,), Ds=(5,), N=4, lr_pairs=((1e-3, 1e-4),), iter_pairs=((6, 2),),
                optimizers=("Adam",), modes=("FC",), activations=("Sine",),
                hidden=(16, 16, 16, 16))
    if name == "hjb":
        ex.HJBExecutor(ex.SweepConfig(**tiny), str(tmp_path), device=cuda_device).execute()
        df, col = pd.read_csv(tmp_path / "results_hjb.csv"), "Quality Flag"
    elif name == "heston":
        ex.HestonExecutor(Ms=(4,), N=4, n_iter=(6, 2), save_path=str(tmp_path),
                          device=cuda_device).execute()
        df, col = pd.read_csv(tmp_path / "results_heston.csv"), "Quality Flag"
    else:
        cfg = ex.SurfaceConfig(M=16, N=4, width=16, depth=2, budget=8, s_grid=(0.7, 1.4, 15),
                               discrete_oracle_paths=4096)
        ex.HestonSurfaceExecutor(cfg, str(tmp_path), device=cuda_device).execute()
        df, col = pd.read_csv(tmp_path / "results_heston_surface.csv"), "ok"
    assert len(df) >= 1 and df[col].notna().all()
    numeric = df.select_dtypes("number")
    assert np.isfinite(numeric.fillna(0.0).to_numpy()).all()


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable", "everything_saveable",
                                    "dots_with_no_batch_dims_saveable"])
@pytest.mark.parametrize("backend", [False, "torch", "cuda"], ids=["autograd", "fused", "k1k2"])
def test_captured_chunk_under_a_remat_policy_equals_eager_steps(cuda_device, policy, backend):
    """A remat policy's dispatch modes run inside the captured iteration: the
    chunk equals as many eager steps bit for bit, and the losses equal those
    without remat (a policy changes no number; on K1 + K2 it keeps nothing
    inside the kernels, which are not ATen ops)."""
    k = 6
    captured, eager = (_chunk_trainer(cuda_device, backend, remat=True, remat_policy=policy)
                       for _ in range(2))
    plain = _chunk_trainer(cuda_device, backend, remat=False)
    captured.train(k, 1e-3, log_every=k, verbose=False)
    losses, y0s = _eager_steps(eager, k)
    got_losses, got_y0s = _last_chunk(captured, k)
    assert torch.equal(got_losses, losses) and torch.equal(got_y0s, y0s)
    _assert_same_state(captured, eager)
    plain_losses, _ = _eager_steps(plain, k)
    assert torch.equal(plain_losses, losses)


@pytest.mark.parametrize("case", ["fc", "heston-bs", "sdenet"])
def test_the_artifact_on_the_card_equals_evaluate_u(cuda_device, tmp_path, case):
    """A trainer's artifact, exported and loaded onto the card, serves (u, Z)
    within 1e-6 of max|.| of the trainer's f32 ``evaluate_u`` at batches 1,
    33 and 1000; and loaded onto the CPU, the same program within 1e-5."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt, HestonPDE
    from dnnpde_tpu_torch.serve import load_solution, save_solution
    from dnnpde_tpu_torch.train import Trainer

    prob = HestonPDE() if case == "heston-bs" else BlackScholesBarenblatt(D=CHUNK_D)
    mode = "SDEnet" if case == "sdenet" else "FC"
    tr = Trainer(prob, M=8, N=4, layers=[prob.dim + 1, 64, 64, 64, 1], mode=mode, seed=3,
                 device=cuda_device)
    tr.train(4, 1e-3, log_every=2, verbose=False)
    path = str(tmp_path / "s.pt2")
    save_solution(path, tr)
    on_card, on_cpu = load_solution(path, device=cuda_device), load_solution(path, device="cpu")
    rng = np.random.default_rng(4)
    for batch in (1, 33, 1000):
        t = rng.uniform(size=(batch, 1)).astype(np.float32)
        X = np.abs(1.0 + 0.3 * rng.normal(size=(batch, prob.dim))).astype(np.float32)
        if case == "heston-bs":
            X[:, 1] = rng.uniform(0.05, 0.4, size=batch)
        u_ref, Z_ref = tr.evaluate_u(t, X)
        u, Z = on_card.u_and_grad(t, X)
        u_d, _ = on_card.u_and_grad_device(t, X)
        assert u_d.device.type == "cuda"
        for a, r in ((u, u_ref), (Z, Z_ref)):
            assert a.shape == r.shape and np.abs(a - r).max() <= 1e-6 * np.abs(r).max()
        for a, r in zip(on_cpu.u_and_grad(t, X), (u, Z)):
            assert np.abs(a - r).max() <= 1e-5 * np.abs(r).max()


def test_profile_trace_holds_every_kernel_of_the_block(cuda_device, tmp_path):
    """Five traces in a row, each of a fresh K1 + K2 trainer's first
    iterations (an eager warm-up, the capture, replays): each trace file
    holds its lead-in and every K1 and K2 kernel the block ran, and the
    marker kernel launched last."""
    import json
    import re

    from dnnpde_tpu_torch.train import profile_trace

    k = 4
    want = {"mlp_u_z_fwd_kernel": (CHUNK_N + 1) * k, "mlp_u_z_bwd_rows": (CHUNK_N + 1) * k,
            "mlp_u_z_bwd_wgrad": (CHUNK_N + 1) * k}
    for i in range(5):
        tr = _chunk_trainer(cuda_device, "cuda", seed=i)
        with profile_trace(str(tmp_path / str(i))):
            tr.train(k, 1e-3, log_every=k, verbose=False)
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)  # the marker, after every kernel of the block
        (path,) = (tmp_path / str(i)).glob("*.pt.trace.json")
        events = json.loads(path.read_text())["traceEvents"]
        runs, last, spins = dict.fromkeys(want, 0), 0.0, []
        for e in events:
            if e.get("cat") == "kernel":
                m = re.search(r"mlp_u_z_\w+", e["name"])
                if m and m.group(0) in runs:
                    runs[m.group(0)] += 1
                    last = max(last, float(e["ts"]))
                if "spin_kernel" in e["name"]:
                    spins.append(float(e["ts"]))
        assert runs == want, (i, runs)
        assert sum(ts > last for ts in spins) == 1
        assert any(e.get("name") == "profile_trace lead-in" for e in events)


def test_a_captured_chunk_counts_and_traces_its_replays(cuda_device, tmp_path):
    """A fresh chunk of k iterations counts its eager warm-up, one capture
    and k − 1 replays; in the ``profile_trace`` file the k − 1 graph launches
    lie inside the ``dnnpde.train.replay`` range, every K1 record of the
    replays comes from one of them and starts after the range opened, and
    the warm-up's K1 records come before it."""
    import json

    from dnnpde_tpu_torch.train import profile_trace

    k = 4
    tr = _chunk_trainer(cuda_device, "cuda", seed=7)
    names = ("train.graph_captures", "train.graph_replays", "train.eager_iterations")
    before = tracing.counters()
    with profile_trace(str(tmp_path)):
        tr.train(k, 1e-3, log_every=k, verbose=False)
    after = tracing.counters()
    assert [after.get(n, 0) - before.get(n, 0) for n in names] == [1, k - 1, 1]
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (replay,) = [e for e in events if e.get("name") == "dnnpde.train.replay"
                 and e.get("cat") == "user_annotation"]
    a = float(replay["ts"])
    b = a + float(replay["dur"])
    launches = {e["args"]["correlation"] for e in events
                if e.get("name") == "cudaGraphLaunch" and a <= float(e["ts"]) <= b}
    assert len(launches) == k - 1
    k1 = [e for e in events if e.get("cat") == "kernel" and "mlp_u_z_fwd_kernel" in e["name"]]
    replayed = [e for e in k1 if e.get("args", {}).get("correlation") in launches]
    warm_up = [e for e in k1 if e.get("args", {}).get("correlation") not in launches]
    assert len(replayed) == (k - 1) * (CHUNK_N + 1) and len(warm_up) == CHUNK_N + 1
    assert all(float(e["ts"]) >= a for e in replayed)
    assert all(float(e["ts"]) < a for e in warm_up)
