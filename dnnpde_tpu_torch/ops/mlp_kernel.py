"""K1 and K2: the fused sine-MLP ``(u, Z_full)`` forward and its hand-derived
backward on hand-written CUDA kernels.

Counterparts of ``dnnpde_tpu/ops/mlp_kernel.py::mlp_u_z_fwd_pallas`` and
``mlp_u_z_bwd_pallas``. K1 (``csrc/mlp_u_z_fwd.cu``) runs the forward pass
and the Z-sweep for a tile of rows on tensor cores (``mma.sync``), with the
tile's activations in shared memory; only x, u and Z touch device memory.
K2 (``csrc/mlp_u_z_bwd.cu``) is two launches on tensor cores: a row chain
recomputes K1's forward, bit for bit, runs the Z-path adjoint and the u-path
backward and writes x_bar, the weight gradients' bf16 operands and per-tile
column sums to a scratch buffer; a second kernel forms each weight gradient
as one product over the batch, a block per output tile, and sums the column
sums in tile order. The row chain runs each 16-row tile either on a cluster
of 8 CTAs that keep their slices of the weights in shared memory, or on one
block that streams the weights from L2 with K1's own layer; the two give the
same bits, and :func:`bwd_takes_cluster` chooses from the widths and B.
Matmul operands are rounded to bf16 and accumulated in f32, as on the TPU.

``mlp_u_z_fwd`` and ``mlp_u_z_bwd`` launch their kernels for CUDA tensors
and raise on anything they do not take. For CPU tensors they compute the
plain versions, ``mlp_u_z_fwd_reference`` and ``mlp_u_z_bwd_reference``: the
same bf16-operand math in PyTorch, which differs from the kernels only in
the order of summation.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from dnnpde_tpu_torch import tracing

Tensor = torch.Tensor

MAX_LAYERS = 8  # DNNPDE_MAX_LAYERS in csrc/common.cuh
MAX_SMEM = 227 * 1024  # DNNPDE_MAX_SMEM: shared memory a block may use
CLUSTER_CTAS = 8  # cluster::kCtas in csrc/mlp_u_z_bwd.cu
# Largest batch whose row chain runs on clusters. An H100 holds about 15
# clusters of 8 CTAs at once, so up to 28 tiles of 16 rows take two waves of
# clusters (~79 us at full width, against ~116 us for the one-block design,
# 16 rows to an SM); from 32 tiles on it is three or more (PERF.md, PR 18).
CLUSTER_MAX_ROWS = 448


def bf16_dot(a: Tensor, w: Tensor) -> Tensor:
    """a @ w with both operands rounded to bf16 and an f32 result; the
    products are exact in f32, so only the order of summation is free."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def check_mlp(Ws: Sequence[Tensor], bs: Sequence[Tensor], device: torch.device) -> list[int]:
    """Validate a sine-MLP weight list for the kernels; returns the widths
    [n0, n1, ..., 1]."""
    if len(Ws) != len(bs) or not 2 <= len(Ws) <= MAX_LAYERS:
        raise ValueError(f"need 2..{MAX_LAYERS} layers with one bias each, got {len(Ws)}/{len(bs)}")
    widths = [int(Ws[0].shape[0])]
    for k, (W, b) in enumerate(zip(Ws, bs)):
        if W.dim() != 2 or W.shape[0] != widths[-1]:
            raise ValueError(f"Ws[{k}] has shape {tuple(W.shape)}, expected ({widths[-1]}, n)")
        if b.shape != (W.shape[1],):
            raise ValueError(f"bs[{k}] has shape {tuple(b.shape)}, expected ({W.shape[1]},)")
        for name, t in ((f"Ws[{k}]", W), (f"bs[{k}]", b)):
            if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
                raise ValueError(
                    f"{name} must be contiguous float32 on {device}, got {t.dtype} on {t.device}"
                )
        widths.append(int(W.shape[1]))
    if widths[-1] != 1:
        raise ValueError(f"the output layer must be 1 wide, got {widths[-1]}")
    return widths


def mlp_u_z_fwd_reference(Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor):
    """Plain version of K1: (u (B,1), Z_full (B,n0)) with bf16 dot operands."""
    L = len(Ws)
    a, ps = x, []
    for k in range(L - 1):
        p = bf16_dot(a, Ws[k]) + bs[k]
        ps.append(p)
        a = torch.sin(p)
    u = bf16_dot(a, Ws[L - 1]) + bs[L - 1]
    r = Ws[L - 1][:, 0].expand(x.shape[0], -1)
    for k in range(L - 2, -1, -1):
        r = bf16_dot(r * torch.cos(ps[k]), Ws[k].T)
    return u, r


def _lib(name: str):
    from dnnpde_tpu_torch.ops import _build

    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptrs = {"mlp_u_z_fwd": 6, "mlp_u_z_bwd": 9}[name]
        entries = [fn] + ([lib.mlp_u_z_bwd_cluster] if name == "mlp_u_z_bwd" else [])
        for entry in entries:
            entry.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            entry.restype = ctypes.c_int
        if name == "mlp_u_z_bwd":
            size = lib.mlp_u_z_bwd_scratch_bytes
            size.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            size.restype = ctypes.c_longlong
            smem = lib.mlp_u_z_bwd_cluster_smem_bytes
            smem.argtypes = [ctypes.c_void_p, ctypes.c_int]
            smem.restype = ctypes.c_longlong
    return lib


def _check_rows(name: str, t: Tensor, shape: tuple[int, int], device: torch.device) -> None:
    if (t.dim() != 2 or tuple(t.shape) != shape or t.dtype != torch.float32
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous float32 {shape} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def mlp_u_z_fwd(Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor):
    """(u (B,1), Z_full (B,n0)) for a sine MLP at x = [t, X] (B, n0).

    CUDA tensors launch K1 on the current stream; CPU tensors take
    :func:`mlp_u_z_fwd_reference`."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 (B, n0) tensor, got {x.dtype} {tuple(x.shape)}")
    widths = check_mlp(Ws, bs, x.device)
    if x.device.type == "cpu":
        return mlp_u_z_fwd_reference(Ws, bs, x)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_u_z_fwd runs on CUDA or CPU tensors, got {x.device}")
    from dnnpde_tpu_torch.ops import _build

    B, n0 = x.shape
    u = torch.empty((B, 1), dtype=torch.float32, device=x.device)
    z = torch.empty((B, n0), dtype=torch.float32, device=x.device)
    if B == 0:
        return u, z
    lib = _lib("mlp_u_z_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.mlp_u_z_fwd(
            x.data_ptr(), u.data_ptr(), z.data_ptr(),
            _build.pointer_array(Ws), _build.pointer_array(bs),
            _build.int_array(widths), len(Ws), B, stream,
        )
    _build.check(lib, code, "mlp_u_z_fwd")
    tracing.count("ops.mlp_u_z_fwd.calls")
    return u, z


def mlp_u_z_bwd_reference(Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor,
                          u_bar: Tensor, z_bar: Tensor):
    """Plain version of K2: (W_bars, b_bars, x_bar) for cotangents
    (u_bar (B,1), z_bar (B,n0)) of K1's outputs, with bf16 dot operands
    (the math of ``dnnpde_tpu/ops/fused_net_u.py:14-23``)."""
    L = len(Ws)
    a, ps, as_ = x, [], [x]
    for k in range(L - 1):
        p = bf16_dot(a, Ws[k]) + bs[k]
        ps.append(p)
        a = torch.sin(p)
        as_.append(a)
    rs = [None] * L
    rs[L - 1] = Ws[L - 1][:, 0].expand(x.shape[0], -1)
    for k in range(L - 2, 0, -1):
        rs[k] = bf16_dot(rs[k + 1] * torch.cos(ps[k]), Ws[k].T)

    # Z-path adjoint (ascending): c is the cotangent of r_k
    W_bars, b_bars, pz = [None] * L, [None] * L, [None] * (L - 1)
    c = z_bar
    for k in range(L - 1):
        q_bar = bf16_dot(c, Ws[k])
        W_bars[k] = bf16_dot(c.T, rs[k + 1] * torch.cos(ps[k]))
        pz[k] = -q_bar * rs[k + 1] * torch.sin(ps[k])
        c = q_bar * torch.cos(ps[k])

    # u-path (descending), merged with the Z-path's pz
    a_bar = bf16_dot(u_bar, Ws[L - 1].T)
    W_bars[L - 1] = c.sum(0)[:, None] + bf16_dot(as_[L - 1].T, u_bar)
    b_bars[L - 1] = u_bar.sum(0)
    for k in range(L - 2, -1, -1):
        p_bar = a_bar * torch.cos(ps[k]) + pz[k]
        W_bars[k] = W_bars[k] + bf16_dot(as_[k].T, p_bar)
        b_bars[k] = p_bar.sum(0)
        a_bar = bf16_dot(p_bar, Ws[k].T)
    return tuple(W_bars), tuple(b_bars), a_bar


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _cluster_cols(n: int) -> int:
    """Columns of a width-n layer that one CTA of K2's clusters owns: its
    8-column tiles, ``ceil(round16(n) / 8 / CLUSTER_CTAS)`` rounded up to a
    power of two."""
    tiles = (_round16(n) // 8 + CLUSTER_CTAS - 1) // CLUSTER_CTAS
    return 8 * (1 << (tiles - 1).bit_length())


def bwd_cluster_smem_bytes(widths: Sequence[int]) -> int:
    """Shared memory of one CTA of K2's clustered row chain for a net of
    these widths ``[n0, ..., 1]`` (the C side's
    ``mlp_u_z_bwd_cluster_smem_bytes``): its slices of the weights in bf16
    (rows padded by 8), three mbarriers and its f32 inputs, then the larger of
    the prologue's two f32 staging buffers (of column slices) and the
    tile's three bf16
    operands (a block of 16 rows a CTA) with its columns of the f32 state."""
    L = len(widths) - 1
    lw = [_cluster_cols(n) for n in widths]
    slices = sum(2 * CLUSTER_CTAS * lw[k] * (lw[k + 1] + 8) for k in range(L - 1))
    inputs = 8 + 2 * 16 * _round16(widths[0]) + 16 + sum(lw[1:L]) + lw[L - 1]
    stage = max(widths[k] * lw[k + 1] for k in range(L - 1))
    lwmax = max(lw[:L])
    operands = 3 * CLUSTER_CTAS * 16 * (lwmax + 8)
    steady = 2 * operands + 4 * (2 * 16 * sum(lw[1:L]) + 4 * 16 * lwmax)
    return 2 * slices + 4 * inputs + max(steady, 4 * 2 * stage)


def bwd_takes_cluster(widths: Sequence[int], B: int) -> bool:
    """Whether K2's row chain runs on thread-block clusters for B rows of a
    net of these widths: where a CTA's slices and state fit its shared
    memory and B is at most ``CLUSTER_MAX_ROWS``. Both row chains give the
    same bits; this chooses the faster."""
    return B <= CLUSTER_MAX_ROWS and bwd_cluster_smem_bytes(widths) <= MAX_SMEM


def _bwd_launch(entry: str, Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor,
                u_bar: Tensor, z_bar: Tensor, widths: Sequence[int]):
    """K2 through the C entry point ``entry`` (``mlp_u_z_bwd``, the one-block
    row chain, or ``mlp_u_z_bwd_cluster``) on checked CUDA inputs; the
    gradients come back as views of one flat buffer."""
    from dnnpde_tpu_torch.ops import _build

    B, n0 = x.shape
    shapes = [tuple(w.shape) for w in Ws] + [tuple(b.shape) for b in bs]
    sizes = [w.numel() for w in Ws] + [b.numel() for b in bs]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    grads = [g.view(s) for g, s in zip(flat.split(sizes), shapes)]
    x_bar = torch.empty((B, n0), dtype=torch.float32, device=x.device)
    if B == 0:
        flat.zero_()
        return tuple(grads[:len(Ws)]), tuple(grads[len(Ws):]), x_bar
    lib = _lib("mlp_u_z_bwd")
    widths_c = _build.int_array(widths)
    # the weight gradients' bf16 operands and the per-tile column sums
    scratch = torch.empty(lib.mlp_u_z_bwd_scratch_bytes(widths_c, len(Ws), B),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, entry)(
            x.data_ptr(), u_bar.data_ptr(), z_bar.data_ptr(), x_bar.data_ptr(),
            flat.data_ptr(), scratch.data_ptr(),
            _build.pointer_array(Ws), _build.pointer_array(bs),
            widths_c, len(Ws), B, stream,
        )
    _build.check(lib, code, entry)
    return tuple(grads[:len(Ws)]), tuple(grads[len(Ws):]), x_bar


def mlp_u_z_bwd(Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor,
                u_bar: Tensor, z_bar: Tensor):
    """(W_bars, b_bars, x_bar): the gradients of <u, u_bar> + <Z_full, z_bar>
    for a sine MLP at x = [t, X] (B, n0), in the shapes of Ws, bs and x.

    CUDA tensors launch K2 on the current stream (the gradients come back
    as views of one flat buffer), its row chain on clusters where
    :func:`bwd_takes_cluster` says so; CPU tensors take
    :func:`mlp_u_z_bwd_reference`."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 (B, n0) tensor, got {x.dtype} {tuple(x.shape)}")
    B, n0 = x.shape
    _check_rows("u_bar", u_bar, (B, 1), x.device)
    _check_rows("z_bar", z_bar, (B, n0), x.device)
    widths = check_mlp(Ws, bs, x.device)
    if x.device.type == "cpu":
        return mlp_u_z_bwd_reference(Ws, bs, x, u_bar, z_bar)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_u_z_bwd runs on CUDA or CPU tensors, got {x.device}")
    clustered = bwd_takes_cluster(widths, B)
    out = _bwd_launch("mlp_u_z_bwd_cluster" if clustered else "mlp_u_z_bwd",
                      Ws, bs, x, u_bar, z_bar, widths)
    if B > 0:
        tracing.count("ops.mlp_u_z_bwd.calls")
        if clustered:
            tracing.count("ops.mlp_u_z_bwd.cluster_calls")
    return out
