"""K1 and K2: the fused sine-MLP ``(u, Z_full)`` forward and its hand-derived
backward on hand-written CUDA kernels.

Counterparts of ``dnnpde_tpu/ops/mlp_kernel.py::mlp_u_z_fwd_pallas`` and
``mlp_u_z_bwd_pallas``. K1 (``csrc/mlp_u_z_fwd.cu``) runs the forward pass
and the Z-sweep for a tile of rows on tensor cores (``mma.sync``), with the
tile's activations in shared memory; only x, u and Z touch device memory.
K2 (``csrc/mlp_u_z_bwd.cu``) is two launches on tensor cores: a row chain,
one block per 16-row tile, recomputes K1's forward with K1's own layer, bit
for bit, runs the Z-path adjoint and the u-path backward on that same layer
and writes x_bar, the weight gradients' bf16 operands and per-tile column
sums to a scratch buffer; a second kernel forms each weight gradient as one
product over the batch, a block per output tile, and sums the column sums
in tile order. Matmul operands are rounded to bf16 and accumulated in f32,
as on the TPU.

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

Tensor = torch.Tensor

MAX_LAYERS = 8  # DNNPDE_MAX_LAYERS in csrc/common.cuh


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
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if name == "mlp_u_z_bwd":
            size = lib.mlp_u_z_bwd_scratch_bytes
            size.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            size.restype = ctypes.c_longlong
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
    mlp_u_z_fwd.launches += 1
    return u, z


mlp_u_z_fwd.launches = 0


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


def mlp_u_z_bwd(Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor,
                u_bar: Tensor, z_bar: Tensor):
    """(W_bars, b_bars, x_bar): the gradients of <u, u_bar> + <Z_full, z_bar>
    for a sine MLP at x = [t, X] (B, n0), in the shapes of Ws, bs and x.

    CUDA tensors launch K2 on the current stream (the gradients come back
    as views of one flat buffer); CPU tensors take
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
    from dnnpde_tpu_torch.ops import _build

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
        code = lib.mlp_u_z_bwd(
            x.data_ptr(), u_bar.data_ptr(), z_bar.data_ptr(), x_bar.data_ptr(),
            flat.data_ptr(), scratch.data_ptr(),
            _build.pointer_array(Ws), _build.pointer_array(bs),
            widths_c, len(Ws), B, stream,
        )
    _build.check(lib, code, "mlp_u_z_bwd")
    mlp_u_z_bwd.launches += 1
    return tuple(grads[:len(Ws)]), tuple(grads[len(Ws):]), x_bar


mlp_u_z_bwd.launches = 0
