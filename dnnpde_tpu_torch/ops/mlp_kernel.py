"""K1: the fused sine-MLP ``(u, Z_full)`` forward on a hand-written CUDA kernel.

Counterpart of ``dnnpde_tpu/ops/mlp_kernel.py::mlp_u_z_fwd_pallas``. The
kernel (``csrc/mlp_u_z_fwd.cu``) runs the forward pass and the Z-sweep for a
tile of rows with the tile's activations in shared memory; only x, u and Z
touch device memory. Matmul operands are rounded to bf16 and accumulated in
f32, as on the TPU.

``mlp_u_z_fwd`` launches the kernel for CUDA tensors and raises on anything
it does not take. For CPU tensors it computes the plain version,
``mlp_u_z_fwd_reference``: the same bf16-operand math in PyTorch, which
differs from the kernel only in the order of summation.
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


def _lib():
    from dnnpde_tpu_torch.ops import _build

    lib = _build.load("mlp_u_z_fwd")
    fn = lib.mlp_u_z_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


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
    lib = _lib()
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
