"""Fused N:M + structured-outlier linear: the production serving path.

Port of the Pallas TPU kernel ``repro/kernels/fused_sparse_linear.py:75``
(``fused_sparse_linear``: ``_kernel`` :31 for bf16 values, ``_kernel_int8``
:50 for int8 values with a per-row scale).  y = x @ (W_nm + O)^T in one
pass: both compressed streams are decompressed into the same shared-memory
tile of the hand-written Hopper kernel (``csrc/sparse_linear.cu``,
OUTLIERS=true), so x is read once and y written once.  int8 N:M values are
dequantized by their row's scale as they land in the tile, and the exact
outliers are added after, unscaled.  On a CPU tensor the wrapper runs
``plain``.

Layout: nm_values [out, in*n/m] bf16, or int8 with ``scale`` [out] f32;
nm_meta [out, in/m] int32 (4-bit indices); o_values [out, in/256, o_n]
bf16; o_meta [out, in/256, o_n/4] int32 (8-bit indices).  in % 256 == 0.
"""
from __future__ import annotations

import torch

from ..core.outliers import OUTLIER_M, unpack_outlier_meta
from ..core.packing import unpack_metadata
from . import build
from .nm_spmm import check_cuda_operands
from .ref import fused_sparse_linear_ref

launches = 0
"""Launches of the bf16 kernel made through ``fused_sparse_linear`` (plain
runs are not counted)."""
launches_int8 = 0
"""Launches of the int8 kernel made through ``fused_sparse_linear``."""


def plain(x: torch.Tensor, nm_values: torch.Tensor, nm_meta: torch.Tensor,
          o_values: torch.Tensor, o_meta: torch.Tensor, *, n: int, m: int,
          o_n: int, scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: unpack both streams, dequantize the N:M
    values (int8), decompress, f32 matmul."""
    return fused_sparse_linear_ref(x, nm_values, unpack_metadata(nm_meta, n),
                                   m, o_values,
                                   unpack_outlier_meta(o_meta, o_n),
                                   scale=scale)


def fused_sparse_linear(x: torch.Tensor, nm_values: torch.Tensor,
                        nm_meta: torch.Tensor, o_values: torch.Tensor,
                        o_meta: torch.Tensor, *, n: int, m: int, o_n: int,
                        scale: torch.Tensor | None = None) -> torch.Tensor:
    """y[b, out] = x[b, in] @ (W_nm + O)^T, y in x's dtype.  ``scale``
    [out] f32 dequantizes int8 ``nm_values``; None for bf16."""
    global launches, launches_int8
    if not x.is_cuda:
        return plain(x, nm_values, nm_meta, o_values, o_meta, n=n, m=m,
                     o_n=o_n, scale=scale)
    M, K, N = check_cuda_operands(x, nm_values, nm_meta, n, m, scale)
    if K % OUTLIER_M or o_n % 4 or not 0 < o_n <= OUTLIER_M:
        raise ValueError(f"fused kernel needs in % 256 == 0 and o_n a "
                         f"positive multiple of 4; got in={K}, o_n={o_n}")
    groups = K // OUTLIER_M
    for name, t, shape, dtype in (
            ("o_values", o_values, (N, groups, o_n), torch.bfloat16),
            ("o_meta", o_meta, (N, groups, o_n // 4), torch.int32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if scale is None:
        status = lib.fused_sparse_linear_bf16(
            x.data_ptr(), nm_values.data_ptr(), nm_meta.data_ptr(),
            o_values.data_ptr(), o_meta.data_ptr(), y.data_ptr(),
            M, K, N, n, m, o_n, stream)
        launches += 1
    else:
        status = lib.fused_sparse_linear_int8(
            x.data_ptr(), nm_values.data_ptr(), nm_meta.data_ptr(),
            o_values.data_ptr(), o_meta.data_ptr(), scale.data_ptr(),
            y.data_ptr(), M, K, N, n, m, o_n, stream)
        launches_int8 += 1
    build.check(status, "fused_sparse_linear")
    return y
