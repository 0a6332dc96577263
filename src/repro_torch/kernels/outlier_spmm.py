"""Structured N:256 salient-weight ("outlier") matmul, y = x @ O^T.

Port of the Pallas TPU kernel ``repro/kernels/outlier_spmm.py:74``
(``outlier_spmm``: ``_kernel`` :55, ``_decompress_outlier_tile`` :44).  On a
CUDA tensor the wrapper launches the hand-written Hopper kernel of
``csrc/outlier_spmm.cu``: where the Pallas body decompresses each 256-wide
tile to dense and runs a dense product (16-64x the work at 6.25-1.56%
density), the CUDA kernel walks each output row's (value, 8-bit index)
pairs as a gather list against an x tile in shared memory.  On a CPU
tensor it runs ``plain``.

Layout (``core/outliers.py``): values [out, in/256, n] bf16 with n a
multiple of 4 (4, 8, 16 in the paper); meta [out, in/256, n/4] int32, four
8-bit indices per word.  in % 256 == 0.
"""
from __future__ import annotations

import torch

from ..core.outliers import OUTLIER_M, unpack_outlier_meta
from . import build
from .ref import outlier_spmm_ref

launches = 0
"""Launches of the kernel made through ``outlier_spmm`` (plain runs are not
counted)."""


def plain(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *,
          n: int) -> torch.Tensor:
    """The plain PyTorch version: unpack the indices, decompress, f32
    matmul."""
    return outlier_spmm_ref(x, values, unpack_outlier_meta(meta, n))


def check_cuda_operands(x: torch.Tensor, values: torch.Tensor,
                        meta: torch.Tensor, n: int) -> tuple:
    """Validate what the CUDA kernel takes (bf16 ``x`` and ``values``
    8-byte aligned, int32 ``meta``, all contiguous on one device); returns
    (M, K, N)."""
    if x.ndim != 2:
        raise ValueError(f"x must be [M, in], got shape {tuple(x.shape)}")
    M, K = x.shape
    N = values.shape[0]
    if K % OUTLIER_M or K == 0:
        raise ValueError(f"in dim {K} must be a positive multiple of "
                         f"{OUTLIER_M}")
    if n % 4 or not 0 < n <= OUTLIER_M:
        raise ValueError(f"outlier count {n} must be a positive multiple of 4")
    groups = K // OUTLIER_M
    if tuple(values.shape) != (N, groups, n) or \
            tuple(meta.shape) != (N, groups, n // 4):
        raise ValueError(f"values {tuple(values.shape)} / meta "
                         f"{tuple(meta.shape)} do not match in={K}, n={n}")
    for name, t, dtype in (("x", x, torch.bfloat16),
                           ("values", values, torch.bfloat16),
                           ("meta", meta, torch.int32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if values.data_ptr() % 8:
        raise ValueError("values must be 8-byte aligned")
    return M, K, N


def outlier_spmm(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor,
                 *, n: int) -> torch.Tensor:
    """y[b, out] = x[b, in] @ O^T, y in x's dtype, f32 accumulation."""
    global launches
    if not x.is_cuda:
        return plain(x, values, meta, n=n)
    M, K, N = check_cuda_operands(x, values, meta, n)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    status = build.library().outlier_spmm_bf16(
        x.data_ptr(), values.data_ptr(), meta.data_ptr(), y.data_ptr(),
        M, K, N, n, torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    build.check(status, "outlier_spmm")
    return y
