"""N:M-compressed weight x dense activation matmul.

Port of the Pallas TPU kernel ``repro/kernels/nm_spmm.py:86`` (``nm_spmm``).
On a CUDA tensor the wrapper launches the hand-written Hopper kernel of
``csrc/sparse_linear.cu`` (OUTLIERS=false): it decompresses each 256-wide
K step of the packed tile into shared memory and runs bf16 tensor-core
products with f32 accumulation.  On a CPU tensor it runs ``plain``.

Layout (``core/packing.py``): values [out, in*n/m] bf16, meta [out, in/m]
int32 with n 4-bit indices per word.
"""
from __future__ import annotations

import torch

from ..core.packing import unpack_metadata
from . import build
from .ref import nm_spmm_ref

launches = 0
"""Kernel launches made through ``nm_spmm`` (plain runs are not counted)."""


def plain(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *,
          n: int, m: int) -> torch.Tensor:
    """The plain PyTorch version: unpack, decompress, f32 matmul."""
    return nm_spmm_ref(x, values, unpack_metadata(meta, n), m)


def check_cuda_operands(x: torch.Tensor, values: torch.Tensor,
                        meta: torch.Tensor, n: int, m: int) -> tuple:
    """Validate what the CUDA kernels take; returns (M, K, N)."""
    if x.ndim != 2:
        raise ValueError(f"x must be [M, in], got shape {tuple(x.shape)}")
    M, K = x.shape
    N = values.shape[0]
    if n > 8 or m > 16 or 256 % m:
        raise ValueError(f"the kernel takes n<=8 and m in (4, 8, 16); "
                         f"got {n}:{m}")
    if K % m or K % 8:
        raise ValueError(f"in dim {K} must be a multiple of m={m} and of 8")
    if values.shape != (N, K // m * n) or meta.shape != (N, K // m):
        raise ValueError(f"values {tuple(values.shape)} / meta "
                         f"{tuple(meta.shape)} do not match in={K}, {n}:{m}")
    for name, t, dtype in (("x", x, torch.bfloat16),
                           ("values", values, torch.bfloat16),
                           ("meta", meta, torch.int32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    return M, K, N


def nm_spmm(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *,
            n: int, m: int) -> torch.Tensor:
    """y[b, out] = x[b, in] @ decompress(values, meta)^T, y in x's dtype."""
    global launches
    if not x.is_cuda:
        return plain(x, values, meta, n=n, m=m)
    M, K, N = check_cuda_operands(x, values, meta, n, m)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    status = build.library().nm_spmm_bf16(
        x.data_ptr(), values.data_ptr(), meta.data_ptr(), y.data_ptr(),
        M, K, N, n, m, torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    build.check(status, "nm_spmm")
    return y
