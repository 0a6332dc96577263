"""N:M-compressed weight x dense activation matmul.

Port of the Pallas TPU kernel ``repro/kernels/nm_spmm.py:86`` (``nm_spmm``:
``_kernel`` :46 for bf16 values, ``_kernel_int8`` :63 for int8 values with a
per-row scale).  On a CUDA tensor the wrapper launches the hand-written
Hopper kernel of ``csrc/sparse_linear.cu`` (OUTLIERS=false): it
decompresses (and, for int8, dequantizes) each 256-wide K step of the
packed tile into shared memory and runs bf16 tensor-core products with f32
accumulation.  On a CPU tensor it runs ``plain``.

Layout (``core/packing.py``): values [out, in*n/m] bf16, or int8 with
``scale`` [out] f32; meta [out, in/m] int32 with n 4-bit indices per word.
"""
from __future__ import annotations

import torch

from ..core.packing import unpack_metadata
from . import build
from .ref import nm_spmm_ref

launches = 0
"""Launches of the bf16 kernel made through ``nm_spmm`` (plain runs are not
counted)."""
launches_int8 = 0
"""Launches of the int8 kernel made through ``nm_spmm``."""


def plain(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *,
          n: int, m: int, scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: unpack, dequantize (int8), decompress,
    f32 matmul."""
    return nm_spmm_ref(x, values, unpack_metadata(meta, n), m, scale)


def check_cuda_operands(x: torch.Tensor, values: torch.Tensor,
                        meta: torch.Tensor, n: int, m: int,
                        scale: torch.Tensor | None = None) -> tuple:
    """Validate what the CUDA kernels take: bf16 ``values`` with no
    ``scale``, or int8 ``values`` (8-byte aligned) with an f32 ``scale``
    [out]; returns (M, K, N)."""
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
    operands = [("x", x, torch.bfloat16), ("meta", meta, torch.int32)]
    if scale is None:
        operands.append(("values", values, torch.bfloat16))
    else:
        if tuple(scale.shape) != (N,):
            raise ValueError(f"scale must be [{N}], got {tuple(scale.shape)}")
        operands += [("values", values, torch.int8),
                     ("scale", scale, torch.float32)]
        if values.data_ptr() % 8:
            raise ValueError("int8 values must be 8-byte aligned")
    for name, t, dtype in operands:
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
            n: int, m: int, scale: torch.Tensor | None = None) -> torch.Tensor:
    """y[b, out] = x[b, in] @ decompress(values, meta)^T, y in x's dtype.
    ``scale`` [out] f32 dequantizes int8 ``values``; None for bf16."""
    global launches, launches_int8
    if not x.is_cuda:
        return plain(x, values, meta, n=n, m=m, scale=scale)
    M, K, N = check_cuda_operands(x, values, meta, n, m, scale)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if scale is None:
        status = lib.nm_spmm_bf16(
            x.data_ptr(), values.data_ptr(), meta.data_ptr(), y.data_ptr(),
            M, K, N, n, m, stream)
        launches += 1
    else:
        status = lib.nm_spmm_int8(
            x.data_ptr(), values.data_ptr(), meta.data_ptr(),
            scale.data_ptr(), y.data_ptr(), M, K, N, n, m, stream)
        launches_int8 += 1
    build.check(status, "nm_spmm")
    return y
