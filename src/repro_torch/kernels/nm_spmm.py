"""N:M-compressed weight x dense activation matmul.

Port of the Pallas TPU kernel ``repro/kernels/nm_spmm.py:86`` (``nm_spmm``:
``_kernel`` :46 for bf16 values, ``_kernel_int8`` :63 for int8 values with a
per-row scale).  On a CUDA tensor the wrapper launches the fused kernels'
two Hopper bodies instantiated without an outlier stream, by the plan
``fused_sparse_linear.plan`` makes at ``o_n = 0``:

- M <= ``fused_sparse_linear.DECODE_MAX_M`` (T):
  ``csrc/fused_sparse_linear.cu`` (``nm_decode_816_kernel``,
  ``nm_decode_kernel``): the lanes of a warp
  decompress consecutive N:M blocks in registers and gather x from a
  shared-memory slice, K split across blocks.
- M > T: ``csrc/fused_sparse_linear_prefill.cu`` (``nm_prefill_816_kernel``,
  ``nm_prefill_kernel``): a cp.async ring, each thread decompressing a
  16-column block in registers into a swizzled tile that ``wgmma`` products
  share across BM rows of x.

K need only be a multiple of m and of 8: the plan cuts it in slices of 256
columns but for a ragged last one.  Both dequantize int8 values by their
row's scale, rounded once to bf16.  ``csrc/sparse_linear.cu``'s tile kernel
(OUTLIERS=false), which served every M before, stays reachable through
``force_plan=fused_sparse_linear.tile_plan(...)`` to be timed beside them;
the plan never picks it.  On a CPU tensor the wrapper runs ``plain``; on
a fake CUDA tensor (a dry run) it launches nothing and records the launch
(``common.fake_launch``).

Layout (``core/packing.py``): values [out, in*n/m] bf16, or int8 (8-byte
aligned) with ``scale`` [out] f32; meta [out, in/m] int32 with n 4-bit
indices per word.  Unaligned bf16 values take the kernels' generic
instances.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..core.packing import unpack_metadata
from . import build
from .common import (H100_SM_COUNT, check_cuda_operands, fake_launch,
                     scratch_for, sm_count)
from .fused_sparse_linear import Plan, plan
from .ref import nm_spmm_ref

launches = 0
"""Launches of the bf16 kernels (any path) made through ``nm_spmm`` (plain
runs are not counted)."""
launches_int8 = 0
"""Launches of the int8 kernels made through ``nm_spmm``."""
launches_decode = 0
"""Of ``launches``, those of the decode kernel (M <= T)."""
launches_decode_int8 = 0
"""Of ``launches_int8``, those of the decode kernel (M <= T)."""
launches_prefill = 0
"""Of ``launches``, those of the prefill kernel (M > T)."""
launches_prefill_int8 = 0
"""Of ``launches_int8``, those of the prefill kernel (M > T)."""


def plain(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *,
          n: int, m: int, scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: unpack, dequantize (int8), decompress,
    f32 matmul."""
    return nm_spmm_ref(x, values, unpack_metadata(meta, n), m, scale)


def nm_spmm(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *,
            n: int, m: int, scale: torch.Tensor | None = None,
            force_plan: Plan | None = None) -> torch.Tensor:
    """y[b, out] = x[b, in] @ decompress(values, meta)^T, y in x's dtype.
    ``scale`` [out] f32 dequantizes int8 ``values``; None for bf16.
    ``force_plan`` replaces the plan's choice (to time one kernel against
    another)."""
    global launches, launches_int8, launches_decode, launches_decode_int8
    global launches_prefill, launches_prefill_int8
    if not x.is_cuda:
        return plain(x, values, meta, n=n, m=m, scale=scale)
    if isinstance(x, FakeTensor):
        K, N = x.shape[-1], values.shape[0]
        return fake_launch(
            "nm_spmm" + ("" if scale is None else "_int8"), x,
            (values, meta, scale), N,
            lambda: force_plan or plan(x.shape[0], K, N, n, m, 0,
                                       H100_SM_COUNT), K * n // m)
    M, K, N = check_cuda_operands(x, values, meta, n, m, scale)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    p = force_plan or plan(M, K, N, n, m, 0, sm_count(x.device))
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x.data_ptr(), values.data_ptr(), meta.data_ptr()]
    if scale is not None:
        ptrs.append(scale.data_ptr())
    suffix = "_bf16" if scale is None else "_int8"
    if p.path == "tile":
        status = getattr(lib, "nm_spmm" + suffix)(
            *ptrs, y.data_ptr(), M, K, N, n, m, stream)
    else:
        ws, cnt = scratch_for(x.device, p)
        tiles = ((p.rows,) if p.path == "decode" else (p.rows, p.cols))
        status = getattr(lib, f"nm_spmm_{p.path}{suffix}")(
            *ptrs, y.data_ptr(), ws.data_ptr(), cnt.data_ptr(), M, K, N, n,
            m, *tiles, p.splits, p.k_per_split, stream)
    decode, prefill = p.path == "decode", p.path == "prefill"
    if scale is None:
        launches += 1
        launches_decode += decode
        launches_prefill += prefill
    else:
        launches_int8 += 1
        launches_decode_int8 += decode
        launches_prefill_int8 += prefill
    build.check(status, f"nm_spmm ({p.path})")
    return y
