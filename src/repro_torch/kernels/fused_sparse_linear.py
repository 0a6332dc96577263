"""Fused N:M + structured-outlier linear: the production serving path.

Port of the Pallas TPU kernel ``repro/kernels/fused_sparse_linear.py:75``
(``fused_sparse_linear``: ``_kernel`` :31 for bf16 values, ``_kernel_int8``
:50 for int8 values with a per-row scale).  y = x @ (W_nm + O)^T in one
pass, x read once and y written once, by one of two hand-written Hopper
kernels that ``plan`` picks by the number of rows M of x:

- M <= ``DECODE_MAX_M`` (T, decode): ``csrc/fused_sparse_linear.cu``.  The
  lanes of a warp decompress consecutive N:M blocks and the outliers of one
  output row in registers and gather x from a shared-memory slice.
- M > T (prefill chunks): ``csrc/fused_sparse_linear_prefill.cu``.  A ring
  of cp.async stages brings x and the compressed weight stream into shared
  memory; each thread decompresses one 16-column block (and its outliers)
  in registers into a swizzled B tile, and ``wgmma`` tensor-core products
  share it across BM = 64, 128 or 256 rows of x while the next stage is
  decompressed.

Both split K into slices on multiples of 256 where the grid would be too
small and sum the partials in split order in the last block to arrive,
through a workspace cached per device.  Both dequantize int8 N:M values by
their row's scale, rounded once to bf16, and add the exact outliers
unscaled.  ``csrc/sparse_linear.cu``'s tile kernel (OUTLIERS=true), which
served M > T before, stays reachable through ``force_plan=tile_plan(...)``
to be timed beside them; ``plan`` never picks it.  On a CPU tensor the
wrapper runs ``plain``; on a fake CUDA tensor (a dry run) it launches
nothing and records the launch (``common.fake_launch``).  ``plan`` also drives ``nm_spmm``, which runs the
same two bodies without an outlier stream (``o_n = 0``).

Layout: nm_values [out, in*n/m] bf16 (16-byte aligned), or int8 (8-byte
aligned) with ``scale`` [out] f32; nm_meta [out, in/m] int32 (4-bit
indices); o_values [out, in/256, o_n] bf16; o_meta [out, in/256, o_n/4]
int32 (8-bit indices).  in % 256 == 0.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..core.outliers import OUTLIER_M, unpack_outlier_meta
from ..core.packing import unpack_metadata
from . import build
from .common import (H100_SM_COUNT, check_cuda_operands, fake_launch,
                     prefill_splits, scratch_for, sm_count)
from .ref import fused_sparse_linear_ref

launches = 0
"""Launches of the bf16 kernels (either path) made through
``fused_sparse_linear`` (plain runs are not counted)."""
launches_int8 = 0
"""Launches of the int8 kernels made through ``fused_sparse_linear``."""
launches_decode = 0
"""Of ``launches``, those of the decode kernel (M <= T)."""
launches_decode_int8 = 0
"""Of ``launches_int8``, those of the decode kernel (M <= T)."""
launches_prefill = 0
"""Of ``launches``, those of the prefill kernel (M > T)."""
launches_prefill_int8 = 0
"""Of ``launches_int8``, those of the prefill kernel (M > T)."""

DECODE_MAX_M = 8
"""T: the largest M that takes the decode kernel: the largest M at which it
was no slower than the prefill kernel at w_gate and w_down, bf16 and int8,
in the sweep of ``chip_smoke.py``'s phase 2 on an H100 (PERF.md).  A decode
step of 8 lanes still takes the decode kernel; chunks of 9 rows and more
take the prefill kernel."""
BLOCK_ROWS = 32
"""Output rows of one decode block: 8 warps of 4 rows
(``kBlockRows`` in ``csrc/fused_sparse_linear.cu``)."""
X_SLICE_BYTES = 32768
"""Shared memory a decode block stages its x slice in, [columns][R rows]
bf16 (``kMaxSliceBytes``): it bounds the columns per split."""
BLOCKS_PER_SM = 2
"""The split aims at this many decode blocks per SM."""
SM_SHARED_BYTES = 233472
"""Shared memory an H100 SM holds for its blocks (228 KB, of which each
block reserves 1 KB)."""


def prefill_smem_bytes(bm: int, o_n: int) -> int:
    """Shared memory of one prefill block of BM rows and BN = 128 of the
    staged 8:16 instance with bf16 values (``Smem::kTotal`` in
    ``csrc/fused_sparse_linear_prefill.cu``): three ring slots of x tile,
    values, meta and (``o_n`` > 0) the outlier group, two B tiles, 1 KB of
    alignment."""
    bn = 128
    slot = bm * 128 + bn * 64 + bn * 16 + (bn * 48 if o_n else 0)
    return 3 * slot + 2 * bn * 128 + 1024


def prefill_blocks_per_sm(bm: int, o_n: int) -> int:
    """The prefill blocks of BM rows (BN = 128) one SM holds at once, by
    shared memory: with outliers 2 at BM = 64 (105 KB), 1 at 128 (129 KB)
    and 256 (177 KB); without, 2 at 64 (87 KB) and 128 (111 KB), 1 at 256
    (159 KB).  Registers allow as many (at most 128 a thread at BM = 128,
    ``cuobjdump``; PERF.md).  The slots a wave of the prefill grid fills."""
    return SM_SHARED_BYTES // (prefill_smem_bytes(bm, o_n) + 1024)


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str             # "decode", "prefill" or (forced only) "tile"
    rows: int             # x rows per block: decode R = 2, 4 or 8;
    #                       prefill BM = 64 or 128; tile 16 or 64
    splits: int           # S slices of K (always 1 for "tile")
    k_per_split: int      # columns per slice, a multiple of 256
    workspace_bytes: int  # f32 partials [S, M, N]; 0 when S == 1
    blocks: int           # the grid
    counters: int         # int32 arrival counters, one per output tile
    cols: int = BLOCK_ROWS  # output features per block: prefill BN = 64
    #                         or 128; decode 32; tile 64


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, n: int, m: int, o_n: int, sm_count: int,
         *, decode_max_m: int = DECODE_MAX_M) -> Plan:
    """How ``fused_sparse_linear`` (``o_n`` > 0) or ``nm_spmm`` (``o_n`` =
    0: no outlier stream) computes an [M, K] x [N, K]^T product on a card
    with ``sm_count`` SMs.  K counts in slices of 256 columns; without
    outliers K need not be a multiple of 256, and the last slice is cut at
    K (ragged).  For M <= ``decode_max_m`` the decode
    kernel: R x rows per block (x tiles of R rows beyond 8), and the fewest
    splits S of K on multiples of 256 that give ``BLOCKS_PER_SM`` blocks per
    SM and keep each slice within ``X_SLICE_BYTES``.  Otherwise the prefill
    kernel: BM = 64 rows of x per block up to M = 64, else 128, or 256
    (with BN 128) above M = 128 where 256-row tiles still make a quarter
    of a wave; BN = 128 output features, or 64 where 128-wide tiles
    split as far as they go cannot fill one wave of
    ``prefill_blocks_per_sm`` blocks per SM; and the split of K on
    multiples of 256 that ``common.prefill_splits`` picks.  The slices are
    equal but for the last."""
    if (o_n and K % OUTLIER_M) or K < 1 or M < 1 or N < 1:
        raise ValueError(f"plan needs M, N, in >= 1 and, with outliers, "
                         f"in % 256 == 0; got M={M}, in={K}, out={N}, "
                         f"o_n={o_n}")
    groups = -(-K // OUTLIER_M)
    if M > decode_max_m:
        bm = 64 if M <= 64 else 128
        if M > 128 and (-(-M // 256) * -(-N // 128) * 4
                        >= prefill_blocks_per_sm(256, o_n) * sm_count):
            bm = 256
        wave = prefill_blocks_per_sm(bm, o_n) * sm_count
        m_tiles = -(-M // bm)
        bn = 128 if (bm == 256
                     or -(-N // 128) * m_tiles * groups >= wave) else 64
        tiles = -(-N // bn) * m_tiles
        splits = prefill_splits(tiles, groups, wave)
        return Plan("prefill", bm, splits,
                    -(-groups // splits) * OUTLIER_M,
                    splits * M * N * 4 if splits > 1 else 0,
                    tiles * splits, tiles if splits > 1 else 0, bn)
    rows = 2 if M <= 2 else 4 if M <= 4 else 8
    tiles = -(-M // rows)
    row_blocks = -(-N // BLOCK_ROWS)
    max_groups = max(1, X_SLICE_BYTES // (2 * rows) // OUTLIER_M)
    want = -(-BLOCKS_PER_SM * sm_count // (row_blocks * tiles))
    splits = min(groups, max(want, -(-groups // max_groups)))
    per = -(-groups // splits)
    splits = -(-groups // per)
    return Plan("decode", rows, splits, per * OUTLIER_M,
                splits * M * N * 4 if splits > 1 else 0,
                row_blocks * tiles * splits,
                row_blocks * tiles if splits > 1 else 0)


def tile_plan(M: int, K: int, N: int) -> Plan:
    """The plan of ``csrc/sparse_linear.cu``'s tile kernel (OUTLIERS=true),
    which served M > T before the prefill kernel: only for ``force_plan``,
    to time it beside the kernels ``plan`` picks."""
    bm = 16 if M <= 16 else 64
    return Plan("tile", bm, 1, K, 0, -(-N // 64) * -(-M // bm), 0, 64)


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
                        scale: torch.Tensor | None = None,
                        force_plan: Plan | None = None) -> torch.Tensor:
    """y[b, out] = x[b, in] @ (W_nm + O)^T, y in x's dtype.  ``scale``
    [out] f32 dequantizes int8 ``nm_values``; None for bf16.  ``force_plan``
    replaces ``plan``'s choice (to time one kernel against another)."""
    global launches, launches_int8, launches_decode, launches_decode_int8
    global launches_prefill, launches_prefill_int8
    if not x.is_cuda:
        return plain(x, nm_values, nm_meta, o_values, o_meta, n=n, m=m,
                     o_n=o_n, scale=scale)
    if isinstance(x, FakeTensor):
        K, N = x.shape[-1], nm_values.shape[0]
        return fake_launch(
            "fused_sparse_linear" + ("" if scale is None else "_int8"), x,
            (nm_values, nm_meta, o_values, o_meta, scale), N,
            lambda: force_plan or plan(x.shape[0], K, N, n, m, o_n,
                                       H100_SM_COUNT),
            K * n // m + K // OUTLIER_M * o_n)
    M, K, N = check_cuda_operands(x, nm_values, nm_meta, n, m, scale)
    if K % OUTLIER_M or o_n % 4 or not 0 < o_n <= OUTLIER_M:
        raise ValueError(f"fused kernel needs in % 256 == 0 and o_n a "
                         f"positive multiple of 4; got in={K}, o_n={o_n}")
    if scale is None and nm_values.data_ptr() % 16:
        raise ValueError("bf16 values must be 16-byte aligned")
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
    p = force_plan or plan(M, K, N, n, m, o_n, sm_count(x.device))
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x.data_ptr(), nm_values.data_ptr(), nm_meta.data_ptr(),
            o_values.data_ptr(), o_meta.data_ptr()]
    if scale is not None:
        ptrs.append(scale.data_ptr())
    suffix = "_bf16" if scale is None else "_int8"
    if p.path == "tile":
        status = getattr(lib, "fused_sparse_linear" + suffix)(
            *ptrs, y.data_ptr(), M, K, N, n, m, o_n, stream)
    else:
        ws, cnt = scratch_for(x.device, p)
        tiles = ((p.rows,) if p.path == "decode" else (p.rows, p.cols))
        status = getattr(lib, f"fused_sparse_linear_{p.path}{suffix}")(
            *ptrs, y.data_ptr(), ws.data_ptr(), cnt.data_ptr(), M, K, N, n,
            m, o_n, *tiles, p.splits, p.k_per_split, stream)
    decode, prefill = p.path == "decode", p.path == "prefill"
    if scale is None:
        launches += 1
        launches_decode += decode
        launches_prefill += prefill
    else:
        launches_int8 += 1
        launches_decode_int8 += decode
        launches_prefill_int8 += prefill
    build.check(status, f"fused_sparse_linear ({p.path})")
    return y

