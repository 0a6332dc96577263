"""Structured N:256 salient-weight ("outlier") matmul, y = x @ O^T.

Port of the Pallas TPU kernel ``repro/kernels/outlier_spmm.py:74``
(``outlier_spmm``: ``_kernel`` :55, ``_decompress_outlier_tile`` :44).  On a
CUDA tensor the wrapper launches one of the two hand-written Hopper bodies
of ``csrc/outlier_spmm.cu``, by ``plan`` on the rows M of x; where the
Pallas body decompresses each 256-wide tile to dense and runs a dense
product (16-64x the work at 6.25-1.56% density), both walk each output
row's (value, 8-bit index) pairs as a gather list against x in shared
memory:

- M <= ``DECODE_MAX_M`` (T), and every M for an n other than 4, 8, 16:
  the decode body.  Lanes take the list's index words, a block stages its
  K slice of x once for 32-128 output rows, K is split on multiples of 256
  so the grid holds two blocks an SM, and a warp reduce-scatter finishes
  the sums.
- M > T: the prefill body.  Lanes take rows of x (2, or 4 above M = 64),
  so the sums stay in registers; x is staged once for 128 or 256 output
  rows, the lists are decoded on the way into shared memory, and K is
  split only where the output tiles do not fill the card.

Splits are summed in split order by the last block to arrive for an
output tile, through a workspace cached per device (``common.scratch_for``).
The first kernel, ``csrc/outlier_spmm_gather8.cu`` (16 output rows by 8 x
rows a block), stays reachable through ``force_plan=gather8_plan(...)`` to
be timed beside them; ``plan`` never picks it.  On a CPU tensor the
wrapper runs ``plain``; on a fake CUDA tensor (a dry run) it launches
nothing and records the launch (``common.fake_launch``).

Layout (``core/outliers.py``): values [out, in/256, n] bf16 with n a
multiple of 4 (4, 8, 16 in the paper); meta [out, in/256, n/4] int32, four
8-bit indices per word.  in % 256 == 0.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..core.outliers import OUTLIER_M, unpack_outlier_meta
from . import build
from .common import (H100_SM_COUNT, fake_launch, prefill_splits, scratch_for,
                     sm_count)
from .ref import outlier_spmm_ref

launches = 0
"""Launches made through ``outlier_spmm`` (plain runs are not counted):
either body, and the old kernel when forced."""
launches_decode = 0
"""Of ``launches``, those of the decode body."""
launches_prefill = 0
"""Of ``launches``, those of the prefill body."""

DECODE_MAX_M = 8
"""T: the largest M that takes the decode body: the largest M at which it
was no slower than the prefill body at w_gate and w_down, 16:256 and
4:256, in the sweep of ``chip_smoke.py``'s phase 2 on an H100
(PERF.md)."""
PREFILL_N = (4, 8, 16)
"""The outlier counts the prefill body is compiled for."""
DECODE_BATCH_ROWS = 32
"""Output rows a decode block covers at once: 8 warps of 4 rows; a block
covers 1, 2 or 4 such batches."""
X_SLICE_BYTES = 32768
"""Shared memory a decode block stages its x slice in, [columns][R rows]
bf16 (``kMaxSliceBytes``): it bounds the columns per split."""
BLOCKS_PER_SM = 2
"""Decode blocks an SM holds at once (``__launch_bounds__``): the wave the
decode grid aims to fill."""
SM_SHARED_BYTES = 233472
"""Shared memory an H100 SM holds for its blocks (228 KB, of which each
block reserves 1 KB)."""


def prefill_cols(rows: int) -> int:
    """Output rows of one prefill block of ``rows`` (BM) x rows: 16 a warp,
    BM / 8 warps (``Prefill::kBN``)."""
    return 2 * rows


def prefill_smem_bytes(rows: int, n: int) -> int:
    """Shared memory of one prefill block of ``rows`` (BM) x rows
    (``Prefill::kSmem``): two slots, each an x group [256][BM + 4] bf16 and
    the decoded lists of its output rows, n (value, offset) pairs of 8
    bytes a row."""
    return 2 * (256 * (rows // 2 + 2) * 4 + prefill_cols(rows) * n * 8)


def prefill_blocks_per_sm(rows: int, n: int) -> int:
    """The prefill blocks one SM holds at once: by shared memory, and by
    registers (``__launch_bounds__``: two blocks of 256 threads at BM = 64,
    one of 512 at BM = 128)."""
    return min(SM_SHARED_BYTES // (prefill_smem_bytes(rows, n) + 1024),
               2 if rows == 64 else 1)


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str             # "decode", "prefill" or (forced only) "gather8"
    rows: int             # x rows a tile: decode R = 2, 4 or 8; prefill
    #                       BM = 64 or 128; gather8 8
    cols: int             # output rows a block: decode 32, 64 or 128;
    #                       prefill 2 * BM; gather8 16
    splits: int           # S slices of K (always 1 for "gather8")
    k_per_split: int      # columns per slice, a multiple of 256
    workspace_bytes: int  # f32 partials [S, M, N]; 0 when S == 1
    blocks: int           # the grid
    counters: int         # int32 arrival counters, one per output tile


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, n: int, sm_count: int, *,
         decode_max_m: int = DECODE_MAX_M) -> Plan:
    """How ``outlier_spmm`` computes an [M, K] x [N, K]^T product with n
    outliers in every 256 columns on a card with ``sm_count`` SMs.

    M <= ``decode_max_m`` (or n not in ``PREFILL_N``): the decode body, R
    x rows a tile (2, 4 or 8, by M), and the grid of ``decode_plan``.
    Otherwise the prefill body: BM = 64 x rows a block up to M = 64, else
    128, by 2 * BM output rows, and the split of K that
    ``common.prefill_splits`` picks for a wave of
    ``prefill_blocks_per_sm`` blocks an SM (none when the tiles fill it).
    The slices are equal but for the last."""
    if K % OUTLIER_M or K < 1 or M < 1 or N < 1 or n % 4 or \
            not 0 < n <= OUTLIER_M:
        raise ValueError(f"plan needs M, N >= 1, in a positive multiple of "
                         f"256 and n a positive multiple of 4; got M={M}, "
                         f"in={K}, out={N}, n={n}")
    groups = K // OUTLIER_M
    if M > decode_max_m and n in PREFILL_N:
        bm = 64 if M <= 64 else 128
        tiles = -(-N // prefill_cols(bm)) * -(-M // bm)
        splits = prefill_splits(tiles, groups,
                                prefill_blocks_per_sm(bm, n) * sm_count)
        per = -(-groups // splits)
        return Plan("prefill", bm, prefill_cols(bm), splits, per * OUTLIER_M,
                    splits * M * N * 4 if splits > 1 else 0, tiles * splits,
                    tiles if splits > 1 else 0)
    return decode_plan(M, K, N, 2 if M <= 2 else 4 if M <= 4 else 8,
                       sm_count)


def decode_plan(M: int, K: int, N: int, rows: int, sm_count: int) -> Plan:
    """The decode body's grid for tiles of ``rows`` x rows: of the blocks
    of 128, 64 or 32 output rows and the splits of K into equal slices of
    whole groups (each within ``X_SLICE_BYTES``), the grid with the most
    blocks that still fit one wave of ``BLOCKS_PER_SM`` blocks an SM (or,
    where none fits, the fewest); ties to fewer splits, then to taller
    blocks."""
    groups = K // OUTLIER_M
    tiles = -(-M // rows)
    wave = BLOCKS_PER_SM * sm_count
    max_per = max(1, X_SLICE_BYTES // (2 * rows) // OUTLIER_M)
    best = None
    for cols in (128, 64, DECODE_BATCH_ROWS):
        row_blocks = -(-N // cols)
        for splits in range(-(-groups // max_per), groups + 1):
            per = -(-groups // splits)
            if -(-groups // per) != splits:
                continue                      # not an equal split
            blocks = row_blocks * tiles * splits
            key = ((blocks > wave, -blocks if blocks <= wave else blocks),
                   splits, -cols)
            if best is None or key < best[0]:
                best = (key, cols, splits, per, row_blocks)
    _, cols, splits, per, row_blocks = best
    return Plan("decode", rows, cols, splits, per * OUTLIER_M,
                splits * M * N * 4 if splits > 1 else 0,
                row_blocks * tiles * splits,
                row_blocks * tiles if splits > 1 else 0)


def gather8_plan(M: int, K: int, N: int) -> Plan:
    """The plan of ``csrc/outlier_spmm_gather8.cu``, the first kernel (16
    output rows by 8 x rows a block, all of K): only for ``force_plan``, to
    time it beside the bodies ``plan`` picks."""
    return Plan("gather8", 8, 16, 1, K, 0, -(-N // 16) * -(-M // 8), 0)


def plain(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *,
          n: int) -> torch.Tensor:
    """The plain PyTorch version: unpack the indices, decompress, f32
    matmul."""
    return outlier_spmm_ref(x, values, unpack_outlier_meta(meta, n))


def check_cuda_operands(x: torch.Tensor, values: torch.Tensor,
                        meta: torch.Tensor, n: int) -> tuple:
    """Validate what the CUDA kernels take (bf16 ``x`` 16-byte aligned,
    bf16 ``values`` 8-byte aligned, int32 ``meta``, all contiguous on one
    device); returns (M, K, N)."""
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
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    return M, K, N


def outlier_spmm(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor,
                 *, n: int, force_plan: Plan | None = None) -> torch.Tensor:
    """y[b, out] = x[b, in] @ O^T, y in x's dtype, f32 accumulation.
    ``force_plan`` replaces ``plan``'s choice (to time one body against
    another, or the old kernel)."""
    global launches, launches_decode, launches_prefill
    if not x.is_cuda:
        return plain(x, values, meta, n=n)
    if isinstance(x, FakeTensor):
        K, N = x.shape[-1], values.shape[0]
        return fake_launch(
            "outlier_spmm", x, (values, meta), N,
            lambda: force_plan or plan(x.shape[0], K, N, n, H100_SM_COUNT),
            K // OUTLIER_M * n)
    M, K, N = check_cuda_operands(x, values, meta, n)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    p = force_plan or plan(M, K, N, n, sm_count(x.device))
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), values.data_ptr(), meta.data_ptr(), y.data_ptr())
    if p.path == "gather8":
        status = lib.outlier_spmm_gather8_bf16(*ptrs, M, K, N, n, stream)
    else:
        ws, cnt = scratch_for(x.device, p)
        status = getattr(lib, f"outlier_spmm_{p.path}_bf16")(
            *ptrs, ws.data_ptr(), cnt.data_ptr(), M, K, N, n, p.rows, p.cols,
            p.splits, p.k_per_split, stream)
    launches += 1
    launches_decode += p.path == "decode"
    launches_prefill += p.path == "prefill"
    build.check(status, f"outlier_spmm ({p.path})")
    return y
