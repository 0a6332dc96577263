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
wrapper runs ``plain``.

Layout: nm_values [out, in*n/m] bf16 (16-byte aligned), or int8 (8-byte
aligned) with ``scale`` [out] f32; nm_meta [out, in/m] int32 (4-bit
indices); o_values [out, in/256, o_n] bf16; o_meta [out, in/256, o_n/4]
int32 (8-bit indices).  in % 256 == 0.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.outliers import OUTLIER_M, unpack_outlier_meta
from ..core.packing import unpack_metadata
from . import build
from .nm_spmm import check_cuda_operands
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
PREFILL_BLOCKS_PER_SM = {64: 2, 128: 1, 256: 1}
"""By BM, the prefill blocks one SM holds at once (shared memory: three
ring slots and two B tiles, 105 KB at BM = 64 and BN = 128, 129 KB at
BM = 128, 177 KB at BM = 256): the slots a wave of the prefill grid
fills."""


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
    """How ``fused_sparse_linear`` computes an [M, K] x [N, K]^T product on
    a card with ``sm_count`` SMs.  For M <= ``decode_max_m`` the decode
    kernel: R x rows per block (x tiles of R rows beyond 8), and the fewest
    splits S of K on multiples of 256 that give ``BLOCKS_PER_SM`` blocks per
    SM and keep each slice within ``X_SLICE_BYTES``.  Otherwise the prefill
    kernel: BM = 64 rows of x per block up to M = 64, else 128, or 256
    (with BN 128) above M = 128 where 256-row tiles still make a quarter
    of a wave; BN = 128 output features, or 64 where 128-wide tiles
    split as far as they go cannot fill one wave of
    ``PREFILL_BLOCKS_PER_SM`` blocks per SM; and the split of K on
    multiples of 256 that ``_prefill_splits`` picks.  The slices are equal
    but for the last."""
    if K % OUTLIER_M or M < 1 or N < 1:
        raise ValueError(f"plan needs in % 256 == 0 and M, N >= 1; got "
                         f"M={M}, in={K}, out={N}")
    groups = K // OUTLIER_M
    if M > decode_max_m:
        bm = 64 if M <= 64 else 128
        if M > 128 and (-(-M // 256) * -(-N // 128) * 4
                        >= PREFILL_BLOCKS_PER_SM[256] * sm_count):
            bm = 256
        wave = PREFILL_BLOCKS_PER_SM[bm] * sm_count
        m_tiles = -(-M // bm)
        bn = 128 if (bm == 256
                     or -(-N // 128) * m_tiles * groups >= wave) else 64
        tiles = -(-N // bn) * m_tiles
        splits = _prefill_splits(tiles, groups, wave)
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


def _prefill_splits(tiles: int, groups: int, wave: int) -> int:
    """No split when the output tiles fill a wave of ``wave`` blocks;
    otherwise, of the equal splits (slices of whole groups) that keep the
    grid within two waves (each split adds S x M x N f32 of workspace),
    the one with the fewest waves x groups per slice, the time of the
    longest block's walk over K; ties to fewer splits."""
    if tiles >= wave:
        return 1
    best = (None, 1)
    for splits in range(1, min(groups, 2 * wave // tiles) + 1):
        per = -(-groups // splits)
        if -(-groups // per) != splits:
            continue                      # not an equal split
        cost = -(-tiles * splits // wave) * per
        if best[0] is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


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


_scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch_for(device: torch.device, p: Plan):
    """The split kernels' workspace and counters on ``device``: cached and
    grown when a plan needs more, so a call allocates nothing and launches
    no memset (the counters are zeroed once, when allocated, and each launch
    leaves them 0).  Launches on one device share them, so they must be
    ordered, as on one stream."""
    ws, cnt = _scratch.get(device.index, (None, None))
    if ws is None or ws.numel() * 4 < p.workspace_bytes:
        ws = torch.empty(max(p.workspace_bytes // 4, 1), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < p.counters:
        cnt = torch.zeros(max(p.counters, 1), dtype=torch.int32,
                          device=device)
    _scratch[device.index] = (ws, cnt)
    return ws, cnt


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
    p = force_plan or plan(M, K, N, n, m, o_n, _sm_count(x.device))
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
        ws, cnt = _scratch_for(x.device, p)
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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
