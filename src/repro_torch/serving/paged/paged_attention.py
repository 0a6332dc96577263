"""Paged attention over block-mapped KV: decode (S == 1) and prefill chunks
(S > 1) through one entry point.

Port of the Pallas TPU kernel ``repro/serving/paged/paged_attention.py:180``
(``paged_attention_pallas``, ``_paged_attn_kernel`` :122 with its quantized
branch :124-130, :147-149) as two hand-written Hopper bodies, for bf16
arenas, or int8 arenas with per-position f32 scales ``k_scale``/``v_scale``
[n_blocks, bs, KV] read through the same tables.  ``plan`` picks the body by
the rows of a call, S * n_rep (a row is a (query, q head) pair of one KV
head):

- rows <= ``DECODE_MAX_ROWS`` (T): the decode body, ``csrc/paged_attention.cu``:
  both products on the CUDA cores in f32, 4 to 64 rows a block;
- rows > T: the prefill-chunk body, ``csrc/paged_attention_prefill.cu``:
  64-key tiles gathered through the table into a ring of 3 slots,
  S = Q K^T and O += P V on the tensor cores (wgmma), 64 or 128 rows a
  block, P rounded to bf16 before the second product.

``q`` is [B, S, H, hd]; ``cursor`` [B] counts the tokens of each lane that
were visible before this step's S fresh ones.  Query i of lane b sits at
position ``cursor[b] + i`` and attends to sequence positions
``j <= cursor[b] + i`` (and ``j > cursor[b] + i - window`` with a window),
reading position j's KV from physical block ``block_tables[b, j // bs]``
at offset ``j % bs`` of the arenas [n_blocks, bs, KV, hd].  The fresh
chunk's KV is scattered into the arena before attention, so the causal mask
alone hides this step's not-yet-visible writes, stale tokens of earlier
block occupants and the trash block.  q head h reads KV head ``h // n_rep``.

``plain`` gathers the lane's blocks (and scales) into a contiguous view and
runs ``models/layers.attend_length_masked``: what ``paged_attention_ref``
(:91) computes.  ``paged_attention`` runs ``plain`` for a CPU tensor; for a CUDA
tensor it launches one of the two bodies or raises.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ...kernels import build
from ...kernels.common import sm_count
from ...models.layers import attend_length_masked

launches = 0
"""Launches of the bf16 bodies (either path) made through
``paged_attention`` (plain runs are not counted)."""
launches_int8 = 0
"""Launches of the int8 bodies made through ``paged_attention``."""
launches_decode = 0
"""Of ``launches``, those of the decode body (rows <= T)."""
launches_decode_int8 = 0
"""Of ``launches_int8``, those of the decode body (rows <= T)."""
launches_prefill = 0
"""Of ``launches``, those of the prefill-chunk body (rows > T)."""
launches_prefill_int8 = 0
"""Of ``launches_int8``, those of the prefill-chunk body (rows > T)."""

HEAD_DIMS = (64, 128)
GRID_LIMIT = 65535               # CUDA's bound on grid.y (KV) and grid.z (B)
DECODE_MAX_ROWS = 4
"""T: the largest row count S * n_rep that takes the decode body: a decode
step (S = 1) of a model with n_rep <= 4 (llama3-8b) and nothing longer.
The sweep of ``chip_smoke.py`` (phase 2b) found the prefill-chunk body
faster than the decode body at every row count it timed, a decode step
included (PERF.md); decode steps stay on the decode body until its
split-KV redesign, which the sweep then measures against this body."""


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str        # "decode" or "prefill"
    rows: int = 0    # prefill: BM, rows a block (64 or 128); decode: unset
    blocks: int = 0  # prefill: the grid, row tiles x KV x B; decode: unset


@functools.lru_cache(maxsize=4096)
def plan(B: int, S: int, H: int, KV: int, hd: int, bs: int, sm_count: int,
         *, decode_max_rows: int = DECODE_MAX_ROWS) -> Plan:
    """How ``paged_attention`` computes S queries of B lanes with H q heads
    over KV heads of width hd in blocks of bs on a card with ``sm_count``
    SMs.  Rows S * n_rep <= ``decode_max_rows``: the decode body, which
    picks its own rows a block (``csrc/paged_attention.cu``).  Above: the
    prefill-chunk body at BM = 128 rows a block where that grid leaves at
    most a quarter of the SMs without a block (a 512-token chunk of
    llama3-8b: 16 x 8 = 128 blocks on 132 SMs), else BM = 64, which halves
    the rows a K/V tile serves and doubles the blocks (a 64-token chunk of 4
    lanes: 128 blocks)."""
    if min(B, S, H, KV, hd, bs, sm_count) < 1 or H % KV:
        raise ValueError(f"plan needs positive sizes and H a multiple of KV;"
                         f" got B={B} S={S} H={H} KV={KV} hd={hd} bs={bs}")
    rows = S * (H // KV)
    if rows <= decode_max_rows:
        return Plan("decode")
    bm = 128 if -(-rows // 128) * KV * B * 4 >= 3 * sm_count else 64
    return Plan("prefill", bm, -(-rows // bm) * KV * B)


def entry_point(p: Plan, int8: bool) -> str:
    """The C entry point that ``paged_attention`` calls for plan ``p``."""
    if p.path == "decode":
        return "paged_attention_int8" if int8 else "paged_attention_bf16"
    if p.path == "prefill" and p.rows in (64, 128):
        return ("paged_attention_prefill_int8" if int8
                else "paged_attention_prefill_bf16")
    raise ValueError(f"no body takes plan {p}")


def plain(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
          block_tables: torch.Tensor, cursor: torch.Tensor, *,
          window: int | None = None, k_scale: torch.Tensor | None = None,
          v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: gather every table entry's block (a table
    maps sequence position p to gathered index p), and an int8 arena's
    scales through the same tables, then the contiguous length-masked
    attention in f32."""
    B, S, H, hd = q.shape
    _, bs, KV, _ = k_arena.shape
    nb = block_tables.shape[1]
    idx = block_tables.long()
    k = k_arena[idx].reshape(B, nb * bs, KV, hd)
    v = v_arena[idx].reshape(B, nb * bs, KV, hd)
    ks = vs = None
    if k_scale is not None:
        ks = k_scale[idx].reshape(B, nb * bs, KV)
        vs = v_scale[idx].reshape(B, nb * bs, KV)
    return attend_length_masked(q, k, v, cursor, window=window, k_scale=ks,
                                v_scale=vs)


def _check_cuda_operands(q, k_arena, v_arena, block_tables, cursor,
                         k_scale=None, v_scale=None):
    """Dtypes, shapes, devices, contiguity and alignment the kernel takes:
    bf16 arenas without scales, or int8 arenas with f32 scales
    [n_blocks, bs, KV]; raises on anything else."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged_attention kernel takes bf16 q, got {q.dtype}")
    if q.dim() != 4 or k_arena.dim() != 4:
        raise ValueError("q must be [B, S, H, hd] and the arenas "
                         "[n_blocks, bs, KV, hd]")
    B, S, H, hd = q.shape
    n_blocks, bs, KV, hd_k = k_arena.shape
    if hd not in HEAD_DIMS or hd_k != hd:
        raise ValueError(f"head dim must be one of {HEAD_DIMS} in q and the "
                         f"arenas; got q {hd}, arena {hd_k}")
    if KV < 1 or H % KV:
        raise ValueError(f"q heads {H} must be a multiple of KV heads {KV}")
    if bs < 8 or bs % 8:
        raise ValueError(f"block size must be a multiple of 8, got {bs}")
    if not (0 < B <= GRID_LIMIT and 0 < KV <= GRID_LIMIT and S > 0):
        raise ValueError(f"q {tuple(q.shape)} with {KV} KV heads is outside "
                         f"the kernel's grid (B and KV in 1..{GRID_LIMIT})")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.shape[1] < 1):
        raise ValueError(f"block_tables must be [B={B}, nb >= 1], got "
                         f"{tuple(block_tables.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    arena_dtype = torch.bfloat16 if k_scale is None else torch.int8
    operands = [
        ("k_arena", k_arena, arena_dtype, tuple(k_arena.shape)),
        ("v_arena", v_arena, arena_dtype, tuple(k_arena.shape)),
        ("block_tables", block_tables, torch.int32,
         tuple(block_tables.shape)),
        ("cursor", cursor, torch.int32, (B,))]
    if k_scale is not None:
        operands += [("k_scale", k_scale, torch.float32, (n_blocks, bs, KV)),
                     ("v_scale", v_scale, torch.float32, (n_blocks, bs, KV))]
    for name, t, dtype, shape in operands:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in [("q", q)] + [(o[0], o[1]) for o in operands]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, S, H, KV, hd, bs, n_blocks


def paged_attention(q: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    cursor: torch.Tensor, *, window: int | None = None,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    force_plan: Plan | None = None) -> torch.Tensor:
    """out [B, S, H, hd] in q's dtype; see the module docstring.
    ``k_scale``/``v_scale`` [n_blocks, bs, KV] f32 dequantize int8 arenas;
    None for bf16 arenas.  ``force_plan`` replaces ``plan``'s choice of
    body on the card (tests and timing); a CPU tensor runs ``plain``
    whatever it says."""
    global launches, launches_int8, launches_decode, launches_decode_int8
    global launches_prefill, launches_prefill_int8
    if not q.is_cuda:
        return plain(q, k_arena, v_arena, block_tables, cursor,
                     window=window, k_scale=k_scale, v_scale=v_scale)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, S, H, KV, hd, bs, n_blocks = _check_cuda_operands(
        q, k_arena, v_arena, block_tables, cursor, k_scale, v_scale)
    int8 = k_scale is not None
    p = force_plan or plan(B, S, H, KV, hd, bs, sm_count(q.device))
    fn = getattr(build.library(), entry_point(p, int8))
    out = torch.empty_like(q)
    dims = [B, S, H, KV, hd, bs, block_tables.shape[1], n_blocks,
            0 if window is None else int(window)]
    if p.path == "prefill":
        dims.append(p.rows)
    scales = [k_scale.data_ptr(), v_scale.data_ptr()] if int8 else []
    status = fn(q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
                *scales, block_tables.data_ptr(), cursor.data_ptr(),
                out.data_ptr(), *dims,
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, entry_point(p, int8))
    decode, prefill = int(p.path == "decode"), int(p.path == "prefill")
    if int8:
        launches_int8 += 1
        launches_decode_int8 += decode
        launches_prefill_int8 += prefill
    else:
        launches += 1
        launches_decode += decode
        launches_prefill += prefill
    return out
