"""Paged attention over block-mapped KV: decode (S == 1) and prefill chunks
(S > 1) through one entry point.

Port of the Pallas TPU kernel ``repro/serving/paged/paged_attention.py:180``
(``paged_attention_pallas``, ``_paged_attn_kernel`` :122 with its quantized
branch :124-130, :147-149) as two hand-written Hopper bodies, for bf16
arenas, or int8 arenas with per-position f32 scales ``k_scale``/``v_scale``
[n_blocks, bs, KV] read through the same tables.  ``plan`` picks the body by
the rows of a call, S * n_rep (a row is a (query, q head) pair of one KV
head):

- rows <= ``DECODE_MAX_ROWS`` (T): the decode body,
  ``csrc/paged_attention_decode.cu``: each lane's keys split into spans of
  ``DECODE_SPAN`` keys, one block per (span, tile of 4 or 8 rows, KV head,
  lane), 64-key tiles gathered through the table into a ring of 2 slots,
  both products on the CUDA cores in f32, and the partial softmaxes merged
  in split order by the last span to finish;
- rows > T: the prefill-chunk body, ``csrc/paged_attention_prefill.cu``:
  64-key tiles gathered through the table into a ring of 3 slots,
  S = Q K^T and O += P V on the tensor cores (wgmma), 64 or 128 rows a
  block, P rounded to bf16 before the second product.

Both bodies take head dims 64, 80, 128, 192 and 256 (``HEAD_DIMS``); at
hd 256 the prefill-chunk body fits its shared memory at 64 rows a block
only (``prefill_smem_bytes``).  At hd 80 (zamba2-2.7b's shared attention)
the prefill-chunk body computes at the padded width 128 (``padded_hd``:
its tiles are 64-wide panels), loading and storing only the 80 real
columns; the decode body works at 80 columns directly.  The first port's kernel,
``csrc/paged_attention.cu`` (hd 64 and 128), stays reachable
through ``force_plan=Plan("tile")`` to be timed beside them; ``plan`` never
picks it.

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
tensor it launches one of the bodies or raises.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ...kernels import build
from ...kernels.common import (register_launch_counters, scratch_for,
                               sm_count)
from ...models.layers import attend_length_masked

launches = 0
"""Launches of the bf16 bodies (either path, or the forced old kernel)
made through ``paged_attention`` (plain runs are not counted)."""
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
launches_tile = 0
"""Of ``launches``, those of the old kernel, forced by ``Plan("tile")``."""
launches_tile_int8 = 0
"""Of ``launches_int8``, those of the old kernel, forced."""
register_launch_counters(__name__)

HEAD_DIMS = (64, 80, 128, 192, 256)
"""Head dims the two bodies are built for; another hd raises on a CUDA
tensor."""
SMEM_LIMIT = 232448
"""Dynamic shared memory a block may use on an H100 (227 KB)."""
PREFILL_TK = 64                  # key positions a tile (kTK of the source)
PREFILL_STAGES = 3               # ring slots (kStages of the source)
GRID_LIMIT = 65535               # CUDA's bound on grid.y (KV) and grid.z (B)
DECODE_MAX_ROWS = 8
"""T: the largest row count S * n_rep that takes the decode body: the
largest row count at which the decode body was no slower than the
prefill-chunk body, bf16 and int8 arenas, in the sweep of
``chip_smoke.py``'s phase 2b on an H100 (PERF.md): a decode step of
llama3-8b (4 rows), of a model with n_rep 8, or two queries a lane at n_rep
4.  Above it the prefill-chunk body's tensor cores win: the decode body's
CUDA-core products grow with the rows, the tensor cores' do not.  The
sweep's short lanes (~64 tokens through 64-entry tables) put T at 0 for
bf16 arenas, a cost ``plan`` cannot see: it reads no cursor."""
DECODE_SPAN = 128
"""Keys a split of the decode body covers: ``kSpan`` of
``csrc/paged_attention_decode.cu``, a constant of the kernel, which makes
ceil(nb * bs / DECODE_SPAN) splits of a lane's nb * bs keys; ``plan`` sizes
the workspace and counters for that many."""


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str        # "decode", "prefill" or (forced only) "tile"
    rows: int = 0    # rows a block: decode R = 4 or 8; prefill BM = 64 or
    #                  128; tile unset (the old kernel picks its own)
    blocks: int = 0  # the grid: decode splits x row tiles x KV x B;
    #                  prefill row tiles x KV x B
    splits: int = 0  # decode: ceil(nb * bs / DECODE_SPAN), as the body
    #                  computes it
    workspace_bytes: int = 0  # decode: f32 partials [B, KV, row tiles,
    #                           splits, R, hd + 2]; 0 when splits == 1
    counters: int = 0         # decode: one per (lane, KV head, row tile)


def padded_hd(hd: int) -> int:
    """The width the prefill-chunk body computes at: hd rounded up to its
    64-wide panels (80 -> 128; the others are multiples of 64)."""
    return -(-hd // 64) * 64


def prefill_smem_bytes(hd: int, bm: int, int8: bool) -> int:
    """Bytes of shared memory a prefill-chunk block takes at head dim ``hd``
    and ``bm`` rows: ``Layout<HD, BM, T>::kTotal`` of
    ``csrc/paged_attention_prefill.cu``.  The q tile, for int8 arenas bf16
    operand tiles of K and V (two pairs when converting a tile ahead fits,
    else one), the ring of K/V slots (one more when ahead) and 1 KB of
    alignment; the bf16 tiles at the padded width (``padded_hd``), int8
    rows as stored."""
    q = bm * padded_hd(hd) * 2
    tile = PREFILL_TK * padded_hd(hd) * 2
    if not int8:
        return q + PREFILL_STAGES * 2 * tile + 1024
    slot = 2 * PREFILL_TK * hd + 2 * PREFILL_TK * 4
    ahead = q + 4 * tile + (PREFILL_STAGES + 1) * slot + 1024
    if ahead <= SMEM_LIMIT:
        return ahead
    return q + 2 * tile + PREFILL_STAGES * slot + 1024


def _prefill_fits(hd: int, bm: int) -> bool:
    return all(prefill_smem_bytes(hd, bm, int8) <= SMEM_LIMIT
               for int8 in (False, True))


@functools.lru_cache(maxsize=4096)
def plan(B: int, S: int, H: int, KV: int, hd: int, bs: int, sm_count: int,
         *, nb: int, decode_max_rows: int = DECODE_MAX_ROWS) -> Plan:
    """How ``paged_attention`` computes S queries of B lanes with H q heads
    over KV heads of width hd in blocks of bs, through tables of nb entries,
    on a card with ``sm_count`` SMs; from these shapes alone, never from the
    cursors, so a launch needs no cursor value on the host.  Rows S * n_rep
    <= ``decode_max_rows``: the decode body, R = 4 rows a block up to 4
    rows, else 8 (a larger S tiles its rows over the grid), and
    ceil(nb * bs / ``DECODE_SPAN``) splits of each lane's keys, each with
    its f32 partials in the workspace when there is more than one.  Above:
    the prefill-chunk body at BM = 128 rows a block where that grid leaves
    at most a quarter of the SMs without a block (a 512-token chunk of
    llama3-8b: 16 x 8 = 128 blocks on 132 SMs) and its layout fits the
    block's shared memory on bf16 and int8 arenas alike
    (``prefill_smem_bytes``: not at hd 256), else BM = 64, which halves the
    rows a K/V tile serves and doubles the blocks (a 64-token chunk of 4
    lanes: 128 blocks)."""
    if min(B, S, H, KV, hd, bs, sm_count, nb) < 1 or H % KV:
        raise ValueError(f"plan needs positive sizes and H a multiple of KV;"
                         f" got B={B} S={S} H={H} KV={KV} hd={hd} bs={bs}"
                         f" nb={nb}")
    rows = S * (H // KV)
    if rows <= decode_max_rows:
        r = 4 if rows <= 4 else 8
        tiles = -(-rows // r)
        splits = -(-nb * bs // DECODE_SPAN)
        split = splits > 1
        return Plan("decode", r, splits * tiles * KV * B, splits,
                    split * B * KV * tiles * splits * r * (hd + 2) * 4,
                    split * B * KV * tiles)
    bm = 128 if -(-rows // 128) * KV * B * 4 >= 3 * sm_count else 64
    if not _prefill_fits(hd, bm):
        bm = 64
    if not _prefill_fits(hd, bm):
        raise ValueError(f"no prefill-chunk layout fits {SMEM_LIMIT} bytes "
                         f"of shared memory at hd {hd}")
    return Plan("prefill", bm, -(-rows // bm) * KV * B)


def entry_point(p: Plan, int8: bool) -> str:
    """The C entry point that ``paged_attention`` calls for plan ``p``."""
    suffix = "_int8" if int8 else "_bf16"
    if p.path == "decode" and p.rows in (4, 8) and p.splits >= 1:
        return "paged_attention_decode" + suffix
    if p.path == "prefill" and p.rows in (64, 128):
        return "paged_attention_prefill" + suffix
    if p == Plan("tile"):
        return "paged_attention" + suffix
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


def _check_decode_plan(p: Plan, B: int, rows: int, KV: int, hd: int,
                       keys: int) -> None:
    """Raise unless decode plan ``p`` has the splits the body makes of a
    call's ``keys`` = nb * bs and sizes the workspace and counters its grid
    uses."""
    tiles = -(-rows // p.rows)
    counters = B * KV * tiles if p.splits > 1 else 0
    if (p.splits != -(-keys // DECODE_SPAN) or p.counters < counters
            or p.workspace_bytes < counters * p.splits * p.rows
            * (hd + 2) * 4):
        raise ValueError(f"decode plan {p} does not cover {keys} keys and "
                         f"{tiles} row tiles of {B} lanes x {KV} KV heads")


def paged_attention(q: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    cursor: torch.Tensor, *, window: int | None = None,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    force_plan: Plan | None = None) -> torch.Tensor:
    """out [B, S, H, hd] in q's dtype; see the module docstring.
    ``k_scale``/``v_scale`` [n_blocks, bs, KV] f32 dequantize int8 arenas;
    None for bf16 arenas.  ``force_plan`` replaces ``plan``'s choice of
    body on the card (tests and timing; ``Plan("tile")`` the old kernel); a
    CPU tensor runs ``plain`` whatever it says."""
    global launches, launches_int8, launches_decode, launches_decode_int8
    global launches_prefill, launches_prefill_int8, launches_tile
    global launches_tile_int8
    if not q.is_cuda:
        return plain(q, k_arena, v_arena, block_tables, cursor,
                     window=window, k_scale=k_scale, v_scale=v_scale)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, S, H, KV, hd, bs, n_blocks = _check_cuda_operands(
        q, k_arena, v_arena, block_tables, cursor, k_scale, v_scale)
    int8 = k_scale is not None
    nb = block_tables.shape[1]
    p = force_plan or plan(B, S, H, KV, hd, bs, sm_count(q.device), nb=nb)
    name = entry_point(p, int8)
    if p.path == "decode":
        _check_decode_plan(p, B, S * (H // KV), KV, hd, nb * bs)
    if p.path == "prefill" and prefill_smem_bytes(hd, p.rows,
                                                  int8) > SMEM_LIMIT:
        raise ValueError(f"prefill plan {p} needs "
                         f"{prefill_smem_bytes(hd, p.rows, int8)} bytes of "
                         f"shared memory at hd {hd}, over {SMEM_LIMIT}")
    if p.path == "tile" and hd not in (64, 128):
        raise ValueError(f"the old kernel takes hd 64 and 128, not {hd}")
    fn = getattr(build.library(), name)
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr()]
    if int8:
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    ptrs += [block_tables.data_ptr(), cursor.data_ptr(), out.data_ptr()]
    dims = [B, S, H, KV, hd, bs, nb, n_blocks,
            0 if window is None else int(window)]
    if p.path == "decode":
        ws, cnt = scratch_for(q.device, p)
        ptrs += [ws.data_ptr(), cnt.data_ptr()]
    if p.path != "tile":
        dims.append(p.rows)
    status = fn(*ptrs, *dims,
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, name)
    decode, prefill = int(p.path == "decode"), int(p.path == "prefill")
    tile = int(p.path == "tile")
    if int8:
        launches_int8 += 1
        launches_decode_int8 += decode
        launches_prefill_int8 += prefill
        launches_tile_int8 += tile
    else:
        launches += 1
        launches_decode += decode
        launches_prefill += prefill
        launches_tile += tile
    return out
