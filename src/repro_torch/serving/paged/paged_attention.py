"""Paged attention over block-mapped KV: decode (S == 1) and prefill chunks
(S > 1) through one entry point.

Port of the Pallas TPU kernel ``repro/serving/paged/paged_attention.py:180``
(``paged_attention_pallas``, ``_paged_attn_kernel`` :122) as the
hand-written Hopper kernel ``csrc/paged_attention.cu``.

``q`` is [B, S, H, hd]; ``cursor`` [B] counts the tokens of each lane that
were visible before this step's S fresh ones.  Query i of lane b sits at
position ``cursor[b] + i`` and attends to sequence positions
``j <= cursor[b] + i`` (and ``j > cursor[b] + i - window`` with a window),
reading position j's KV from physical block ``block_tables[b, j // bs]``
at offset ``j % bs`` of the arenas [n_blocks, bs, KV, hd].  The fresh
chunk's KV is scattered into the arena before attention, so the causal mask
alone hides this step's not-yet-visible writes, stale tokens of earlier
block occupants and the trash block.  q head h reads KV head ``h // n_rep``.

``plain`` gathers the lane's blocks into a contiguous view and runs
``models/layers.attend_length_masked``: what ``paged_attention_ref`` (:91)
computes.  ``paged_attention`` runs ``plain`` for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ...kernels import build
from ...models.layers import attend_length_masked

launches = 0
"""Kernel launches made through ``paged_attention`` (plain runs are not
counted)."""

HEAD_DIMS = (64, 128)
GRID_LIMIT = 65535               # CUDA's bound on grid.y (KV) and grid.z (B)


def plain(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
          block_tables: torch.Tensor, cursor: torch.Tensor, *,
          window: int | None = None) -> torch.Tensor:
    """The plain PyTorch version: gather every table entry's block (a table
    maps sequence position p to gathered index p), then the contiguous
    length-masked attention in f32."""
    B, S, H, hd = q.shape
    _, bs, KV, _ = k_arena.shape
    nb = block_tables.shape[1]
    idx = block_tables.long()
    k = k_arena[idx].reshape(B, nb * bs, KV, hd)
    v = v_arena[idx].reshape(B, nb * bs, KV, hd)
    return attend_length_masked(q, k, v, cursor, window=window)


def _check_cuda_operands(q, k_arena, v_arena, block_tables, cursor):
    """Dtypes, shapes, devices, contiguity and alignment the kernel takes;
    raises on anything else."""
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
    for name, t, dtype, shape in (
            ("k_arena", k_arena, torch.bfloat16, tuple(k_arena.shape)),
            ("v_arena", v_arena, torch.bfloat16, tuple(k_arena.shape)),
            ("block_tables", block_tables, torch.int32,
             tuple(block_tables.shape)),
            ("cursor", cursor, torch.int32, (B,))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena),
                    ("block_tables", block_tables), ("cursor", cursor)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, S, H, KV, hd, bs, n_blocks


def paged_attention(q: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    cursor: torch.Tensor, *,
                    window: int | None = None) -> torch.Tensor:
    """out [B, S, H, hd] in q's dtype; see the module docstring."""
    global launches
    if not q.is_cuda:
        return plain(q, k_arena, v_arena, block_tables, cursor,
                     window=window)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, S, H, KV, hd, bs, n_blocks = _check_cuda_operands(
        q, k_arena, v_arena, block_tables, cursor)
    out = torch.empty_like(q)
    status = build.library().paged_attention_bf16(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
        block_tables.data_ptr(), cursor.data_ptr(), out.data_ptr(),
        B, S, H, KV, hd, bs, block_tables.shape[1], n_blocks,
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    build.check(status, "paged_attention")
    return out
