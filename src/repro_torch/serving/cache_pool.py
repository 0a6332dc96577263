"""The slot KV layout and the view the unified attention primitive consumes
(port of ``repro/serving/cache_pool.py``, bf16 arenas).

``SlotKVPool`` allocates k/v arenas [L, n_slots, max_len, KV, hd] once at
engine start; a request holds one slot for its lifetime.  Every KV write
happens inside ``models/transformer.unified_step``: the engine hands it a
``SlotPoolView`` (arena + lane->slot rows + cursors) and each layer
scatters its fresh KV at the cursor and attends in place, with the cursor
as a length mask.

Freed slots are reusable at once, and rows mid-prefill share the fused
decode step with decoding rows: every position a request's attention can
see ([0, pos)) is written by its own prefill chunk or decode before it
becomes visible, and any position >= pos is overwritten (by the next
chunk's scatter, or decode's write-before-attend) before any query reads
it.  So neither zeroing on release nor masking the batch-wide decode write
is needed.

The port updates the arenas in place (PyTorch has no donation to stand in
for): ``unified_step`` returns the same tensors it was given.  Positions
live on the host (numpy), and the view's scatter indices are worked out on
the host once per step, so no layer waits on the device to learn which
(lane, position) pairs are real.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch


class CachePoolError(RuntimeError):
    """Cache-pool invariant violation (an engine bug, not workload
    pressure)."""


class DoubleFree(CachePoolError):
    """A slot was released twice."""


class CapacityError(CachePoolError):
    """A write or admission exceeded what the pool can physically hold."""


def arena_nbytes(*arrays) -> int:
    return sum(a.numel() * a.element_size() for a in arrays if a is not None)


@runtime_checkable
class KVCachePool(Protocol):
    """What the engine requires of a KV layout (the slot layout is the only
    one ported; the paged one is ROADMAP A5)."""
    n_slots: int

    @property
    def n_free(self) -> int: ...

    @property
    def max_request_tokens(self) -> int: ...

    def release(self, slot: int) -> None: ...

    def advance_prefill(self, rows: list[int], ends: list[int]) -> None: ...

    def advance_decode(self, active_mask) -> None: ...


@dataclasses.dataclass(frozen=True)
class SlotPoolView:
    """What ``transformer.attend_over_pool`` sees of a slot pool.

    ``k``/``v`` are the [L, n_slots, max_len, KV, hd] arenas; inside the
    layer loop the transformer passes one layer's slice.  ``rows`` [B] maps
    each batch lane to its slot (padding lanes point at n_slots; None means
    lane i == slot i, the fused decode); ``cursor`` [B] counts tokens
    already written per lane.  ``write_src``/``write_dst`` are the flat
    indices of the real (lane, i < n_new) pairs in the step's [B*S] fresh
    KV and in the [n_slots*max_len] arena: what the JAX package's
    ``_flat_write_idx`` routes, minus the pairs its scatter drops
    (padding, past the arena)."""
    k: Any
    v: Any
    rows: torch.Tensor | None
    cursor: torch.Tensor
    write_src: torch.Tensor
    write_dst: torch.Tensor

    @classmethod
    def build(cls, k, v, rows, cursor, n_new, S: int) -> "SlotPoolView":
        """A view for S fresh positions per lane from host arrays ``rows``
        (or None), ``cursor`` and ``n_new``."""
        ns, ml = k.shape[1], k.shape[2]
        cursor = np.asarray(cursor, np.int64)
        n_new = np.asarray(n_new, np.int64)
        lane_rows = (np.arange(len(cursor)) if rows is None
                     else np.asarray(rows, np.int64))
        p = cursor[:, None] + np.arange(S)[None]                  # [B,S]
        valid = ((np.arange(S)[None] < n_new[:, None]) & (p < ml)
                 & (lane_rows[:, None] < ns))
        src = np.flatnonzero(valid)
        dst = (lane_rows[:, None] * ml + p).reshape(-1)[src]
        dev = k.device

        def up(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)
        return cls(k=k, v=v, rows=None if rows is None else up(lane_rows),
                   cursor=up(cursor), write_src=up(src),
                   write_dst=up(dst))

    @property
    def block_tables(self):
        return None                       # duck-type marker: slot layout

    def lane_kv(self, k_l, v_l):
        """Per-lane [B, max_len, KV, hd] arena rows for attention.  Padding
        lanes' rows are clamped into the arena, as the JAX gather clamps;
        their outputs are never read."""
        if self.rows is None:
            return k_l, v_l
        rows = self.rows.clamp(max=k_l.shape[0] - 1)
        return k_l[rows], v_l[rows]

    def write_layer(self, k_l, v_l, fresh_k, fresh_v):
        """Scatter fresh [B, S, KV, hd] KV into one layer's arena slice at
        each lane's cursor, in place; padding pairs are not written."""
        for arena, fresh in ((k_l, fresh_k), (v_l, fresh_v)):
            flat = arena.view(-1, *arena.shape[2:])
            vals = fresh.reshape(-1, *fresh.shape[2:]).index_select(
                0, self.write_src)
            flat.index_copy_(0, self.write_dst, vals.to(arena.dtype))
        return k_l, v_l


class SlotKVPool:
    def __init__(self, cfg, n_slots: int, max_len: int, device):
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        shape = (L, n_slots, max_len, KV, hd)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.pos = np.zeros((n_slots,), np.int64)
        self.n_slots = n_slots
        self.max_len = max_len
        self._free = list(range(n_slots - 1, -1, -1))   # pop() -> ascending

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def max_request_tokens(self) -> int:
        return self.max_len

    def alloc(self) -> int | None:
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise DoubleFree(f"release of free slot {slot}")
        self._free.append(slot)

    def stats(self) -> dict:
        return {"layout": "slot", "n_slots": self.n_slots,
                "n_free": self.n_free, "max_len": self.max_len,
                "dtype": str(self.k.dtype).removeprefix("torch."),
                "arena_bytes": arena_nbytes(self.k, self.v)}

    def lane_rows(self, rows: list[int], n_rows_padded: int) -> np.ndarray:
        """Host lane->slot map for a chunk group; padding lanes point past
        the arena (their writes are skipped, their gathers clamp)."""
        out = np.full((n_rows_padded,), self.n_slots, np.int64)
        out[:len(rows)] = rows
        return out

    def chunk_end_check(self, cursor: int, lengths: list[int]) -> None:
        if cursor + max(lengths) > self.max_len:
            raise CapacityError(
                f"prefill of {max(lengths)} tokens at offset {cursor} "
                f"exceeds slot capacity {self.max_len}")

    def advance_prefill(self, rows: list[int], ends: list[int]) -> None:
        self.pos[np.asarray(rows, np.int64)] = ends

    def advance_decode(self, active_mask) -> None:
        """Only rows in ``active_mask`` advance; free slots and rows
        mid-prefill keep their position (the batch-wide decode write landed
        a garbage token there, which the next chunk or occupant overwrites
        before any query reads it)."""
        self.pos = np.where(np.asarray(active_mask), self.pos + 1, self.pos)
