"""PagedKVPool: the engine-facing facade over the paged KV machinery (port
of ``repro/serving/paged/pool.py``; bf16 or int8 arenas).

It meets the same protocol as ``SlotKVPool`` (``serving/cache_pool.py``):
``n_free`` rows, a ``max_request_tokens`` admission bound, and the
``advance_*``/``release`` lifecycle.  A *row* here is only scheduling
state (a decode-batch lane plus a block table); the KV lives in
``block_size``-token blocks allocated on demand from one shared arena
(``block_pool.py``), found through the row's table (``block_table.py``)
and shared across requests with identical prefixes (``prefix_cache.py``).

Every KV write happens inside ``models/transformer.unified_step``: the
adapter hands it a ``PagedPoolView`` and each layer scatters its fresh KV
through the tables and attends in place over the blocks
(``paged_attention.py``).  Allocation is chunk-aware:
``admit(alloc_tokens=...)`` maps only what the first chunk needs (plus a
matched cached prefix) and ``ensure_capacity`` appends blocks as the
prefill cursor advances.  The arena can run dry mid-decode or mid-prefill;
``prepare_decode``/``ensure_capacity`` then raise ``OutOfBlocks`` and the
engine preempts a running request back to the queue.

One block is the *trash block*: table entries past a row's allocated
blocks, free rows and batch-padding lanes point at it, so every gather
stays inside the arena.  A chunk's view (``PagedPoolView.build``) drops
padding writes on the host: only real (lane, position) pairs whose block
is allocated are written.  The fused decode's view
(``PagedPoolView.decode``) computes its write indices on the device at a
fixed shape by the reference's ``_write_slots`` rule, so the decode call
can be captured and replayed: a lane's pair is valid when it decodes
(``n_new`` is the active mask) and its position lies inside the table, and
every other pair is routed into the trash block, as the reference routes
its padding.  There it writes back the bytes the trash block holds: many
lanes share that one position, and the card's scatter picks one of
duplicate writes in no fixed order, so only equal bytes keep every run's
bits (a moe batch couples its lanes through the routing: a free lane
attends over the trash block).  So the trash block keeps its zeros, and a
write never lands in a block shared through the prefix cache or ``fork``
(``prepare_decode`` copies those on write first).

Positions and tables live on the host (numpy).  The device copy of the
whole table is one persistent tensor, refreshed in place at most once per
step and only when a table changed, so a captured decode reads it at one
address.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..cache_pool import (ArenaWrites, CachePoolError, CapacityError,
                          DoubleFree)
from .block_pool import BlockPool, OutOfBlocks
from .block_table import BlockTable, blocks_needed
from .prefix_cache import PrefixCache


@dataclasses.dataclass(frozen=True)
class PagedPoolView(ArenaWrites):
    """What ``transformer.attend_over_pool`` sees of a paged pool.

    ``k``/``v`` are the [L, n_blocks, block_size, KV, hd] arenas; inside
    the layer loop the transformer passes one layer's slice.
    ``block_tables`` [B, nb] int32 maps lane b's sequence position p to
    physical block ``block_tables[b, p // block_size]`` (padding lanes
    carry all-trash tables); ``cursor`` [B] int32 counts tokens already
    written per lane.  ``write_src``/``write_dst`` are the flat indices of
    the real (lane, i < n_new) pairs in the step's [B*S] fresh KV and in
    the [n_blocks*block_size] arena.  ``k_scale``/``v_scale``
    ([L, n_blocks, block_size, KV] f32, or None for bf16 arenas) are an
    int8 arena's scales, addressed through the same tables and written with
    the same indices.  ``decode``'s view writes every lane (``write_src``
    None), an invalid one into the trash block, where it writes back what
    is there (``write_keep``)."""
    k: Any
    v: Any
    block_tables: torch.Tensor
    cursor: torch.Tensor
    write_src: torch.Tensor | None
    write_dst: torch.Tensor
    k_scale: Any | None = None
    v_scale: Any | None = None
    write_keep: torch.Tensor | None = None

    @classmethod
    def build(cls, k, v, tables: np.ndarray, cursor, n_new, S: int, *,
              trash: int, device_tables: torch.Tensor | None = None,
              k_scale=None, v_scale=None) -> "PagedPoolView":
        """A view for S fresh positions per lane from the host ``tables``
        [B, nb], ``cursor`` and ``n_new``.  ``device_tables`` is the same
        table already on the device (the pool's cached upload), else
        ``tables`` is uploaded.  A pair is written only when i < n_new, its
        position lies inside the table and its block is not the trash
        block."""
        bs = k.shape[2]
        tables = np.asarray(tables, np.int64)
        nb = tables.shape[1]
        cursor = np.asarray(cursor, np.int64)
        n_new = np.asarray(n_new, np.int64)
        p = cursor[:, None] + np.arange(S)[None]                  # [B,S]
        bi = p // bs
        blk = np.take_along_axis(tables, np.clip(bi, 0, nb - 1), axis=1)
        valid = ((np.arange(S)[None] < n_new[:, None]) & (bi < nb)
                 & (blk != trash))
        src = np.flatnonzero(valid)
        dst = (blk * bs + p % bs).reshape(-1)[src]
        dev = k.device
        if device_tables is None:
            device_tables = torch.as_tensor(tables, dtype=torch.int32,
                                            device=dev)
        return cls(k=k, v=v, block_tables=device_tables,
                   cursor=torch.as_tensor(cursor, dtype=torch.int32,
                                          device=dev),
                   write_src=torch.as_tensor(src, dtype=torch.int64,
                                             device=dev),
                   write_dst=torch.as_tensor(dst, dtype=torch.int64,
                                             device=dev),
                   k_scale=k_scale, v_scale=v_scale)

    @classmethod
    def decode(cls, k, v, block_tables: torch.Tensor, cursor: torch.Tensor,
               n_new: torch.Tensor, *, trash: int, k_scale=None,
               v_scale=None) -> "PagedPoolView":
        """The fused decode's view (one fresh position a lane) from device
        tensors ``block_tables`` [B, nb] int32, ``cursor`` [B] int32 and
        ``n_new`` [B], its write indices computed on the device at a fixed
        shape by the reference's ``_write_slots`` rule
        (``repro/serving/paged/pool.py:84``): valid = 0 < n_new and the
        position's block index < nb, else the trash block's first
        position, which an invalid pair writes back unchanged."""
        bs, nb = k.shape[2], block_tables.shape[1]
        p = cursor.long()
        bi = p // bs
        blk = block_tables.gather(1, bi.clamp(0, nb - 1)[:, None])[:, 0]
        valid = (n_new > 0) & (bi < nb)
        dst = torch.where(valid, blk.long() * bs + p % bs, trash * bs)
        return cls(k=k, v=v, block_tables=block_tables, cursor=cursor,
                   write_src=None, write_dst=dst, k_scale=k_scale,
                   v_scale=v_scale, write_keep=valid)


class PagedKVPool:
    def __init__(self, cfg, n_rows: int, max_len: int, *, device,
                 block_size: int = 16, n_blocks: int | None = None,
                 prefix_caching: bool = True, kv_dtype: str = "bf16",
                 placement=None):
        self.block_size = block_size
        self.max_blocks_per_row = blocks_needed(max_len, block_size)
        if n_blocks is None:
            # the same device memory as a SlotKVPool(n_rows, max_len)
            n_blocks = n_rows * self.max_blocks_per_row
        self.blocks = BlockPool(cfg, n_blocks + 1, block_size, device,
                                kv_dtype=kv_dtype,            # +1 trash
                                placement=placement)
        self.kv_dtype = kv_dtype
        self._trash = self.blocks.alloc()                       # permanent
        self.n_blocks = n_blocks                                # usable
        self.n_rows = n_rows
        self.max_len = max_len
        self.device = self.blocks.k.device
        self.prefix_cache = PrefixCache(self.blocks) if prefix_caching \
            else None
        self.tables: list[BlockTable | None] = [None] * n_rows
        self._bt_np = np.full((n_rows, self.max_blocks_per_row),
                              self._trash, np.int32)
        self._bt_dev = torch.as_tensor(self._bt_np, device=self.device)
        self._bt_dirty = False
        self.pos = np.zeros((n_rows,), np.int32)
        self._free_rows = list(range(n_rows - 1, -1, -1))
        self.n_preemptions = 0

    # ----------------------------------------------------- protocol attrs
    @property
    def k(self):
        return self.blocks.k

    @property
    def v(self):
        return self.blocks.v

    @property
    def k_scale(self):
        return self.blocks.k_scale

    @property
    def v_scale(self):
        return self.blocks.v_scale

    @property
    def n_slots(self) -> int:
        return self.n_rows

    @property
    def n_free(self) -> int:
        return len(self._free_rows)

    @property
    def max_request_tokens(self) -> int:
        """Longest request (prompt + generation) that can ever complete."""
        return min(self.max_len, self.n_blocks * self.block_size)

    @property
    def trash_block(self) -> int:
        return self._trash

    @property
    def host_tables(self) -> np.ndarray:
        """Every row's table on the host, [n_rows, max_blocks_per_row]."""
        return self._bt_np

    @property
    def block_tables(self) -> torch.Tensor:
        """The same tables on the device: one tensor for the pool's life,
        refreshed in place only when a table changed since the last
        refresh (a copy on write, a release or a preemption changes its
        contents, never its address)."""
        if self._bt_dirty:
            self._bt_dev.copy_(torch.from_numpy(self._bt_np))
            self._bt_dirty = False
        return self._bt_dev

    def lane_tables(self, rows: list[int], n_rows_padded: int) -> np.ndarray:
        """Host per-lane block tables for a chunk group; padding lanes are
        all-trash."""
        out = np.full((n_rows_padded, self.max_blocks_per_row),
                      self._trash, np.int32)
        out[:len(rows)] = self._bt_np[rows]
        return out

    # -------------------------------------------------------- allocation
    @property
    def free_blocks(self) -> int:
        """Blocks obtainable right now: free list plus evictable cache."""
        n = self.blocks.n_free
        if self.prefix_cache is not None:
            n += self.prefix_cache.n_evictable
        return n

    def can_admit(self, n_tokens: int, lookahead_blocks: int = 1) -> bool:
        """Block-aware admission: a free row, and enough obtainable blocks
        to hold ``n_tokens`` plus a decode lookahead margin, clamped to the
        arena so a request whose prompt alone fills the arena is not
        deferred forever."""
        if not self._free_rows:
            return False
        need = min(blocks_needed(n_tokens, self.block_size)
                   + lookahead_blocks, self.n_blocks)
        return need <= self.free_blocks

    def _retry_evicting(self, fn, *args):
        while True:
            try:
                return fn(*args)
            except OutOfBlocks:
                if self.prefix_cache is None \
                        or not self.prefix_cache.evict_one():
                    raise

    def _alloc_block(self) -> int:
        return self._retry_evicting(self.blocks.alloc)

    def _cow(self, block: int) -> int:
        return self._retry_evicting(self.blocks.copy_on_write, block)

    def _set_table(self, row: int, blocks: list[int]) -> None:
        self._bt_np[row, :] = self._trash
        self._bt_np[row, :len(blocks)] = blocks
        self._bt_dirty = True

    # --------------------------------------------------------- admission
    def admit(self, tokens, alloc_tokens: int | None = None) -> tuple[int, int]:
        """Assign a row and map the leading part of ``tokens`` onto blocks;
        returns ``(row, n_cached)``.

        The longest cached prefix is shared read-only; the prefill then
        computes only ``tokens[n_cached:]``.  At least the final token is
        always recomputed (its logits seed the first generated token) and
        ``n_cached`` stays on a block boundary; when the recomputed tail
        lands inside the last matched block, that block is copied on write
        first.  ``alloc_tokens`` bounds how many leading tokens get fresh
        blocks now (None: the whole sequence).  Raises ``OutOfBlocks``
        without leaking references."""
        if not self._free_rows:
            raise CapacityError("admit called with no free rows")
        n = len(tokens)
        if n > self.max_request_tokens:
            raise CapacityError(
                f"prompt of {n} tokens exceeds pool capacity "
                f"{self.max_request_tokens}")
        matched = self.prefix_cache.match(tokens) \
            if self.prefix_cache is not None else []
        bs = self.block_size
        n_cached = min(len(matched) * bs, (n - 1) // bs * bs) if matched \
            else 0
        target = n if alloc_tokens is None else min(n, max(alloc_tokens,
                                                           n_cached))
        table_blocks = list(matched)
        try:
            if matched and n_cached < len(matched) * bs:
                if self.blocks.ref[table_blocks[-1]] > 1:
                    table_blocks[-1] = self._cow(table_blocks[-1])
            for _ in range(blocks_needed(target, bs) - len(table_blocks)):
                table_blocks.append(self._alloc_block())
        except OutOfBlocks:
            for b in table_blocks:
                self.blocks.decref(b)
            raise
        row = self._free_rows.pop()
        self.tables[row] = BlockTable(bs, table_blocks, n_cached)
        self._set_table(row, table_blocks)
        self.pos[row] = 0                # set for real by advance_prefill
        return row, n_cached

    def ensure_capacity(self, row: int, n_tokens: int) -> None:
        """Grow the row's table until it holds ``n_tokens`` positions.
        Raises ``OutOfBlocks`` mid-growth; blocks appended so far stay on
        the table for the retried chunk."""
        if n_tokens > self.max_request_tokens:
            raise CapacityError(
                f"{n_tokens} tokens exceed pool capacity "
                f"{self.max_request_tokens}")
        t = self.tables[row]
        if t is None:
            raise CachePoolError(f"ensure_capacity on free row {row}")
        while t.capacity < n_tokens:
            t.append_block(self._alloc_block())
            self._bt_np[row, t.n_blocks - 1] = t.blocks[-1]
            self._bt_dirty = True

    def prefix_match_length(self, tokens) -> int:
        """Side-effect-free probe: how many leading tokens of ``tokens``
        the prefix cache covers (0 when caching is off)."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.match_length(tokens)

    # -------------------------------------------------------------- data
    def register_prefix(self, row: int, tokens) -> None:
        """Publish the row's full blocks covering ``tokens`` (any fully
        written prefix of its sequence) into the prefix cache."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(tokens, self.tables[row].blocks)

    def prepare_decode(self, rows: list[int],
                       n_tokens: list[int] | None = None) -> None:
        """Make every row in ``rows`` able to write its next
        ``n_tokens[i]`` positions (1 each when omitted): allocate blocks
        across [pos, pos + n) and copy on write any shared block there.
        Raises ``OutOfBlocks`` (the engine preempts and retries)."""
        bs = self.block_size
        ns = [1] * len(rows) if n_tokens is None else n_tokens
        for row, n in zip(rows, ns):
            pos = int(self.pos[row])
            n = max(n, 1)
            if pos + n > self.max_request_tokens:
                raise CapacityError(
                    f"decode write of {n} tokens at position {pos} exceeds "
                    f"pool capacity {self.max_request_tokens}")
            t = self.tables[row]
            for bi in range(pos // bs, (pos + n - 1) // bs + 1):
                if bi >= t.n_blocks:
                    t.append_block(self._alloc_block())
                    self._bt_np[row, bi] = t.blocks[bi]
                    self._bt_dirty = True
                elif self.blocks.ref[t.blocks[bi]] > 1:
                    fresh = self._cow(t.blocks[bi])
                    t.replace_block(bi, fresh)
                    self._bt_np[row, bi] = fresh
                    self._bt_dirty = True

    def fork(self, row: int) -> int:
        """Fork ``row`` into a fresh row whose table shares every parent
        block read-only (incref only, no KV moves); the first write either
        side makes inside a shared block goes through copy-on-write.
        Raises ``CapacityError`` when no row is free."""
        t = self.tables[row]
        if t is None:
            raise CachePoolError(f"fork of free row {row}")
        if not self._free_rows:
            raise CapacityError("fork with no free row available")
        for b in t.blocks:
            self.blocks.incref(b)
        new = self._free_rows.pop()
        self.tables[new] = BlockTable(self.block_size, list(t.blocks),
                                      t.n_cached_tokens)
        self._set_table(new, t.blocks)
        self.pos[new] = self.pos[row]
        return new

    # --------------------------------------------------------- lifecycle
    def advance_prefill(self, rows: list[int], ends: list[int]) -> None:
        self.pos[np.asarray(rows, np.int64)] = ends

    def advance_decode(self, active_mask) -> None:
        """Only this step's decode rows advance; rows mid-prefill keep
        their cursor and free rows a stale value."""
        self.pos = np.where(np.asarray(active_mask), self.pos + 1,
                            self.pos).astype(np.int32)

    def release(self, row: int) -> None:
        t = self.tables[row]
        if t is None:
            raise DoubleFree(f"release of free row {row}")
        for b in t.blocks:
            self.blocks.decref(b)        # cached blocks survive via cache ref
        self.tables[row] = None
        self._set_table(row, [])
        self.pos[row] = 0
        self._free_rows.append(row)

    def stats(self) -> dict:
        occ = self.blocks.occupancy()
        out = {"layout": "paged", "n_blocks": self.n_blocks,
               "block_size": self.block_size,
               "free_blocks": self.blocks.n_free, "occupancy": occ,
               "kv_dtype": self.kv_dtype,
               "arena_bytes": occ["arena_bytes"],
               "scale_bytes": occ["scale_bytes"],
               "n_preemptions": self.n_preemptions}
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out

    def reset_stats(self) -> None:
        self.n_preemptions = 0
        if self.prefix_cache is not None:
            self.prefix_cache.reset_stats()
