"""Ref-counted block allocator over one preallocated paged KV arena (port
of ``repro/serving/paged/block_pool.py``).

The arena is a single pair of k/v tensors shaped
``[L, n_blocks, block_size, KV, hd]`` allocated once at engine start and
handed out in ``block_size``-token units with reference counts, so
physical blocks can be shared read-only between requests (prefix caching)
and copied on write when a sharer needs to mutate one.  An int8 arena
(``kv_dtype="int8"``) carries f32 scale arenas ``[L, n_blocks, block_size,
KV]`` blocked like the values, so sharing and copy-on-write move a block's
scales with it.

The pool is policy-free: it allocates, increfs, decrefs and copies blocks.
Who shares what (``prefix_cache.py``) and who owns which block when
(``pool.py`` and the engine) live above it.  Refcounts and the free list
are host state (numpy and a list); only the arenas live on the device.
"""
from __future__ import annotations

import numpy as np

from ..cache_pool import arena_nbytes, kv_arenas


class BlockPoolError(RuntimeError):
    """Invariant violation in block accounting (double free, bad ref)."""


class OutOfBlocks(RuntimeError):
    """No free block available; callers evict prefix-cache entries or
    preempt a running request and retry."""


class BlockPool:
    def __init__(self, cfg, n_blocks: int, block_size: int, device,
                 kv_dtype: str = "bf16", placement=None):
        if n_blocks < 1:
            raise ValueError("need at least one block")
        shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
        # on a mesh the arena holds this rank's KV heads; ``occupancy``
        # reports the whole arena's bytes
        self.k, self.v, self.k_scale, self.v_scale = kv_arenas(
            shape, kv_dtype, cfg.dtype, device, placement)
        self.kv_shards = 1 if placement is None else placement.kv_shards
        self.kv_dtype = kv_dtype
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.ref = np.zeros((n_blocks,), np.int32)
        self._free = list(range(n_blocks - 1, -1, -1))   # pop() -> ascending
        # prefix-cache bookkeeping: which blocks the cache has registered,
        # and how many of those only the cache still references (ref == 1,
        # i.e. evictable), kept at every refcount transition so admission
        # reads it in O(1)
        self._cached = np.zeros((n_blocks,), bool)
        self.n_cached_idle = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    def occupancy(self) -> dict:
        """Allocated, free and evictable blocks, and the arena's whole
        device bill: int8 values and their f32 scales (``scale_bytes``)."""
        scale_bytes = arena_nbytes(self.k_scale, self.v_scale) \
            * self.kv_shards
        return {"n_blocks": self.n_blocks, "n_free": self.n_free,
                "n_allocated": self.n_blocks - self.n_free,
                "n_cached_idle": self.n_cached_idle,
                "kv_dtype": self.kv_dtype,
                "arena_bytes": arena_nbytes(self.k, self.v) * self.kv_shards
                + scale_bytes,
                "scale_bytes": scale_bytes}

    def alloc(self) -> int:
        """Hand out a free block with refcount 1."""
        if not self._free:
            raise OutOfBlocks(f"all {self.n_blocks} KV blocks in use")
        b = self._free.pop()
        self.ref[b] = 1
        return b

    def mark_cached(self, block: int) -> None:
        """Called by the prefix cache when it registers ``block``."""
        if not self._cached[block]:
            self._cached[block] = True
            if self.ref[block] == 1:
                self.n_cached_idle += 1

    def incref(self, block: int) -> None:
        if self.ref[block] <= 0:
            raise BlockPoolError(f"incref on free block {block}")
        if self._cached[block] and self.ref[block] == 1:
            self.n_cached_idle -= 1          # cache-idle -> shared
        self.ref[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        if self.ref[block] <= 0:
            raise BlockPoolError(f"decref on free block {block} (double free)")
        self.ref[block] -= 1
        r = int(self.ref[block])
        if self._cached[block]:
            if r == 1:
                self.n_cached_idle += 1      # only the cache holds it now
            elif r == 0:
                self.n_cached_idle -= 1      # cache entry evicted
                self._cached[block] = False
        if r == 0:
            self._free.append(block)
            return True
        return False

    def copy_on_write(self, block: int) -> int:
        """Give the caller a private copy of ``block``: allocates a fresh
        block, copies its KV in every layer in place on the device (on the
        current stream, so it lands before the next step reads it), with an
        int8 arena's scales, and drops one reference on the original.
        Raises OutOfBlocks when no block is free."""
        dst = self.alloc()
        for arena in (self.k, self.v, self.k_scale, self.v_scale):
            if arena is not None:
                arena[:, dst].copy_(arena[:, block])
        self.decref(block)
        return dst
