"""Hash-chained prefix cache over full KV blocks (copy of
``repro/serving/paged/prefix_cache.py``, pure host code).

Every FULL block of a prefilled sequence is registered under a chained
key: ``key(block_i) = (key(block_{i-1}), tokens_of_block_i)``, so a block
is only ever matched when the *entire* token prefix leading to it is
identical — the standard vLLM-style automatic prefix-caching scheme.
(Python dict hashing does the hashing; keeping the exact token tuple in
the key means a hash collision can never silently serve wrong KV.)

The cache holds one reference on every registered block, so a block can
outlive the request that computed it and be shared read-only by later
requests with the same prefix (each sharer increfs on match).  Shared
blocks are never written in place: a request that must write into a
matched block — only the final matched block, when the whole prompt was
cached and its last token is recomputed for first-token logits — takes a
private copy first (BlockPool.copy_on_write).

Eviction is LRU over entries whose block nobody but the cache references
(ref == 1); ``evict_one`` is called by the paged pool when the allocator
runs dry.  Evicting a parent block can orphan cached children (their
chain can no longer be matched); orphans are harmless and age out of the
same LRU.
"""
from __future__ import annotations

import collections

from .block_pool import BlockPool


class PrefixCache:
    def __init__(self, pool: BlockPool):
        self._pool = pool
        # key -> block id, in LRU order (oldest first)
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._key_of_block: dict[int, object] = {}
        # accounting for the benchmark / tests
        self.lookups = 0
        self.hits = 0                   # lookups matching >= 1 block
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self.probes = 0                 # side-effect-free match_length calls

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------- keys
    def _chain_keys(self, tokens) -> list:
        bs = self._pool.block_size
        keys, parent = [], None
        for start in range(0, len(tokens) - len(tokens) % bs, bs):
            parent = (parent, tuple(tokens[start:start + bs]))
            keys.append(parent)
        return keys

    # ------------------------------------------------------------ match
    def match(self, tokens) -> list[int]:
        """Longest chain of cached full blocks prefixing ``tokens``.

        Matched blocks are increfed for the caller (who now co-owns them)
        and touched in the LRU.  Returns the physical block ids in
        sequence order; the caller decides how many cached tokens it can
        actually use (it must recompute at least the last prompt token to
        have logits to sample from).
        """
        self.lookups += 1
        keys = self._chain_keys(tokens)
        matched = []
        for key in keys:
            block = self._entries.get(key)
            if block is None:
                break
            matched.append(block)
        for key in reversed(keys[:len(matched)]):
            self._entries.move_to_end(key)   # parents most-recent last
        for b in matched:
            self._pool.incref(b)
        if matched:
            self.hits += 1
        self.hit_tokens += len(matched) * self._pool.block_size
        return matched

    def match_length(self, tokens) -> int:
        """Longest cached-prefix length of ``tokens``, in TOKENS, with NO
        side effects: no refcounts taken, no LRU touch, no hit/lookup
        accounting.

        This is the router-facing probe behind prefix-aware replica
        routing: a router probes EVERY replica's cache per incoming
        request, and a probe must neither pin blocks (the request may be
        routed elsewhere) nor disturb eviction order (N-1 losing probes
        per request would otherwise refresh entries the winner never
        uses).  ``match`` remains the admission-time lookup that actually
        claims the blocks.  Probes are counted separately (``probes`` in
        ``stats()``) so hit-rate accounting stays admission-only.
        """
        self.probes += 1
        bs = self._pool.block_size
        matched = 0
        parent = None
        for start in range(0, len(tokens) - len(tokens) % bs, bs):
            parent = (parent, tuple(tokens[start:start + bs]))
            if parent not in self._entries:
                break
            matched += 1
        return matched * bs

    # ----------------------------------------------------------- insert
    def insert(self, tokens, blocks: list[int]) -> None:
        """Register the full blocks of a just-prefilled sequence.

        ``blocks`` is the request's block table; only indices covering
        complete ``block_size`` chunks of ``tokens`` are cached.  A key
        that is already cached is left pointing at its existing block
        (content-identical), so duplicates are deduped rather than
        double-registered.
        """
        for i, key in enumerate(self._chain_keys(tokens)):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            block = blocks[i]
            if block in self._key_of_block:      # already cached under a
                continue                         # different chain — skip
            self._pool.incref(block)
            self._pool.mark_cached(block)
            self._entries[key] = block
            self._key_of_block[block] = key
            self.inserted_blocks += 1

    # ---------------------------------------------------------- evict
    @property
    def n_evictable(self) -> int:
        # maintained incrementally by the pool at refcount transitions —
        # O(1), this sits on the per-request admission hot path
        return self._pool.n_cached_idle

    def evict_one(self) -> bool:
        """Drop the least-recently-used entry whose block only the cache
        still references, freeing that block.  Returns False when every
        cached block is in use by a live request."""
        for key, block in self._entries.items():          # oldest first
            if self._pool.ref[block] == 1:
                del self._entries[key]
                del self._key_of_block[block]
                self._pool.decref(block)
                self.evicted_blocks += 1
                return True
        return False

    def stats(self) -> dict:
        return {"lookups": self.lookups, "hits": self.hits,
                "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
                "hit_tokens": self.hit_tokens,
                "entries": len(self._entries),
                "inserted_blocks": self.inserted_blocks,
                "evicted_blocks": self.evicted_blocks,
                "probes": self.probes}

    def reset_stats(self) -> None:
        """Zero the counters without touching cached content (so a warmed
        cache can be measured over exactly one benchmark window)."""
        self.lookups = self.hits = self.hit_tokens = 0
        self.inserted_blocks = self.evicted_blocks = self.probes = 0
