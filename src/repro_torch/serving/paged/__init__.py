"""Paged KV cache: block-granular KV memory for the serving engine
(``ServingEngine(..., kv_layout="paged")``); port of ``repro/serving/paged``.

  block_pool.py      ref-counted allocator over one [L, n_blocks,
                     block_size, KV, hd] arena, with copy-on-write
  block_table.py     per-request logical->physical page maps
  prefix_cache.py    hash-chained full-block prefix sharing (LRU evict)
  paged_attention.py attention over block tables (decode and prefill
                     chunks): the plain version and the wrapper of the
                     Hopper kernel ``csrc/paged_attention.cu``
  pool.py            PagedKVPool, the cache-pool facade, and PagedPoolView,
                     what attend_over_pool sees of it
"""

from .block_pool import BlockPool, BlockPoolError, OutOfBlocks
from .block_table import BlockTable, blocks_needed
from .pool import PagedKVPool, PagedPoolView
from .prefix_cache import PrefixCache
