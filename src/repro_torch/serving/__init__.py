"""Continuous-batching serving on the slot or the paged KV layout.

  engine = ServingEngine(cfg, params, device="cuda", n_slots=8, max_len=256)
  engine = ServingEngine(..., kv_layout="paged", block_size=16)
  req = engine.submit(prompt_tokens, SamplingParams(max_new_tokens=16))
  engine.run()            # or engine.step() under an external loop
  req.tokens              # generated ids; req.metrics has ttft/e2e/...
"""

from .cache_pool import (CachePoolError, CapacityError, DoubleFree,
                         KVCachePool, SlotKVPool, SlotPoolView)
from .engine import KV_LAYOUTS, SUPPORTED_FAMILIES, ServingEngine
from .paged import OutOfBlocks, PagedKVPool, PagedPoolView
from .request import Request, SamplingParams, Status
from .scheduler import (CHUNK_QUANTUM, QueueFull, RequestQueue, plan_chunks,
                        resolve_token_budget, validate_token_budget)
