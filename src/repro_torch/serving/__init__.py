"""Continuous-batching serving on the slot or the paged KV layout.

  engine = ServingEngine(cfg, params, device="cuda", n_slots=8, max_len=256)
  engine = ServingEngine(..., kv_layout="paged", block_size=16)
  req = engine.submit(prompt_tokens, SamplingParams(max_new_tokens=16))
  engine.run()            # or engine.step() under an external loop
  req.tokens              # generated ids; req.metrics has ttft/e2e/...

Request traces (serving/trace.py: Poisson, long-prompt and fleet-shaped
workloads, JSON round-trip, open-loop ``replay``) and observability
(serving/observe.py: Perfetto spans of every step and request lifecycle, a
Prometheus-text counter registry, per-variant attribution of the model
calls; the default NULL_TRACER costs nothing per step).
"""

from .cache_pool import (CachePoolError, CapacityError, DoubleFree,
                         KVCachePool, SlotKVPool, SlotPoolView)
from .engine import KV_LAYOUTS, SUPPORTED_FAMILIES, ServingEngine
from .observe import NULL_TRACER, NullTracer, ServingTracer
from .paged import OutOfBlocks, PagedKVPool, PagedPoolView
from .request import Request, SamplingParams, Status
from .scheduler import (CHUNK_QUANTUM, QueueFull, RequestQueue, plan_chunks,
                        resolve_token_budget, validate_token_budget)
from .trace import (TraceRequest, fleet_trace, load_trace, long_prompt_trace,
                    poisson_trace, replay, save_trace)
