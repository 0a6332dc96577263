"""Continuous-batching serving on the slot or the paged KV layout.

  engine = ServingEngine(cfg, params, device="cuda", n_slots=8, max_len=256)
  engine = ServingEngine(..., kv_layout="paged", block_size=16)
  req = engine.submit(prompt_tokens, SamplingParams(max_new_tokens=16))
  engine.run()            # or engine.step() under an external loop
  req.tokens              # generated ids; req.metrics has ttft/e2e/...

Speculative decoding (serving/speculative.py): ``draft=SpeculativeConfig(
k=4, method="model", params=draft_params)`` drafts with a second model,
``method="ngram"`` by prompt lookup; greedy streams are unchanged.

A fleet (serving/fleet/): ``ReplicaSet(cfg, params, n_replicas=2,
routing="prefix", device="cuda", ...)`` puts N engines behind a
prefix-aware ``Router`` and takes the engine's submit/step/run surface
(plus ``session=``); its replicas share the card and the params.

Request traces (serving/trace.py: Poisson, long-prompt and fleet-shaped
workloads, JSON round-trip, open-loop ``replay``) and observability
(serving/observe.py: Perfetto spans of every step and request lifecycle, a
Prometheus-text counter registry, per-variant attribution of the model
calls; the default NULL_TRACER costs nothing per step).

The engine serves the dense, moe, ssm (xLSTM), hybrid (Zamba2) and encdec
(Whisper) families through their adapters (serving/families.py); recurrent
state lives in ``RecurrentStatePool`` slots and an enc-dec request's
encoder context in ``EncoderContextPool`` rows (serving/state_pool.py).

``mesh=`` (``launch/mesh.make_serving_mesh``) serves the dense family
tensor-parallel through ``ServingPlacement`` (serving/placement.py): one
process a rank, out-dim splits, token streams identical to the
single-device engine.
"""

from .cache_pool import (CachePoolError, CapacityError, DoubleFree,
                         KVCachePool, SlotKVPool, SlotPoolView)
from .engine import KV_LAYOUTS, SUPPORTED_FAMILIES, ServingEngine
from .families import (EncDecAdapter, FamilyAdapter, HybridAdapter,
                       RecurrentAdapter, TransformerAdapter, build_adapter)
from .fleet import ROUTING_POLICIES, ReplicaSet, RouteDecision, Router
from .observe import (NULL_ROUTER_TRACER, NULL_TRACER, NullRouterTracer,
                      NullTracer, RouterTracer, ServingTracer)
from .paged import OutOfBlocks, PagedKVPool, PagedPoolView
from .placement import ServingPlacement
from .request import Request, SamplingParams, Status
from .scheduler import (CHUNK_QUANTUM, QueueFull, RequestQueue, plan_chunks,
                        resolve_token_budget, spec_verify_reserve,
                        validate_token_budget)
from .speculative import SpeculativeConfig
from .state_pool import (EncDecPoolView, EncoderContextPool, HybridPoolView,
                         RecurrentStatePool, RecurrentStateView)
from .trace import (TraceRequest, fleet_trace, load_trace, long_prompt_trace,
                    poisson_trace, replay, save_trace)
