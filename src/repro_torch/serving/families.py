"""Family adapter of the dense decoder (port of ``repro/serving/families.py``,
``TransformerAdapter`` on the slot and paged layouts, with bf16 or int8 KV
arenas).

The engine schedules requests; the adapter owns the KV pool and the two
step functions over ``transformer.unified_step``:

  ``step_chunk(lanes, cur, n_new, tokens)``
      run one (cursor, bucket) prefill-chunk group, return logits [B, S, V];
      ``lanes`` are the lanes' slots (slot layout) or block tables (paged);
  ``step_decode(tokens, active)``
      run the fused S=1 decode over every lane, return logits
      [n_slots, 1, V].  On the paged layout only the ``active`` rows write
      their KV; the slot layout writes every lane (a stray write lands
      where the next chunk or occupant overwrites it before any read).

Host arrays (lanes, cursors, tokens) go to the device here, once per step.
``n_model_calls`` counts ``unified_step`` calls.  Each call runs through
``_traced``: a direct call under the default ``NULL_TRACER``, else the
engine's ``ServingTracer.jit_call`` with kinds "step" (chunk groups) and
"decode", keyed by the host arrays' shapes and costed by ``step_cost``.
With ``kv_dtype="int8"`` the views carry the pool's scale arenas, so every
layer quantizes its fresh KV as it writes it and dequantizes inside
attention.
"""
from __future__ import annotations

import numpy as np
import torch

from ..launch import step_cost as cost
from ..models import transformer as tfm
from .cache_pool import SlotKVPool, SlotPoolView
from .observe import NULL_TRACER
from .paged import PagedKVPool, PagedPoolView


class TransformerAdapter:
    # observability: the engine installs its ServingTracer here when
    # tracing is on; NULL_TRACER keeps ``_traced`` a direct call
    tracer = NULL_TRACER
    # distinguishes co-resident adapters sharing one tracer (the
    # reference's speculative draft model attributes as "draft_step")
    trace_kind_prefix = ""

    def __init__(self, cfg, params, *, n_slots: int, max_len: int, device,
                 kv_layout: str = "slot", block_size: int = 16,
                 n_blocks: int | None = None, prefix_caching: bool = True,
                 kv_dtype: str = "bf16"):
        self.cfg, self.params, self.device = cfg, params, device
        self.kv_layout = kv_layout
        if kv_layout == "paged":
            self.pool = PagedKVPool(cfg, n_slots, max_len, device=device,
                                    block_size=block_size, n_blocks=n_blocks,
                                    prefix_caching=prefix_caching,
                                    kv_dtype=kv_dtype)
        else:
            self.pool = SlotKVPool(cfg, n_slots, max_len, device,
                                   kv_dtype=kv_dtype)
        self.kv_dtype = kv_dtype
        self.n_model_calls = 0
        self._weights = None                   # step_cost's weight totals

    def _traced(self, kind: str, fn, args: tuple):
        """Run a model call, attributed when tracing is on: wall and issue
        time, new-variant detection and its work per shape variant
        (``ServingTracer.jit_call``)."""
        if not self.tracer.enabled:
            return fn(*args)
        return self.tracer.jit_call(self.trace_kind_prefix + kind, fn, args)

    def step_cost(self, lanes, cur, n_new, tokens) -> dict:
        """The call's FLOPs and bytes (``launch/step_cost.py``), from the
        same host arrays the call takes."""
        if self._weights is None:
            self._weights = cost.weight_totals(self.params)
        return cost.step_cost(self.cfg, self._weights, cur, n_new,
                              tokens.size, self.kv_dtype)

    def _scales(self) -> dict:
        return {"k_scale": self.pool.k_scale, "v_scale": self.pool.v_scale}

    def _run(self, view, tokens: np.ndarray) -> torch.Tensor:
        toks = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        with torch.no_grad():
            logits, _ = tfm.unified_step(self.params, view, {"tokens": toks},
                                         self.cfg)
        return logits

    def _chunk(self, lanes, cur, n_new, tokens) -> torch.Tensor:
        p, S = self.pool, tokens.shape[1]
        if self.kv_layout == "paged":
            view = PagedPoolView.build(p.k, p.v, lanes, cur, n_new, S,
                                       trash=p.trash_block, **self._scales())
        else:
            view = SlotPoolView.build(p.k, p.v, lanes, cur, n_new, S,
                                      **self._scales())
        return self._run(view, tokens)

    def _decode(self, lanes, cur, n_new, tokens) -> torch.Tensor:
        p = self.pool
        if self.kv_layout == "paged":
            view = PagedPoolView.build(p.k, p.v, lanes, cur, n_new, 1,
                                       trash=p.trash_block,
                                       device_tables=p.block_tables,
                                       **self._scales())
        else:
            view = SlotPoolView.build(p.k, p.v, None, cur, n_new, 1,
                                      **self._scales())
        return self._run(view, tokens)

    def step_chunk(self, lanes, cur, n_new, tokens) -> torch.Tensor:
        self.n_model_calls += 1
        return self._traced("step", self._chunk, (lanes, cur, n_new, tokens))

    def step_decode(self, tokens, active: list[int]) -> torch.Tensor:
        p = self.pool
        self.n_model_calls += 1
        if self.kv_layout == "paged":
            n_new = np.zeros_like(p.pos)
            n_new[active] = 1
            lanes = p.host_tables
        else:
            n_new, lanes = np.ones_like(p.pos), None
        return self._traced("decode", self._decode,
                            (lanes, p.pos, n_new, tokens))
