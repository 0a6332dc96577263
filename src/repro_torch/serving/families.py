"""Family adapter of the dense decoder on the slot layout (port of
``repro/serving/families.py``, ``TransformerAdapter``'s slot/bf16 branch).

The engine schedules requests; the adapter owns the KV pool and the two
step functions over ``transformer.unified_step``:

  ``step_chunk(lanes, cur, n_new, tokens)``
      run one (cursor, bucket) prefill-chunk group, return logits [B, S, V];
  ``step_decode(tokens)``
      run the fused S=1 decode over every lane, return logits
      [n_slots, 1, V].

Host arrays (lanes, cursors, tokens) go to the device here, once per step.
``n_model_calls`` counts ``unified_step`` calls.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import transformer as tfm
from .cache_pool import SlotKVPool, SlotPoolView


class TransformerAdapter:
    def __init__(self, cfg, params, *, n_slots: int, max_len: int, device):
        self.cfg, self.params, self.device = cfg, params, device
        self.pool = SlotKVPool(cfg, n_slots, max_len, device)
        self.n_model_calls = 0

    def _step(self, view: SlotPoolView, tokens: np.ndarray) -> torch.Tensor:
        self.n_model_calls += 1
        toks = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        with torch.no_grad():
            logits, _ = tfm.unified_step(self.params, view, {"tokens": toks},
                                         self.cfg)
        return logits

    def step_chunk(self, lanes, cur, n_new, tokens) -> torch.Tensor:
        p = self.pool
        view = SlotPoolView.build(p.k, p.v, lanes, cur, n_new,
                                  tokens.shape[1])
        return self._step(view, tokens)

    def step_decode(self, tokens) -> torch.Tensor:
        p = self.pool
        view = SlotPoolView.build(p.k, p.v, None, p.pos,
                                  np.ones_like(p.pos), 1)
        return self._step(view, tokens)
