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
``n_model_calls`` counts ``unified_step`` calls.  With ``kv_dtype="int8"``
the views carry the pool's scale arenas, so every layer quantizes its fresh
KV as it writes it and dequantizes inside attention.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import transformer as tfm
from .cache_pool import SlotKVPool, SlotPoolView
from .paged import PagedKVPool, PagedPoolView


class TransformerAdapter:
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
        self.n_model_calls = 0

    def _step(self, view, tokens: np.ndarray) -> torch.Tensor:
        self.n_model_calls += 1
        toks = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        with torch.no_grad():
            logits, _ = tfm.unified_step(self.params, view, {"tokens": toks},
                                         self.cfg)
        return logits

    def _scales(self) -> dict:
        return {"k_scale": self.pool.k_scale, "v_scale": self.pool.v_scale}

    def step_chunk(self, lanes, cur, n_new, tokens) -> torch.Tensor:
        p, S = self.pool, tokens.shape[1]
        if self.kv_layout == "paged":
            view = PagedPoolView.build(p.k, p.v, lanes, cur, n_new, S,
                                       trash=p.trash_block, **self._scales())
        else:
            view = SlotPoolView.build(p.k, p.v, lanes, cur, n_new, S,
                                      **self._scales())
        return self._step(view, tokens)

    def step_decode(self, tokens, active: list[int]) -> torch.Tensor:
        p = self.pool
        if self.kv_layout == "paged":
            n_new = np.zeros_like(p.pos)
            n_new[active] = 1
            view = PagedPoolView.build(p.k, p.v, p.host_tables, p.pos, n_new,
                                       1, trash=p.trash_block,
                                       device_tables=p.block_tables,
                                       **self._scales())
        else:
            view = SlotPoolView.build(p.k, p.v, None, p.pos,
                                      np.ones_like(p.pos), 1,
                                      **self._scales())
        return self._step(view, tokens)
