"""The work of one serving step, counted from its shapes: the port's
counterpart of ``repro/launch/hlo_analysis.cost_summary`` for the serving
tracer's per-variant attribution (``serving/observe.py``).

The reference asks XLA for the compiled step's FLOPs and bytes accessed.
The port has no compiled module to ask, so this module counts the work the
step's kernels must do:

  flops           2 per kept weight (N:M values plus outliers, or every
                  entry of a dense projection) per token row the step
                  computes (B x S, padding lanes included: the weight
                  kernels multiply them), plus the two attention products,
                  4 x H x hd per visible key of every real row (i < n_new),
                  the sliding window applied;
  bytes_accessed  the projections' deployed bytes (values, metadata,
                  outliers and scales) read once, plus each lane's visible
                  KV read once and its fresh KV written once, int8 arenas'
                  f32 scales included.

Summed over the layers.  The embedding, the final norm, the dense output
head and the activations are left out, as PERF.md's bound of a step leaves
them out.  The figures are not comparable with the reference's: its
``unified_step`` scans the layers (``src/repro/models/transformer.py``),
and XLA's cost analysis counts a scan body once
(``src/repro/launch/hlo_analysis.py``), so its figure is about one layer's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.sparse_serving import SparseWeight

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def weight_totals(params) -> tuple[int, int]:
    """(kept weights, deployed bytes) of every layer's projections."""
    kept = nbytes = 0
    for lp in params["layers"]:
        for name in PROJECTIONS:
            w = lp.get(name)
            if isinstance(w, SparseWeight):
                out = w.nm_meta.shape[0]
                kept += out * w.in_dim * w.n // w.m
                if w.o_values is not None:
                    kept += w.o_values.numel()
                nbytes += w.deployed_bytes()
            elif isinstance(w, torch.Tensor):
                kept += w.numel()
                nbytes += w.numel() * w.element_size()
    return kept, nbytes


def kv_bytes_per_position(cfg, kv_dtype: str = "bf16") -> int:
    """Bytes one position of one layer holds in the K and V arenas: values
    in the model's dtype (bf16 on the card), or int8 values plus an f32
    scale per KV head."""
    per = cfg.n_kv_heads * cfg.hd
    if kv_dtype == "int8":
        return 2 * (per + 4 * cfg.n_kv_heads)
    return 2 * per * cfg.dtype.itemsize


def step_cost(cfg, weights: tuple[int, int], cursor, n_new, rows: int,
              kv_dtype: str = "bf16") -> dict:
    """{"flops", "bytes_accessed"} of one ``unified_step`` over lanes at
    ``cursor`` [B] writing ``n_new`` [B] fresh positions, ``rows`` = B x S
    token rows, with ``weights`` from ``weight_totals``."""
    kept, w_bytes = weights
    cursor = np.asarray(cursor, np.int64)
    n_new = np.asarray(n_new, np.int64)
    L = cfg.n_layers
    # visible keys of row i of lane b: positions <= cursor + i, the last
    # ``window`` of them when the model has one
    t_max = int(n_new.max(initial=0))
    i = np.arange(t_max)[None]
    real = i < n_new[:, None]
    visible = cursor[:, None] + i + 1
    # the positions any row of a lane reads: its last row's window back to
    # its first row's
    first = np.zeros_like(cursor)
    if cfg.window is not None:
        visible = np.minimum(visible, cfg.window)
        first = np.maximum(cursor + 1 - cfg.window, 0)
    read = np.where(n_new > 0, cursor + n_new - first, 0)
    attn_flops = 4 * cfg.n_heads * cfg.hd * int((visible * real).sum())
    per_pos = kv_bytes_per_position(cfg, kv_dtype)
    return {"flops": L * attn_flops + 2 * kept * rows,
            "bytes_accessed": w_bytes
            + L * per_pos * int(read.sum() + n_new.sum())}
