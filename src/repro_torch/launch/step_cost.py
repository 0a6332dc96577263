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
                  the sliding window applied, in every attention layer;
                  plus, for the recurrent families, 4 x H x dk x dv per
                  real row in every layer whose recurrence has a matrix
                  state (mLSTM, Mamba2: the state update's outer product
                  and the read-out);
  bytes_accessed  the projections' deployed bytes (values, metadata,
                  outliers and scales) read once, plus each lane's visible
                  KV read once and its fresh KV written once, int8 arenas'
                  f32 scales included; plus, for the recurrent families,
                  every lane's state read once and written once in every
                  layer.

A moe layer adds its routed experts, which a step reads only where it
routes: 2 flops per expert weight for each of the T x k (row, choice)
pairs of its T = B x S rows (padding rows route too), and the bytes of
min(E, T x k) experts, the most the pairs can touch (a bound: two pairs
may share an expert).  Its router and shared expert count as projections.

An enc-dec step call (the decoder) adds its cross-attention: 4 x H x hd
per context row of every real row and each lane's context rows read once
(``ctx_len``), in every decoder layer.  An encoder call
(``encode_cost``) reads the encoder's projections and every decoder
layer's ``c_wk``/``c_wv``, does 4 x H x hd per (query, key) pair of its
bidirectional attention in every encoder layer, and writes the context
rows it projects.

The projections a step reads: every layer's for the dense family; for ssm
(xLSTM) an mLSTM layer's ``w_up``, ``w_q``, ``w_k``, ``w_v``, ``w_gates``
and ``w_down`` and an sLSTM layer's ``w_up``, ``w_slstm``, ``r_gates``
and ``w_down``; for hybrid (Zamba2) each mamba layer's ``in_proj`` and
``out_proj`` and the shared block's projections once per application
(each application reads them again).  The attention layers are the dense
family's layers and the hybrid family's applications.

The embedding, the final norm, the dense output head and the activations
are left out, as PERF.md's bound of a step leaves them out.  The figures
are not comparable with the reference's: its ``unified_step`` scans the
layers (``src/repro/models/transformer.py``), and XLA's cost analysis
counts a scan body once (``src/repro/launch/hlo_analysis.py``), so its
figure is about one layer's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.sparse_serving import SparseWeight
from ..parallel.tensor_parallel import RowShard

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
MLSTM_PROJECTIONS = ("w_up", "w_q", "w_k", "w_v", "w_gates", "w_down")
SLSTM_PROJECTIONS = ("w_up", "w_slstm", "r_gates", "w_down")
MAMBA_PROJECTIONS = ("in_proj", "out_proj")
MOE_PROJECTIONS = ("router", "ws_gate", "ws_up", "ws_down")
DECODER_PROJECTIONS = ("wq", "wk", "wv", "wo", "c_wq", "c_wo", "w_up",
                       "w_down")
ENCODER_PROJECTIONS = ("wq", "wk", "wv", "wo", "w_up", "w_down")
CONTEXT_PROJECTIONS = ("c_wk", "c_wv")


def _read_layers(params, cfg, kind: str = "step") -> list:
    """(layer dict, names of the projections a call reads there), once
    per time the call reads them; ``kind`` "encode" is an enc-dec model's
    encoder call."""
    fam = "dense" if cfg is None else cfg.family
    if fam == "encdec":
        if kind == "encode":
            return [(lp, ENCODER_PROJECTIONS) for lp in params["enc"]] + \
                [(lp, CONTEXT_PROJECTIONS) for lp in params["dec"]]
        return [(lp, DECODER_PROJECTIONS) for lp in params["dec"]]
    if fam == "moe":
        return [pair for lp in params["layers"]
                for pair in ((lp, PROJECTIONS), (lp["moe"], MOE_PROJECTIONS))]
    if fam == "ssm":
        k = cfg.slstm_every
        return [(lp, SLSTM_PROJECTIONS if k and i % k == k - 1
                 else MLSTM_PROJECTIONS)
                for i, lp in enumerate(params["layers"])]
    if fam == "hybrid":
        apps = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        return [(lp, MAMBA_PROJECTIONS) for lp in params["mamba"]] + \
            [(params["shared_attn"], PROJECTIONS)] * apps
    return [(lp, PROJECTIONS) for lp in params["layers"]]


def weight_totals(params, cfg=None, kind: str = "step") -> tuple[int, int]:
    """(kept weights, deployed bytes) of the projections one call of
    ``kind`` reads (the dense family's step when ``cfg`` is None)."""
    kept = nbytes = 0
    for lp, names in _read_layers(params, cfg, kind):
        for name in names:
            w = lp.get(name)
            if isinstance(w, RowShard):          # a mesh rank's rows
                w = w.local
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


def attention_layers(cfg) -> int:
    """The layers (applications, for hybrid) that attend over KV."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    return cfg.n_layers


def recurrent_state(cfg) -> tuple[int, int]:
    """(f32 bytes of one lane's recurrent state over every layer, the
    recurrences' flops per real row over every layer); (0, 0) for a
    family without recurrent state."""
    if cfg.family == "ssm":
        H = cfg.n_heads
        dh = 2 * cfg.d_model // H
        k = cfg.slstm_every
        n_s = sum(1 for i in range(cfg.n_layers) if k and i % k == k - 1)
        n_m = cfg.n_layers - n_s
        return (4 * (n_m * (H * dh * dh + H * dh) + n_s * 4 * H * dh),
                n_m * 4 * H * dh * dh)
    if cfg.family == "hybrid":
        H = 2 * cfg.d_model // cfg.ssm_head_dim
        per = H * cfg.ssm_state * cfg.ssm_head_dim
        return 4 * cfg.n_layers * per, cfg.n_layers * 4 * per
    return 0, 0


def kv_bytes_per_position(cfg, kv_dtype: str = "bf16") -> int:
    """Bytes one position of one layer holds in the K and V arenas: values
    in the model's dtype (bf16 on the card), or int8 values plus an f32
    scale per KV head."""
    per = cfg.n_kv_heads * cfg.hd
    if kv_dtype == "int8":
        return 2 * (per + 4 * cfg.n_kv_heads)
    return 2 * per * cfg.dtype.itemsize


def routed_experts(cfg, rows: int) -> tuple[int, int]:
    """(flops, bytes) of a moe model's routed experts over ``rows`` token
    rows, every layer; (0, 0) without ``cfg.moe``."""
    m = cfg.moe
    if m is None:
        return 0, 0
    per_expert = (3 if cfg.glu else 2) * cfg.d_model * m.d_ff_expert
    pairs = rows * m.top_k
    return (cfg.n_layers * 2 * per_expert * pairs,
            cfg.n_layers * min(m.num_experts, pairs) * per_expert
            * cfg.dtype.itemsize)


def step_cost(cfg, weights: tuple[int, int], cursor, n_new, rows: int,
              kv_dtype: str = "bf16", ctx_len=None) -> dict:
    """{"flops", "bytes_accessed"} of one ``unified_step`` over lanes at
    ``cursor`` [B] writing ``n_new`` [B] fresh positions, ``rows`` = B x S
    token rows, with ``weights`` from ``weight_totals``; ``ctx_len`` [B]
    are an enc-dec step's context rows a lane."""
    kept, w_bytes = weights
    cursor = np.asarray(cursor, np.int64)
    n_new = np.asarray(n_new, np.int64)
    L = attention_layers(cfg)
    state_bytes, rec_flops = recurrent_state(cfg)
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
    moe_flops, moe_bytes = routed_experts(cfg, rows)
    ctx_flops = ctx_bytes = 0
    if ctx_len is not None:
        ctx = np.where(n_new > 0, np.asarray(ctx_len, np.int64), 0)
        ctx_flops = L * 4 * cfg.n_heads * cfg.hd * int((ctx * n_new).sum())
        ctx_bytes = L * per_pos * int(ctx.sum())
    return {"flops": L * attn_flops + 2 * kept * rows
            + rec_flops * int(n_new.sum()) + moe_flops + ctx_flops,
            "bytes_accessed": w_bytes
            + L * per_pos * int(read.sum() + n_new.sum())
            + 2 * state_bytes * len(n_new) + moe_bytes + ctx_bytes}


def encode_cost(cfg, weights: tuple[int, int], s_enc: int) -> dict:
    """{"flops", "bytes_accessed"} of one enc-dec encoder call over
    ``s_enc`` frames (one request), with ``weights`` from
    ``weight_totals(..., kind="encode")``: the projections, the encoder's
    attention products over all s_enc^2 pairs, and the context rows it
    writes (every decoder layer's ck/cv)."""
    kept, w_bytes = weights
    attn = cfg.enc_layers * 4 * cfg.n_heads * cfg.hd * s_enc * s_enc
    return {"flops": 2 * kept * s_enc + attn,
            "bytes_accessed": w_bytes + cfg.n_layers * s_enc
            * kv_bytes_per_position(cfg)}
