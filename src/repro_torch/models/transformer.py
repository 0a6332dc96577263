"""Decoder-only transformer of the dense family, serving path (port of
``repro/models/transformer.py``).

Parameters are a dict ``{"embed", "layers", "final_norm", "lm_head"}``
where ``layers`` is a list of per-layer dicts (the JAX package stacks them
[L, ...] for ``lax.scan``; the port loops over layers in Python).  A
projection is a dense [out, in] tensor or a ``SparseWeight``.

``unified_step`` is the only serving entry: chunked prefill (S = chunk),
one-shot prefill (S = prompt, cursor 0) and fused decode (S = 1 over every
lane) all write their fresh KV into the arena at the cursor (slot rows, or
paged blocks through the block tables) and attend in place, with the cursor
as a length mask.  A view with scale arenas (int8 KV) quantizes the fresh
KV as it scatters it and dequantizes inside attention.

``forward`` and ``loss_fn`` are the full-sequence entries of calibration
and evaluation (``eval/harness.py``): each block attends over its own
sequence with ``layers.sdpa``, and every projection goes through
``layers.linear``, so ``SparseWeight`` params take the sparse kernels.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve
from .layers import (activation, apply_rope, attend_length_masked, linear,
                     rms_norm, sdpa)


def _dense_init(out_dim: int, in_dim: int, dtype, generator, device):
    w = torch.randn((out_dim, in_dim), generator=generator, device=device,
                    dtype=torch.float32)
    return (w / math.sqrt(in_dim)).to(dtype)


def init_layer(cfg, generator: torch.Generator, device) -> dict:
    """One block's dense parameters, drawn from ``generator``."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def dense(out_dim, in_dim):
        return _dense_init(out_dim, in_dim, cfg.dtype, generator, device)

    lp = {"attn_norm": torch.zeros((d,), dtype=cfg.dtype, device=device),
          "wq": dense(H * hd, d), "wk": dense(KV * hd, d),
          "wv": dense(KV * hd, d), "wo": dense(d, H * hd),
          "mlp_norm": torch.zeros((d,), dtype=cfg.dtype, device=device)}
    if cfg.glu:
        lp["w_gate"] = dense(cfg.d_ff, d)
    lp["w_up"] = dense(cfg.d_ff, d)
    lp["w_down"] = dense(d, cfg.d_ff)
    return lp


def init_params(cfg, generator: torch.Generator, device="cuda",
                layer_fn=None) -> dict:
    """Random parameters drawn from ``generator`` on ``device``.

    ``layer_fn(lp)`` transforms each layer as soon as it is drawn (the
    serving CLI sparsifies there), so the dense weights of all layers never
    coexist: a full-size model is built one layer at a time."""
    device = resolve(device)
    layers = []
    for _ in range(cfg.n_layers):
        lp = init_layer(cfg, generator, device)
        layers.append(layer_fn(lp) if layer_fn is not None else lp)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=device, dtype=torch.float32) * 0.02
    return {"embed": embed.to(cfg.dtype), "layers": layers,
            "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                      device=device),
            "lm_head": _dense_init(cfg.vocab, cfg.d_model, cfg.dtype,
                                   generator, device)}


def _project_qkv(lp, x, cfg, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(lp["wq"], x).reshape(B, S, H, hd)
    k = linear(lp["wk"], x).reshape(B, S, KV, hd)
    v = linear(lp["wv"], x).reshape(B, S, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp(lp, x, cfg):
    if cfg.glu:
        hidden = activation(cfg.act, linear(lp["w_gate"], x)) \
            * linear(lp["w_up"], x)
    else:
        hidden = activation(cfg.act, linear(lp["w_up"], x))
    return linear(lp["w_down"], hidden)


def attend_over_pool(q, pool_view, *, window: int | None = None):
    """``q`` [B, S, H, hd] attends directly against one layer's arena slice
    in ``pool_view`` with the per-lane cursor as a length mask: slot rows
    (``SlotPoolView``) or paged blocks through the block tables
    (``PagedPoolView``, the paged-attention kernel on the card).  An int8
    arena's scale slices (``k_scale``/``v_scale``) dequantize it."""
    ks, vs = pool_view.k_scale, pool_view.v_scale
    if pool_view.block_tables is not None:
        from ..serving.paged.paged_attention import paged_attention
        return paged_attention(q, pool_view.k, pool_view.v,
                               pool_view.block_tables, pool_view.cursor,
                               window=window, k_scale=ks, v_scale=vs)
    k_rows, v_rows = pool_view.lane_kv(pool_view.k, pool_view.v)
    if ks is not None:
        ks, vs = pool_view.lane_kv(ks, vs)
    return attend_length_masked(q, k_rows, v_rows, pool_view.cursor,
                                window=window, k_scale=ks, v_scale=vs)


def _block_step(lp, x, k_l, v_l, view, positions, cfg, ks_l=None,
                vs_l=None):
    """One block: project q/k/v at the lane positions, scatter the fresh KV
    into the layer's arena slice in place (quantized per position when the
    layer's scale slices ``ks_l``/``vs_l`` are given), attend over the
    pool."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(lp, h, cfg, positions)
    if ks_l is not None:
        view.write_layer_quantized(k_l, v_l, ks_l, vs_l, k, v)
    else:
        view.write_layer(k_l, v_l, k, v)
    attn = attend_over_pool(
        q, dataclasses.replace(view, k=k_l, v=v_l, k_scale=ks_l,
                               v_scale=vs_l),
        window=cfg.window)
    x = x + linear(lp["wo"], attn.reshape(B, S, -1))
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp(lp, h, cfg)


def unified_step(params, view, batch, cfg):
    """One attend-in-place step over the pool (slot or paged view).

    ``batch["tokens"]`` [B, S] are the next S tokens of each lane, starting
    at ``view.cursor``.  Returns (logits [B, S, V], (k, v)), or
    (logits, (k, v, k_scale, v_scale)) for an int8 view; the arenas are the
    view's, updated in place."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = view.cursor[:, None] + torch.arange(S, device=tokens.device)
    quantized = view.k_scale is not None
    for i, lp in enumerate(params["layers"]):
        scales = ((view.k_scale[i], view.v_scale[i]) if quantized
                  else (None, None))
        x = _block_step(lp, x, view.k[i], view.v[i], view, positions, cfg,
                        *scales)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    arenas = (view.k, view.v)
    if quantized:
        arenas += (view.k_scale, view.v_scale)
    return linear(params["lm_head"], x), arenas


# --------------------------------------------------------------------------
# full-sequence forward (calibration, evaluation)
# --------------------------------------------------------------------------

def _embed_inputs(params, batch):
    """(x [B, S, d], positions [B, S]) of a token batch."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    return params["embed"][tokens], positions


def block_forward(lp, x, positions, cfg, q_chunks: int = 1):
    """One causal block over a full sequence.  Returns (y, (k, v))."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(lp, h, cfg, positions)
    attn = sdpa(q, k, v, causal=True, window=cfg.window, q_chunks=q_chunks)
    x = x + linear(lp["wo"], attn.reshape(*attn.shape[:2], -1))
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp(lp, h, cfg), (k, v)


def _auto_q_chunks(S: int) -> int:
    return max(1, S // 4096) if S > 8192 else 1


def forward(params, batch, cfg, collect_kv: bool = False):
    """Full-sequence forward.  Returns (logits [B, S, V], caches): caches
    are the stacked (k, v) [L, B, S, KV, hd] with ``collect_kv``, else
    None."""
    x, positions = _embed_inputs(params, batch)
    q_chunks = _auto_q_chunks(x.shape[1])
    kvs = []
    for lp in params["layers"]:
        x, kv = block_forward(lp, x, positions, cfg, q_chunks)
        if collect_kv:
            kvs.append(kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = None
    if collect_kv:
        caches = (torch.stack([k for k, _ in kvs]),
                  torch.stack([v for _, v in kvs]))
    return linear(params["lm_head"], x), caches


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy over labels >= 0, in f32.  Returns
    (loss, aux); aux is empty for the dense family."""
    logits, _ = forward(params, batch, cfg)
    labels = batch["labels"]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum((lse - gold) * mask) / torch.sum(mask).clamp_min(1.0)
    return loss, {}
