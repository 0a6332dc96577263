"""Decoder-only transformer of the dense family, serving path (port of
``repro/models/transformer.py``).

Parameters are a dict ``{"embed", "layers", "final_norm", "lm_head"}``
where ``layers`` is a list of per-layer dicts (the JAX package stacks them
[L, ...] for ``lax.scan``; the port loops over layers in Python).  A
projection is a dense [out, in] tensor or a ``SparseWeight``.

``unified_step`` is the only serving entry: chunked prefill (S = chunk),
one-shot prefill (S = prompt, cursor 0) and fused decode (S = 1 over every
lane) all write their fresh KV into the slot arena at the cursor and attend
in place, with the cursor as a length mask.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve
from .layers import activation, apply_rope, attend_length_masked, linear, rms_norm


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
    """``q`` [B, S, H, hd] attends directly against the slot arena slice in
    ``pool_view`` with the per-lane cursor as a length mask (the JAX
    primitive's slot branch; the paged branch is ROADMAP A5)."""
    if pool_view.block_tables is not None:
        raise NotImplementedError("the paged KV layout is ROADMAP A5")
    k_rows, v_rows = pool_view.lane_kv(pool_view.k, pool_view.v)
    return attend_length_masked(q, k_rows, v_rows, pool_view.cursor,
                                window=window)


def _block_step(lp, x, k_l, v_l, view, positions, cfg):
    """One block: project q/k/v at the lane positions, scatter the fresh KV
    into the layer's arena slice in place, attend over the pool."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(lp, h, cfg, positions)
    k_l, v_l = view.write_layer(k_l, v_l, k, v)
    attn = attend_over_pool(q, dataclasses.replace(view, k=k_l, v=v_l),
                            window=cfg.window)
    x = x + linear(lp["wo"], attn.reshape(B, S, -1))
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp(lp, h, cfg), k_l, v_l


def unified_step(params, view, batch, cfg):
    """One attend-in-place step over the slot pool.

    ``batch["tokens"]`` [B, S] are the next S tokens of each lane, starting
    at ``view.cursor``.  Returns (logits [B, S, V], (k, v)); the arenas are
    ``view.k``/``view.v``, updated in place."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = view.cursor[:, None] + torch.arange(S, device=tokens.device)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _block_step(lp, x, view.k[i], view.v[i], view, positions,
                              cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return linear(params["lm_head"], x), (view.k, view.v)
