"""Decoder-only transformer of the dense and moe families and the vlm
backbone (port of ``repro/models/transformer.py``): llama2/3, mistral
(window), qwen3 (``qk_norm``), gemma (GeGLU, head dim 256, tied
embeddings), internlm2, nemotron-4 (squared ReLU, non-gated), mixtral and
llama4 (a ``moe`` FFN, ``models/moe.py``, in every layer) and qwen2-vl's
backbone (M-RoPE, ``embeds`` inputs).

Parameters are a dict ``{"embed", "layers", "final_norm"}`` plus
``"lm_head"`` unless ``cfg.tie_embeddings`` (then the head is ``embed``),
where ``layers`` is a list of per-layer dicts (the JAX package stacks them
[L, ...] for ``lax.scan``; the port loops over layers in Python).  A
projection is a dense [out, in] tensor or a ``SparseWeight``; with
``qk_norm`` a layer also holds the [hd] ``q_norm``/``k_norm`` scales, and
with ``moe`` its FFN is ``lp["moe"]`` (``moe.init_moe``'s dict) in place of
``w_gate``/``w_up``/``w_down``.

``unified_step`` is the only serving entry: chunked prefill (S = chunk),
one-shot prefill (S = prompt, cursor 0) and fused decode (S = 1 over every
lane) all write their fresh KV into the arena at the cursor (slot rows, or
paged blocks through the block tables) and attend in place, with the cursor
as a length mask.  A view with scale arenas (int8 KV) quantizes the fresh
KV as it scatters it and dequantizes inside attention.

``forward`` and ``loss_fn`` are the full-sequence entries of calibration,
evaluation and training (``eval/harness.py``, ``launch/steps.py``): each
block attends over its own sequence with ``layers.sdpa``, and every
projection goes through ``layers.linear``, so ``SparseWeight`` params take
the sparse kernels.

``init_cache``, ``prefill``, ``block_decode`` and ``decode_lockstep`` are
the model zoo's lock-step contract (``models/model_zoo.py``): the
[L, B, Smax, KV, hd] cache is a slot arena with one slot per row, so
``decode_lockstep`` is ``unified_step`` with an identity lane map and
S = 1, and updates the cache in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..parallel import policy as pol
from . import moe as moe_lib
from .layers import (activation, apply_rope, attend_length_masked,
                     dense_init, embed, linear, rms_norm, sdpa)


def _check_family(cfg) -> None:
    """Raise for the ssm, hybrid and encdec families, whose stacks are
    ``models/xlstm.py``, ``models/zamba.py`` and ``models/whisper.py``."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name}: the {cfg.family} family has no "
                         f"transformer stack")


def init_layer(cfg, generator: torch.Generator, device) -> dict:
    """One block's dense parameters, drawn from ``generator``."""
    _check_family(cfg)
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def dense(out_dim, in_dim):
        return dense_init(out_dim, in_dim, cfg.dtype, generator, device)

    lp = {"attn_norm": torch.zeros((d,), dtype=cfg.dtype, device=device),
          "wq": dense(H * hd, d), "wk": dense(KV * hd, d),
          "wv": dense(KV * hd, d), "wo": dense(d, H * hd),
          "mlp_norm": torch.zeros((d,), dtype=cfg.dtype, device=device)}
    if cfg.qk_norm:
        lp["q_norm"] = torch.zeros((hd,), dtype=cfg.dtype, device=device)
        lp["k_norm"] = torch.zeros((hd,), dtype=cfg.dtype, device=device)
    if cfg.moe is not None:
        lp["moe"] = moe_lib.init_moe(cfg, generator, device)
        return lp
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
    coexist: a full-size model is built one layer at a time.  With
    ``cfg.tie_embeddings`` there is no ``lm_head``: the head is ``embed``."""
    _check_family(cfg)
    device = resolve(device)
    layers = []
    for _ in range(cfg.n_layers):
        lp = init_layer(cfg, generator, device)
        layers.append(layer_fn(lp) if layer_fn is not None else lp)
    # the f32 draw lives only until it is rounded (nemotron-4-340b's
    # 256,000 x 18,432 embedding is 18.9 GB in f32)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=device, dtype=torch.float32).mul_(0.02)
    embed = embed.to(cfg.dtype)
    params = {"embed": embed, "layers": layers,
              "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                        device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(cfg.vocab, cfg.d_model, cfg.dtype,
                                        generator, device)
    return params


def _head(params, cfg):
    """The output projection: ``embed`` under tied embeddings."""
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _project_qkv(lp, x, cfg, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(lp["wq"], x).reshape(B, S, H, hd)
    k = linear(lp["wk"], x).reshape(B, S, KV, hd)
    v = linear(lp["wv"], x).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _mlp(lp, x, cfg):
    if cfg.moe is not None:
        return moe_lib.moe_apply(lp["moe"], x, cfg)
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
                vs_l=None, heads=None):
    """One block: project q/k/v at the lane positions, scatter the fresh KV
    into the layer's arena slice in place (quantized per position when the
    layer's scale slices ``ks_l``/``vs_l`` are given), attend over the
    pool.  With ``heads`` (a ``HeadShard``: the arena holds this rank's KV
    heads) the rank writes and attends its own heads and gathers the
    attention output over heads before ``wo``."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(lp, h, cfg, positions)
    if heads is not None:
        q, k, v = heads.local(q, k, v)
    if ks_l is not None:
        view.write_layer_quantized(k_l, v_l, ks_l, vs_l, k, v)
    else:
        view.write_layer(k_l, v_l, k, v)
    attn = attend_over_pool(
        q, dataclasses.replace(view, k=k_l, v=v_l, k_scale=ks_l,
                               v_scale=vs_l),
        window=cfg.window)
    if heads is not None:
        attn = heads.gather(attn)
    x = x + linear(lp["wo"], attn.reshape(B, S, -1))
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp(lp, h, cfg)


def _pool_positions(cursor: torch.Tensor, S: int, cfg) -> torch.Tensor:
    """RoPE positions of S fresh tokens a lane from ``cursor`` [B]: [B, S],
    or [3, B, S] under M-RoPE (t/h/w share the text position on the
    serving path)."""
    base = cursor[:, None] + torch.arange(S, device=cursor.device)
    if cfg.mrope_sections is not None:
        return base.expand(3, *base.shape)
    return base


def unified_step(params, view, batch, cfg, heads=None):
    """One attend-in-place step over the pool (slot or paged view).

    ``batch["tokens"]`` [B, S] are the next S tokens of each lane, starting
    at ``view.cursor``.  Returns (logits [B, S, V], (k, v)), or
    (logits, (k, v, k_scale, v_scale)) for an int8 view; the arenas are the
    view's, updated in place.  On a mesh, ``params`` are a rank's
    (``ServingPlacement.place_params``) and ``heads`` its attention heads
    when the arenas hold only those (``ServingPlacement.heads``)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = embed(params["embed"], tokens)
    positions = _pool_positions(view.cursor, S, cfg)
    quantized = view.k_scale is not None
    for i, lp in enumerate(params["layers"]):
        scales = ((view.k_scale[i], view.v_scale[i]) if quantized
                  else (None, None))
        x = _block_step(lp, x, view.k[i], view.v[i], view, positions, cfg,
                        *scales, heads=heads)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    arenas = (view.k, view.v)
    if quantized:
        arenas += (view.k_scale, view.v_scale)
    return linear(_head(params, cfg), x), arenas


def init_cache(cfg, batch_size: int, max_len: int, device="cuda") -> dict:
    """Zeroed lock-step caches: ``k``/``v`` [L, B, max_len, KV, hd] in the
    model's dtype and the filled length ``pos``, a scalar."""
    device = resolve(device)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _cursor_vec(pos: torch.Tensor, B: int) -> np.ndarray:
    """[B] host cursor from a scalar (lock-step batch) or per-row ``pos``."""
    p = np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos,
                   np.int64)
    return np.broadcast_to(p, (B,)).copy()


def block_decode(lp, x, k_cache, v_cache, pos, cfg):
    """One-token block over contiguous caches: x [B, 1, d], caches
    [B, Smax, KV, hd] (written in place at ``pos``, a scalar or [B] vector
    of filled lengths).  Returns (y, k_cache, v_cache); the same in-place
    block as ``unified_step``'s."""
    from ..serving.cache_pool import SlotPoolView
    B = x.shape[0]
    cursor = _cursor_vec(pos, B)
    view = SlotPoolView.build(k_cache[None], v_cache[None], None, cursor,
                              np.ones(B, np.int64), 1)
    y = _block_step(lp, x, k_cache, v_cache, view,
                    _pool_positions(view.cursor, 1, cfg), cfg)
    return y, k_cache, v_cache


def decode_lockstep(params, caches, batch, cfg, heads=None):
    """One new token for every row through ``unified_step``: batch
    ``{"tokens": [B, 1]}``, caches from ``init_cache`` or ``prefill`` (grown
    by ``model_zoo.grow_caches`` to hold the new position).  ``pos`` is a
    scalar or a [B] vector.  Writes the fresh KV into ``caches`` in place and
    returns (logits [B, V], {"k", "v", "pos": pos + 1}).  On a mesh,
    ``heads`` is the rank's share of the heads when the caches hold only
    its KV heads (``ServingPlacement.heads``)."""
    from ..serving.cache_pool import SlotPoolView
    tokens = batch["tokens"]
    B = tokens.shape[0]
    pos = caches["pos"]
    view = SlotPoolView.build(caches["k"], caches["v"], None,
                              _cursor_vec(pos, B), np.ones(B, np.int64), 1)
    logits, (k, v) = unified_step(params, view, {"tokens": tokens}, cfg,
                                  heads=heads)
    return logits[:, -1], {"k": k, "v": v, "pos": pos + 1}


# --------------------------------------------------------------------------
# full-sequence forward (calibration, evaluation)
# --------------------------------------------------------------------------

def _embed_inputs(params, batch, cfg):
    """(x [B, S, d], positions) of a batch: ``embeds`` [B, S, d] (the vlm
    stub frontend) or ``tokens`` [B, S]; ``positions`` from the batch, else
    0..S-1 a row ([B, S], or [3, B, S] under M-RoPE)."""
    if "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype)
    else:
        x = embed(params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    if "positions" in batch:
        return x, batch["positions"]
    positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.mrope_sections is not None:
        positions = positions.expand(3, B, S)
    return x, positions


def block_forward(lp, x, positions, cfg, q_chunks: int = 1, heads=None):
    """One causal block over a full sequence.  Returns (y, (k, v)); with
    ``heads`` (a ``HeadShard``) the rank attends its own heads, gathers
    the output over heads, and returns its KV heads."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(lp, h, cfg, positions)
    if heads is not None:
        q, k, v = heads.local(q, k, v)
    attn = sdpa(q, k, v, causal=True, window=cfg.window, q_chunks=q_chunks)
    if heads is not None:
        attn = heads.gather(attn)
    x = x + linear(lp["wo"], attn.reshape(*attn.shape[:2], -1))
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp(lp, h, cfg), (k, v)


def _auto_q_chunks(S: int) -> int:
    return max(1, S // 4096) if S > 8192 else 1


def forward(params, batch, cfg, collect_kv: bool = False, heads=None):
    """Full-sequence forward.  Returns (logits [B, S, V], caches): caches
    are the stacked (k, v) [L, B, S, KV, hd] with ``collect_kv``, else
    None.

    With ``cfg.remat``, grad enabled and no ``collect_kv``, each block runs
    under ``torch.utils.checkpoint`` (as the reference wraps it in
    ``jax.checkpoint``): backward keeps only the blocks' inputs and
    recomputes the rest, which changes no number."""
    x, positions = _embed_inputs(params, batch, cfg)
    q_chunks = _auto_q_chunks(x.shape[1])
    remat = cfg.remat and torch.is_grad_enabled() and not collect_kv
    kvs = []
    for lp in params["layers"]:
        if remat:
            x, kv = checkpoint(block_forward, lp, x, positions, cfg,
                               q_chunks, use_reentrant=False,
                               context_fn=pol.checkpoint_contexts)
        else:
            x, kv = block_forward(lp, x, positions, cfg, q_chunks, heads)
        if collect_kv:
            kvs.append(kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = None
    if collect_kv:
        caches = (torch.stack([k for k, _ in kvs]),
                  torch.stack([v for _, v in kvs]))
    return linear(_head(params, cfg), x), caches


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy over labels >= 0, in f32.  Returns
    (loss, aux); aux is empty for the dense family.  A moe model adds
    0.01 x the load-balance loss (``aux["lb_loss"]``), taken on layer 0's
    input embeddings, as the reference takes it."""
    logits, _ = forward(params, batch, cfg)
    labels = batch["labels"]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = pol.global_mean(lse - gold, mask)
    aux = {}
    if cfg.moe is not None:
        x, _ = _embed_inputs(params, batch, cfg)
        aux["lb_loss"] = moe_lib.aux_load_balance_loss(
            params["layers"][0]["moe"], x, cfg)
        loss = loss + 0.01 * aux["lb_loss"]
    return loss, aux


def prefill(params, batch, cfg, heads=None):
    """Run the full prompt; returns (last position's logits [B, V], caches
    {"k", "v": [L, B, S, KV, hd], "pos": S}); with ``heads`` the caches
    hold the rank's KV heads."""
    logits, (k, v) = forward(params, batch, cfg, collect_kv=True,
                             heads=heads)
    caches = {"k": k, "v": v,
              "pos": torch.tensor(k.shape[2], dtype=torch.int32,
                                  device=k.device)}
    return logits[:, -1], caches
