"""Whisper-style encoder-decoder backbone (port of
``repro/models/whisper.py``, arXiv:2212.04356).

The audio frontend (log-mel and the stride-2 convolutions) is a stub, as in
the reference: the encoder takes precomputed frame embeddings [B, S_enc, d]
(``embeds``).  The backbone is a bidirectional encoder (``enc_layers``
blocks) and a causal decoder (``n_layers`` blocks) with cross-attention,
with the reference's deviations from upstream Whisper: bias-free linears,
RMSNorm, RoPE in place of learned absolute positions.

Parameters are ``{"embed", "enc", "dec", "enc_norm", "final_norm",
"lm_head"}``, where ``enc`` and ``dec`` are lists of per-layer dicts (the
JAX package stacks them [L, ...]; the port loops over layers in Python).
An encoder layer holds ``attn_norm``, ``mlp_norm``, ``wq``/``wk``/``wv``/
``wo`` and ``w_up``/``w_down``; a decoder layer also ``cross_norm`` and the
cross-attention's ``c_wq``/``c_wk``/``c_wv``/``c_wo``.  Every projection
goes through ``layers.linear``, so ``SparseWeight`` params take the weight
kernels on the card.

Serving (``serving/families.EncDecAdapter``): ``encode_ctx`` runs the
encoder once a request, at its true length, and projects each decoder
layer's cross-attention K/V, the rows an ``EncoderContextPool`` stores;
``unified_step`` then writes the decoder's self-attention KV into the slot
arena at the cursor and attends in place (``transformer.attend_over_pool``,
as the dense family does) and attends over the lane's context rows masked
to their true length (``layers.attend_kv_length``, not causal, so chunked
prefill and fused decode see the same context).  ``prefill`` and
``decode_lockstep`` are the model zoo's lock-step contract.

On a serving mesh (``heads``: the decoder arenas and the context rows hold
the rank's KV heads) the decoder's self-attention and cross-attention run
the rank's heads and gather the output over heads before ``wo``/``c_wo``;
the encoder runs whole on every rank (its projections come back gathered).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..parallel import policy as pol
from . import transformer as tfm
from .layers import (activation, apply_rope, attend_kv_length, dense_init,
                     embed, linear, rms_norm, sdpa)


def _attn_params(cfg, generator, device, prefix="") -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {"wq": (H * hd, d), "wk": (KV * hd, d), "wv": (KV * hd, d),
              "wo": (d, H * hd)}
    return {prefix + k: dense_init(*s, cfg.dtype, generator, device)
            for k, s in shapes.items()}


def init_layer(cfg, generator, device, *, decoder: bool) -> dict:
    """One encoder or decoder block's dense parameters."""
    d = cfg.d_model

    def zeros():
        return torch.zeros((d,), dtype=cfg.dtype, device=device)
    lp = {"attn_norm": zeros(), "mlp_norm": zeros(),
          **_attn_params(cfg, generator, device),
          "w_up": dense_init(cfg.d_ff, d, cfg.dtype, generator, device),
          "w_down": dense_init(d, cfg.d_ff, cfg.dtype, generator, device)}
    if decoder:
        lp["cross_norm"] = zeros()
        lp.update(_attn_params(cfg, generator, device, prefix="c_"))
    return lp


def init_params(cfg, generator: torch.Generator, device="cuda",
                layer_fn=None) -> dict:
    """Random parameters drawn from ``generator`` on ``device``, one layer
    at a time; ``layer_fn(lp)`` transforms each layer as soon as it is
    drawn (the serving CLI sparsifies there)."""
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: the {cfg.family} family has no "
                         f"encoder-decoder stack")
    device = resolve(device)

    def stack(n, decoder):
        out = []
        for _ in range(n):
            lp = init_layer(cfg, generator, device, decoder=decoder)
            out.append(layer_fn(lp) if layer_fn is not None else lp)
        return out
    enc = stack(cfg.enc_layers, False)
    dec = stack(cfg.n_layers, True)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=device, dtype=torch.float32).mul_(0.02)
    zeros = torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device)
    return {"embed": embed.to(cfg.dtype), "enc": enc, "dec": dec,
            "enc_norm": zeros, "final_norm": zeros.clone(),
            "lm_head": dense_init(cfg.vocab, cfg.d_model, cfg.dtype,
                                  generator, device)}


def _attn(lp, prefix, x, kv_x, cfg, causal, positions_q, positions_k,
          q_chunks=1):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(lp[prefix + "wq"], x).reshape(B, S, H, hd)
    k = linear(lp[prefix + "wk"], kv_x).reshape(B, kv_x.shape[1], KV, hd)
    v = linear(lp[prefix + "wv"], kv_x).reshape(B, kv_x.shape[1], KV, hd)
    if positions_q is not None:
        q = apply_rope(q, positions_q, cfg.rope_theta)
        k = apply_rope(k, positions_k, cfg.rope_theta)
    o = sdpa(q, k, v, causal=causal, q_chunks=q_chunks)
    return linear(lp[prefix + "wo"], o.reshape(B, S, -1)), (k, v)


def _mlp(lp, x, cfg):
    m = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + linear(lp["w_down"], activation(cfg.act, linear(lp["w_up"], m)))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _run_layers(block, x, layers, cfg, collect: bool):
    """``x`` through ``block(lp, x) -> (x, aux)`` for every layer (each
    under ``torch.utils.checkpoint`` with ``cfg.remat`` while grad is on
    and nothing is collected); returns (x, the auxes when ``collect``)."""
    remat = cfg.remat and torch.is_grad_enabled() and not collect
    auxes = []
    for lp in layers:
        if remat:
            x, aux = checkpoint(block, lp, x, use_reentrant=False)
        else:
            x, aux = block(lp, x)
        if collect:
            auxes.append(aux)
    return x, auxes


def encode(params, embeds, cfg):
    """The bidirectional encoder over ``embeds`` [B, S, d]; [B, S, d]."""
    x = embeds.to(cfg.dtype)
    B, S, _ = x.shape
    pos = _positions(B, S, x.device)
    qc = tfm._auto_q_chunks(S)

    def block(lp, h):
        hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        a, _ = _attn(lp, "", hn, hn, cfg, causal=False, positions_q=pos,
                     positions_k=pos, q_chunks=qc)
        return _mlp(lp, h + a, cfg), None
    x, _ = _run_layers(block, x, params["enc"], cfg, collect=False)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_full(params, tokens, enc_out, cfg, collect_kv: bool = False):
    """The causal decoder over ``tokens`` [B, S] with cross-attention to
    ``enc_out`` [B, S_enc, d].  Returns (logits [B, S, V], (k, v, ck, cv)
    stacked [L, B, ., KV, hd] with ``collect_kv``, else None)."""
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    pos = _positions(B, S, x.device)
    qc = tfm._auto_q_chunks(S)

    def block(lp, h):
        hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        a, kv = _attn(lp, "", hn, hn, cfg, causal=True, positions_q=pos,
                      positions_k=pos, q_chunks=qc)
        h = h + a
        c, ckv = _attn(lp, "c_", rms_norm(h, lp["cross_norm"], cfg.norm_eps),
                       enc_out, cfg, causal=False, positions_q=None,
                       positions_k=None, q_chunks=qc)
        return _mlp(lp, h + c, cfg), (kv, ckv)
    x, kvs = _run_layers(block, x, params["dec"], cfg, collect=collect_kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    stacked = None
    if collect_kv:
        stacked = tuple(torch.stack([kv[i][j] for kv in kvs])
                        for i in (0, 1) for j in (0, 1))
    return linear(params["lm_head"], x), stacked


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy of the decoder over labels >= 0, in
    f32, given the encoder's ``embeds``.  Returns (loss, {})."""
    enc_out = encode(params, batch["embeds"], cfg)
    logits, _ = decode_full(params, batch["tokens"], enc_out, cfg)
    labels = batch["labels"]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return pol.global_mean(lse - gold, mask), {}


def prefill(params, batch, cfg):
    """Encode ``embeds`` and run the decoder over ``tokens``; returns (last
    position's logits [B, V], {"k", "v": [L, B, S, KV, hd], "ck", "cv":
    [L, B, S_enc, KV, hd], "pos": S})."""
    enc_out = encode(params, batch["embeds"], cfg)
    logits, (k, v, ck, cv) = decode_full(params, batch["tokens"], enc_out,
                                         cfg, collect_kv=True)
    pos = torch.tensor(batch["tokens"].shape[1], dtype=torch.int32,
                       device=k.device)
    return logits[:, -1], {"k": k, "v": v, "ck": ck, "cv": cv, "pos": pos}


def encode_ctx(params, embeds, cfg):
    """The encoder at the TRUE length of ``embeds`` [B, S_enc, d] (no
    padding: every position of a bidirectional encoder attends to every
    other) and each decoder layer's cross-attention K/V of its output:
    (ck, cv) [L, B, S_enc, KV, hd], the rows an ``EncoderContextPool``
    stores a slot."""
    enc_out = encode(params, embeds, cfg)
    B, Se, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    ck = torch.stack([linear(lp["c_wk"], enc_out).reshape(B, Se, KV, hd)
                      for lp in params["dec"]])
    cv = torch.stack([linear(lp["c_wv"], enc_out).reshape(B, Se, KV, hd)
                      for lp in params["dec"]])
    return ck, cv


def unified_step(params, view, batch, cfg, heads=None):
    """One serving step over an ``EncDecPoolView``: each decoder layer
    scatters its fresh self-attention KV into the slot arena at the cursor
    and attends in place, then attends over the lane's encoder context
    (``ctx_len`` masks the rows past its true length).  With ``heads`` (a
    ``HeadShard``) both attentions run the rank's heads over arenas and
    context rows that hold its KV heads.  Returns (logits [B, S, V],
    (k, v)): the view's self-attention arenas, updated in place (the
    context rows are only read)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    positions = tfm._pool_positions(view.cursor, S, cfg)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for i, lp in enumerate(params["dec"]):
        k_l, v_l = view.k[i], view.v[i]
        hn = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = apply_rope(linear(lp["wq"], hn).reshape(B, S, H, hd), positions,
                       cfg.rope_theta)
        k = apply_rope(linear(lp["wk"], hn).reshape(B, S, KV, hd), positions,
                       cfg.rope_theta)
        v = linear(lp["wv"], hn).reshape(B, S, KV, hd)
        if heads is not None:
            q, k, v = heads.local(q, k, v)
        view.write_layer(k_l, v_l, k, v)
        attn = tfm.attend_over_pool(q, dataclasses.replace(view, k=k_l,
                                                           v=v_l))
        if heads is not None:
            attn = heads.gather(attn)
        x = x + linear(lp["wo"], attn.reshape(B, S, -1))
        cn = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
        cq = linear(lp["c_wq"], cn).reshape(B, S, H, hd)
        if heads is not None:
            cq = heads.local_q(cq)
        ckr, cvr = view.lane_ctx(view.ck[i], view.cv[i])
        c = attend_kv_length(cq, ckr, cvr, view.ctx_len)
        if heads is not None:
            c = heads.gather(c)
        x = x + linear(lp["c_wo"], c.reshape(B, S, -1))
        x = _mlp(lp, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return linear(params["lm_head"], x), (view.k, view.v)


def decode_lockstep(params, caches, batch, cfg):
    """One new token for every row through ``unified_step`` (S = 1, an
    identity lane map, every row's context the whole encoder output):
    caches from ``prefill``, grown by ``model_zoo.grow_caches``; writes the
    fresh KV in place and returns (logits [B, V], caches with pos + 1)."""
    from ..serving.state_pool import EncDecPoolView
    tokens = batch["tokens"]
    B = tokens.shape[0]
    pos = caches["pos"]
    Se = caches["ck"].shape[2]
    view = EncDecPoolView.build(
        caches["k"], caches["v"], None, tfm._cursor_vec(pos, B),
        np.ones(B, np.int64), 1, ck=caches["ck"], cv=caches["cv"],
        ctx_len=np.full(B, Se, np.int64))
    logits, (k, v) = unified_step(params, view, {"tokens": tokens}, cfg)
    return logits[:, -1], dict(caches, k=k, v=v, pos=pos + 1)
