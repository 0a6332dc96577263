"""Mamba2 (SSD) blocks and the Zamba2 hybrid (arXiv:2411.15242) (port of
``repro/models/zamba.py``).

Mamba2 block (Dao & Gu 2024, simplified as in the reference: no causal
conv): x -> in_proj -> (z [di], xc [di], B [N], C [N], dt [H]) with
di = 2 d, H = di / ssm_head_dim heads and N = ssm_state; the scalar-decay
recurrence per head h' = exp(dt A) h + dt B x runs on the shared chunkwise
engine (``linear_attn.chunked_gla``) with q = C, k = B (broadcast over
heads), v = dt x, log_f = dt A; y = (ssd out + D xc) * silu(z), out_proj,
residual.

Zamba2: ``cfg.n_layers`` Mamba2 blocks and ONE shared transformer block
(attention + MLP, one set of weights: the port's ``transformer`` layer)
applied after every ``cfg.attn_every``-th Mamba2 block, each application
with its own KV.

Parameters: ``{"embed", "mamba", "final_norm", "lm_head",
"shared_attn"}``; ``mamba`` is a list of per-layer dicts (``norm``,
``in_proj``, ``out_proj``, and ``A_log``/``D``/``dt_bias`` in f32),
``shared_attn`` one unstacked transformer layer.  Serving state per mamba
layer: (S [B, H, N, P] f32, None).

On a serving mesh a mamba layer's ``StateShard`` says which block of S
the rank holds: its heads (the rank runs its heads of ``v``, ``log_f``,
``xh`` and ``D``) or its P columns (every head, its columns of ``v`` and
``xh``); ``y`` is gathered whole before ``silu(z)`` and ``out_proj``.
The shared block attends over the rank's KV heads (``heads``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..parallel import policy as pol
from . import transformer as tfm
from .layers import dense_init, embed, linear, rms_norm
from .linear_attn import chunked_gla, masked_gates


def _dims(cfg):
    di = 2 * cfg.d_model
    return di, di // cfg.ssm_head_dim, cfg.ssm_state


def _shared_block_cfg(cfg):
    return dataclasses.replace(cfg, n_layers=1, moe=None, family="dense")


def n_applications(cfg) -> int:
    """How many times the shared block runs in a forward."""
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _is_application(cfg, i: int) -> bool:
    return bool(cfg.attn_every) and (i % cfg.attn_every) == \
        (cfg.attn_every - 1)


def init_mamba_layer(cfg, generator: torch.Generator, device) -> dict:
    d = cfg.d_model
    di, H, N = _dims(cfg)
    f32 = torch.float32
    return {"norm": torch.zeros((d,), dtype=cfg.dtype, device=device),
            "in_proj": dense_init(2 * di + 2 * N + H, d, cfg.dtype,
                                       generator, device),
            "out_proj": dense_init(d, di, cfg.dtype, generator, device),
            "A_log": torch.zeros((H,), dtype=f32, device=device),
            "D": torch.ones((H,), dtype=f32, device=device),
            "dt_bias": torch.zeros((H,), dtype=f32, device=device)}


def init_params(cfg, generator: torch.Generator, device="cuda",
                layer_fn=None) -> dict:
    """Random parameters drawn from ``generator`` on ``device``, one layer
    at a time; ``layer_fn(lp)`` transforms each mamba layer and the shared
    block as they are drawn (the serving CLI sparsifies there)."""
    device = resolve(device)

    def done(lp):
        return layer_fn(lp) if layer_fn is not None else lp
    mamba = [done(init_mamba_layer(cfg, generator, device))
             for _ in range(cfg.n_layers)]
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=device, dtype=torch.float32).mul_(0.02)
    params = {"embed": embed.to(cfg.dtype), "mamba": mamba,
              "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                        device=device),
              "lm_head": dense_init(cfg.vocab, cfg.d_model, cfg.dtype,
                                         generator, device)}
    if cfg.attn_every:
        params["shared_attn"] = done(tfm.init_layer(_shared_block_cfg(cfg),
                                                    generator, device))
    return params


def _ssm_inputs(lp, x, cfg):
    """x [B, S, d] -> z, q (C), k (B), v (dt xc), log_f, xc by heads."""
    di, H, N = _dims(cfg)
    B_, S = x.shape[:2]
    proj = linear(lp["in_proj"], x)
    z, xc, Bv, Cv, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    dt = dt.to(torch.float32) + lp["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))             # softplus
    A = -torch.exp(lp["A_log"])                                   # [H]
    log_f = dt * A[None, None]                                    # <= 0
    xh = xc.reshape(B_, S, H, cfg.ssm_head_dim)
    v = xh * dt[..., None].to(xh.dtype)
    q = Cv[:, :, None].expand(B_, S, H, N)
    k = Bv[:, :, None].expand(B_, S, H, N)
    return z, q, k, v, log_f, xh


def mamba_block(lp, x, cfg, state=None, chunk: int = 128, valid=None,
                shard=None):
    """Full-sequence Mamba2 block; returns (y, (S, None)).  ``valid`` masks
    a right-padded batch's padding with neutral gates.  With a ``shard``
    (a mesh rank's ``StateShard``) ``state`` and the returned state are
    the rank's block: its heads, or its P columns, of the recurrence and
    of the D skip; ``y`` is gathered whole."""
    B_, S, _ = x.shape
    di = _dims(cfg)[0]
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    z, q, k, v, log_f, xh = _ssm_inputs(lp, h, cfg)
    log_i = None
    if valid is not None:
        log_f, log_i = masked_gates(log_f, log_i, valid)
    D = lp["D"]
    if shard is not None:
        q, k, v, log_f, xh = (shard.heads(t) for t in
                              (q, k, v, log_f, xh))
        log_i = None if log_i is None else shard.heads(log_i)
        v, xh, D = shard.cols(v), shard.cols(xh), shard.heads(D, 0)
    y, new_state = chunked_gla(q, k, v, log_f, log_i, chunk=chunk,
                               normalizer=False, initial_state=state)
    y = y + xh * D[None, None, :, None].to(y.dtype)
    if shard is not None:
        y = shard.gather(y)
    y = y.reshape(B_, S, di) * F.silu(z)
    return x + linear(lp["out_proj"], y), new_state


# ------------------------------------------------------------ full model ---

def forward(params, batch, cfg, states=None, return_states: bool = False):
    """Full-sequence forward; returns (logits, (states, per-application
    (k, v))) with ``return_states``, else (logits, None).  With
    ``cfg.remat`` and grad enabled each block runs under
    ``torch.utils.checkpoint``."""
    tokens = batch["tokens"]
    B_, S = tokens.shape
    x = embed(params["embed"], tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    scfg = _shared_block_cfg(cfg)
    q_chunks = tfm._auto_q_chunks(S)
    pos = torch.arange(S, device=x.device).expand(B_, S)
    new_states, kvs = [], []
    for i, lp in enumerate(params["mamba"]):
        st = states[i] if states is not None else None
        if remat:
            x, s = checkpoint(mamba_block, lp, x, cfg, st,
                              use_reentrant=False)
        else:
            x, s = mamba_block(lp, x, cfg, state=st)
        new_states.append(s)
        if _is_application(cfg, i):
            if remat:
                x, kv = checkpoint(tfm.block_forward, params["shared_attn"],
                                   x, pos, scfg, q_chunks,
                                   use_reentrant=False)
            else:
                x, kv = tfm.block_forward(params["shared_attn"], x, pos,
                                          scfg, q_chunks)
            kvs.append(kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = linear(params["lm_head"], x)
    if return_states:
        return logits, (new_states, kvs)
    return logits, None


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy over labels >= 0, in f32; (loss, {})."""
    logits, _ = forward(params, batch, cfg)
    labels = batch["labels"]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return pol.global_mean(lse - gold, mask), {}


def prefill(params, batch, cfg, max_len: int | None = None):
    """Run the full prompt; returns (last position's logits [B, V], caches
    {"states", "kv": per-application (k, v) [B, max_len, KV, hd] padded
    with zeros, "pos": S})."""
    S = batch["tokens"].shape[1]
    max_len = max_len or S
    logits, (states, kvs) = forward(params, batch, cfg, return_states=True)
    kvs = [tuple(F.pad(t, (0, 0, 0, 0, 0, max_len - t.shape[1]))
                 for t in kv) for kv in kvs]
    return logits[:, -1], {"states": states, "kv": kvs,
                           "pos": torch.tensor(S, dtype=torch.int32,
                                               device=logits.device)}


def lane_init(cfg, i: int, batch_size: int, device="cuda", shard=None):
    """Layer ``i``'s fresh SSM state for ``batch_size`` lanes; with a
    ``shard``, the rank's block of it."""
    di, H, N = _dims(cfg)
    P = cfg.ssm_head_dim
    if shard is not None:
        H, P = shard.n_heads(H), shard.n_cols(P)
    return (torch.zeros((batch_size, H, N, P), dtype=torch.float32,
                        device=device), None)


def init_cache(cfg, batch_size: int, max_len: int, device="cuda") -> dict:
    """Zeroed lock-step caches: every layer's state, every application's
    (k, v) [B, max_len, KV, hd] and the filled length ``pos``."""
    device = resolve(device)
    shape = (batch_size, max_len, cfg.n_kv_heads, cfg.hd)
    return {"states": [lane_init(cfg, i, batch_size, device)
                       for i in range(cfg.n_layers)],
            "kv": [(torch.zeros(shape, dtype=cfg.dtype, device=device),
                    torch.zeros(shape, dtype=cfg.dtype, device=device))
                   for _ in range(n_applications(cfg))],
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def unified_step(params, view, batch, cfg, heads=None):
    """One serving step over a ``HybridPoolView``: the mamba layers on the
    recurrent-state view (``view.state``: gate masking, fresh-state select),
    the shared-attention applications on the KV view (``view.kv``, slot or
    paged) through the transformer's in-place block; the two views carry
    their own ``n_new``.  On a mesh the state view's arenas are the rank's
    blocks (``view.state.shard(i)``) and ``heads`` the shared block's
    head split when its KV arenas hold the rank's heads.  Returns (logits
    [B, S, V], (k, v) arenas or None, the new state arenas)."""
    tokens = batch["tokens"]
    B_, S = tokens.shape
    x = embed(params["embed"], tokens)
    sview, kview = view.state, view.kv
    valid = torch.arange(S, device=x.device)[None] < sview.n_new[:, None]
    scfg = _shared_block_cfg(cfg)
    positions = tfm._pool_positions(kview.cursor, S, scfg) \
        if cfg.attn_every else None
    new_states = []
    ai = 0
    for i, lp in enumerate(params["mamba"]):
        shard = sview.shard(i)
        lane_st = sview.gather_layer(i)
        st = sview.select_fresh(lane_st,
                                lane_init(cfg, i, B_, x.device, shard))
        x, s = mamba_block(lp, x, cfg, state=st, valid=valid, shard=shard)
        new_states.append(sview.scatter_layer(
            i, sview.keep_inactive(s, lane_st)))
        if _is_application(cfg, i):
            x = tfm._block_step(params["shared_attn"], x, kview.k[ai],
                                kview.v[ai], kview, positions, scfg,
                                heads=heads)
            ai += 1
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    kv = (kview.k, kview.v) if ai else None
    return linear(params["lm_head"], x), kv, new_states


def decode_lockstep(params, caches, batch, cfg):
    """One new token for every row through ``unified_step`` (S = 1, an
    identity lane map), in the engine's fused decode's float operation
    order.  Returns (logits [B, V], {"states", "kv", "pos": pos + 1})."""
    from ..serving.cache_pool import SlotPoolView
    from ..serving.state_pool import HybridPoolView, RecurrentStateView
    tokens = batch["tokens"]
    B_ = tokens.shape[0]
    pos = caches["pos"]
    cursor = tfm._cursor_vec(pos, B_)
    ones = np.ones(B_, np.int64)
    sview = RecurrentStateView.build(caches["states"], None, cursor, ones)
    kvs = caches["kv"]
    k = torch.stack([kv[0] for kv in kvs]) if kvs else None
    v = torch.stack([kv[1] for kv in kvs]) if kvs else None
    kview = SlotPoolView.build(k, v, None, cursor, ones, 1) if kvs else None
    logits, kv, states = unified_step(params, HybridPoolView(kview, sview),
                                      batch, cfg)
    new_kvs = [(kv[0][i], kv[1][i]) for i in range(len(kvs))] if kvs else []
    return logits[:, -1], {"states": states, "kv": new_kvs, "pos": pos + 1}
