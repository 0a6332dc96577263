"""xLSTM (Beck et al., 2024, arXiv:2405.04517): mLSTM and sLSTM blocks (port
of ``repro/models/xlstm.py``).

xlstm-350m: 24 blocks, d_model 1024, 4 heads, mostly mLSTM with an sLSTM
block at every ``cfg.slstm_every``-th layer.

mLSTM block (pre-norm, projection factor 2): x up-projects to 2 di, split
into the cell input and the output gate branch; q, k, v projections at di;
scalar i/f gates per head from the cell input; the chunkwise matrix-memory
recurrence (``linear_attn.chunked_gla``, normalizer on); y = cell out *
silu(gate branch), down-projected back to d, plus the residual.

sLSTM block: a scalar-memory recurrence with per-head recurrent mixing,
strictly sequential: a Python loop over time (the reference's
``lax.scan``), since sLSTM's recurrence has no parallel form.

Parameters are ``{"embed", "layers", "final_norm", "lm_head"}`` where
``layers`` is a list of per-layer dicts, each holding every kind's weights
as the reference's stacked tree does (an mLSTM layer carries unused
``r_gates``/``w_slstm``, an sLSTM layer unused ``w_q``/``w_k``/``w_v``/
``w_gates``).  Serving state per layer: mLSTM (C [B, H, dk, dv], n
[B, H, dk]); sLSTM (c, n, h, m), each [B, H, dh], m starting at -1e30.

On a serving mesh a layer's ``StateShard`` (``ServingPlacement.
state_shard``) says which block of its state the rank holds: its heads
(the rank runs the recurrence on its heads of q, k, v and the gates, or
of ``zifo`` and ``r_gates``), or (mLSTM) its columns of ``v`` with the
normalizer whole on every rank; the output is gathered whole before
``silu(xg)`` and ``w_down``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..parallel import policy as pol
from .layers import dense_init, embed, linear, rms_norm
from .linear_attn import chunked_gla, masked_gates

NEG = -1e30


def _di(cfg) -> int:
    return 2 * cfg.d_model


def _dims(cfg):
    di = _di(cfg)
    return di, cfg.n_heads, di // cfg.n_heads


def init_layer(cfg, generator: torch.Generator, device) -> dict:
    """One layer's parameters (every kind's, as the reference holds them)."""
    d = cfg.d_model
    di, H, dh = _dims(cfg)

    def dense(out_dim, in_dim):
        return dense_init(out_dim, in_dim, cfg.dtype, generator, device)

    r = torch.randn((4, H, dh, dh), generator=generator, device=device,
                    dtype=torch.float32).div_(math.sqrt(dh))
    return {"norm": torch.zeros((d,), dtype=cfg.dtype, device=device),
            "w_up": dense(2 * di, d), "w_q": dense(di, di),
            "w_k": dense(di, di), "w_v": dense(di, di),
            "w_gates": dense(2 * H, di), "w_down": dense(d, di),
            "r_gates": r.to(cfg.dtype), "w_slstm": dense(4 * di, di)}


def init_params(cfg, generator: torch.Generator, device="cuda",
                layer_fn=None) -> dict:
    """Random parameters drawn from ``generator`` on ``device``, one layer
    at a time; ``layer_fn(lp)`` transforms each layer as it is drawn (the
    serving CLI sparsifies there)."""
    device = resolve(device)
    layers = []
    for _ in range(cfg.n_layers):
        lp = init_layer(cfg, generator, device)
        layers.append(layer_fn(lp) if layer_fn is not None else lp)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=device, dtype=torch.float32).mul_(0.02)
    return {"embed": embed.to(cfg.dtype), "layers": layers,
            "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                      device=device),
            "lm_head": dense_init(cfg.vocab, cfg.d_model, cfg.dtype,
                                   generator, device)}


def _is_slstm(cfg, i: int) -> bool:
    k = cfg.slstm_every
    return k > 0 and (i % k) == (k - 1)


def _up(lp, x, cfg):
    """Pre-norm and up-projection: (cell input, gate branch), [B, S, di]
    each."""
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    return torch.chunk(linear(lp["w_up"], h), 2, dim=-1)


# ---------------------------------------------------------------- mLSTM ----

def _mlstm_qkvgates(lp, xc, cfg):
    di = xc.shape[-1]
    H = cfg.n_heads
    dh = di // H
    B, S = xc.shape[:2]
    # sqrt(dh) rounded to the activations' dtype first, as the reference
    root = float(torch.tensor(math.sqrt(dh)).to(xc.dtype))
    q = linear(lp["w_q"], xc).reshape(B, S, H, dh) / root
    k = linear(lp["w_k"], xc).reshape(B, S, H, dh) / root
    v = linear(lp["w_v"], xc).reshape(B, S, H, dh)
    gates = linear(lp["w_gates"], xc).to(torch.float32)          # [B,S,2H]
    log_i = F.logsigmoid(gates[..., :H])
    log_f = F.logsigmoid(gates[..., H:])
    return q, k, v, log_f, log_i


def mlstm_block(lp, x, cfg, state=None, chunk: int = 64, valid=None,
                shard=None):
    """Full-sequence mLSTM block; returns (y, new_state).  ``valid`` [B, S]
    marks the real tokens of a right-padded batch: padded positions get
    neutral gates, so the carried state is bit-identical to running the
    real prefix alone.  With a ``shard`` (a mesh rank's ``StateShard``)
    ``state`` is the rank's block and so is the returned state: the rank
    runs its heads (heads mode) or its columns of ``v`` (dv mode; the
    normalizer reads only q, k and the gates, so every column it divides
    is exact) and gathers ``y`` whole."""
    B, S, _ = x.shape
    xc, xg = _up(lp, x, cfg)
    q, k, v, log_f, log_i = _mlstm_qkvgates(lp, xc, cfg)
    if valid is not None:
        log_f, log_i = masked_gates(log_f, log_i, valid)
    if shard is not None:
        q, k, v, log_f, log_i = (shard.heads(t) for t in
                                 (q, k, v, log_f, log_i))
        v = shard.cols(v)
    y, new_state = chunked_gla(q, k, v, log_f, log_i, chunk=chunk,
                               normalizer=True, initial_state=state)
    if shard is not None:
        y = shard.gather(y)
    y = y.reshape(B, S, -1) * F.silu(xg)
    return x + linear(lp["w_down"], y), new_state


# ---------------------------------------------------------------- sLSTM ----

def _slstm_step(r_gates, carry, zifo_t):
    """carry: (c, n, h, m) each [B, H, dh]; zifo_t [B, 4, H, dh]
    pre-activations; ``r_gates`` [4, H, dh, dh] the per-head recurrent
    mixing.  Returns (new carry, h)."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,ghde->bghe", h, r_gates.to(torch.float32))
    z_t, i_t, f_t, o_t = [zifo_t[:, g].to(torch.float32) + rec[:, g]
                          for g in range(4)]
    # stabilized exponential gating (xLSTM eq. 15-17)
    log_f = F.logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_t)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_init(B, H, dh, device):
    """(c, n, h, m) for ``B`` fresh lanes: three separate zero tensors and
    the -1e30 stabilizer."""
    return tuple(torch.zeros((B, H, dh), dtype=torch.float32, device=device)
                 for _ in range(3)) + (
        torch.full((B, H, dh), NEG, dtype=torch.float32, device=device),)


def slstm_block(lp, x, cfg, state=None, valid=None, shard=None):
    """Full-sequence sLSTM block, a step per position; returns (y, carry).
    With ``valid`` the step still runs at a padded position, and each lane
    whose position is not real gets its carry back unchanged (a select,
    bit for bit).  With a heads-mode ``shard`` the rank steps its heads of
    ``zifo`` with its heads of ``r_gates`` on its carries and gathers the
    outputs over heads."""
    B, S, _ = x.shape
    di, H, dh = _dims(cfg)
    xc, xg = _up(lp, x, cfg)
    zifo = linear(lp["w_slstm"], xc).reshape(B, S, 4, H, dh)
    r_gates = lp["r_gates"]
    if shard is not None:
        zifo, r_gates = shard.heads(zifo, 3), shard.heads(r_gates, 1)
        H = shard.n_heads(H)
    carry = _slstm_init(B, H, dh, x.device) if state is None else tuple(state)
    hs = []
    for t in range(S):
        new_carry, h = _slstm_step(r_gates, carry, zifo[:, t])
        if valid is not None:
            vm = valid[:, t][:, None, None]
            new_carry = tuple(torch.where(vm, nc, oc)
                              for nc, oc in zip(new_carry, carry))
        carry = new_carry
        hs.append(h)
    y = torch.stack(hs, dim=1)
    if shard is not None:
        y = shard.gather(y)
    y = y.reshape(B, S, di).to(x.dtype) * F.silu(xg)
    return x + linear(lp["w_down"], y), carry


# ------------------------------------------------------------ full model ---

def _block(cfg, i):
    return slstm_block if _is_slstm(cfg, i) else mlstm_block


def forward(params, batch, cfg, states=None, return_states: bool = False):
    """Full-sequence forward; returns (logits [B, S, V], per-layer states
    or None).  With ``cfg.remat`` and grad enabled each block runs under
    ``torch.utils.checkpoint``, as the reference wraps it in
    ``jax.checkpoint``."""
    x = embed(params["embed"], batch["tokens"])
    remat = cfg.remat and torch.is_grad_enabled()
    new_states = []
    for i, lp in enumerate(params["layers"]):
        st = states[i] if states is not None else None
        fn = _block(cfg, i)
        if remat:
            x, s = checkpoint(fn, lp, x, cfg, st, use_reentrant=False)
        else:
            x, s = fn(lp, x, cfg, state=st)
        new_states.append(s)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = linear(params["lm_head"], x)
    return (logits, new_states) if return_states else (logits, None)


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy over labels >= 0, in f32; (loss, {})."""
    logits, _ = forward(params, batch, cfg)
    labels = batch["labels"]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return pol.global_mean(lse - gold, mask), {}


def lane_init(cfg, i: int, batch_size: int, device="cuda", shard=None):
    """Layer ``i``'s fresh state for ``batch_size`` lanes: the per-layer
    unit of ``init_state``, which ``unified_step`` selects for fresh
    lanes (``RecurrentStateView.select_fresh``); with a ``shard``, the
    rank's block of it."""
    di, H, dh = _dims(cfg)
    dv = dh
    if shard is not None:
        H, dv = shard.n_heads(H), shard.n_cols(dh)
    if _is_slstm(cfg, i):
        return _slstm_init(batch_size, H, dh, device)
    return (torch.zeros((batch_size, H, dh, dv), dtype=torch.float32,
                        device=device),
            torch.zeros((batch_size, H, dh), dtype=torch.float32,
                        device=device))


def init_state(cfg, batch_size: int, device="cuda") -> list:
    """Every layer's fresh state for ``batch_size`` lanes."""
    device = resolve(device)
    return [lane_init(cfg, i, batch_size, device)
            for i in range(cfg.n_layers)]


def prefill(params, batch, cfg):
    """Run the full prompt; returns (last position's logits [B, V],
    {"states", "pos": S})."""
    logits, states = forward(params, batch, cfg, return_states=True)
    S = batch["tokens"].shape[1]
    return logits[:, -1], {"states": states,
                           "pos": torch.tensor(S, dtype=torch.int32,
                                               device=logits.device)}


def unified_step(params, view, batch, cfg):
    """One serving step over a ``RecurrentStateView``, the xLSTM analogue
    of ``transformer.unified_step``.

    ``batch["tokens"]`` [B, S] holds each lane's next tokens right-padded
    to S; ``view.n_new`` masks the padding (neutral gates, carry selects),
    so a lane's state after the step is bit-identical to running its real
    tokens alone.  Lanes at cursor 0 take their family init state inside
    the step; lanes with n_new 0 leave their slot's state untouched.  On a
    mesh the view's arenas are the rank's blocks and ``view.shard(i)``
    says how layer ``i`` splits.  Returns (logits [B, S, V], the new state
    arenas) for the pool to adopt."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    valid = torch.arange(S, device=x.device)[None] < view.n_new[:, None]
    new_arenas = []
    for i, lp in enumerate(params["layers"]):
        shard = view.shard(i)
        lane_st = view.gather_layer(i)
        st = view.select_fresh(lane_st,
                               lane_init(cfg, i, B, x.device, shard))
        x, s = _block(cfg, i)(lp, x, cfg, state=st, valid=valid,
                              shard=shard)
        new_arenas.append(view.scatter_layer(i,
                                             view.keep_inactive(s, lane_st)))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return linear(params["lm_head"], x), new_arenas


def decode_lockstep(params, caches, batch, cfg):
    """One new token for every row through ``unified_step`` (S = 1 over the
    whole batch as one state view), so its float operation order is the
    engine's fused decode's.  Returns (logits [B, V], {"states", "pos":
    pos + 1})."""
    from ..serving.state_pool import RecurrentStateView
    from .transformer import _cursor_vec
    tokens = batch["tokens"]
    B = tokens.shape[0]
    view = RecurrentStateView.build(caches["states"], None,
                                    _cursor_vec(caches["pos"], B), [1] * B)
    logits, new_states = unified_step(params, view, batch, cfg)
    return logits[:, -1], {"states": new_states, "pos": caches["pos"] + 1}
