"""Chunkwise scalar-decay linear attention: the engine shared by mLSTM
(xLSTM) and Mamba2 (SSD) (port of ``repro/models/linear_attn.py``).  Both
are gated outer-product recurrences

    C_t = f_t * C_{t-1} + i_t * k_t v_t^T          (C: [dk, dv] per head)
    y_t = q_t^T C_t   (/ normalizer for mLSTM)

computed in chunk-parallel form: within a chunk every step is a dense
product, and the state is carried across chunks by a Python loop (the
reference's ``lax.scan``).  Gates are scalar per (step, head) with
log_f <= 0, so the intra-chunk factors exp(F_t - F_s) are <= 1.  Every
product runs in f32 whatever the inputs' dtype, as in the reference; the
output is cast back to ``v``'s dtype.  Above the diagonal the reference
takes exp of the gap and masks it afterwards; there the gap grows with
the decay over the chunk and overflows at Mamba2's decays over 128-step
chunks, which leaves the forward right but makes the gradient NaN (0 x
inf).  The port masks the gap before the exponent: the same forward bits,
and a finite gradient.

The reference computes all of this outside any Pallas kernel, so the port
has no kernel here: plain tensor products on either device.
"""
from __future__ import annotations

import torch


def chunked_gla(q, k, v, log_f, log_i=None, *, chunk: int = 64,
                normalizer: bool = False, initial_state=None):
    """q, k [B, S, H, dk]; v [B, S, H, dv]; log_f/log_i [B, S, H] (<= 0).

    Returns (y [B, S, H, dv], final_state) where final_state is (C [B, H,
    dk, dv], n [B, H, dk] or None).  S must be a multiple of
    min(chunk, S), as the reference asserts."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {c}")
    f32, dev = torch.float32, q.device
    log_f = log_f.to(f32)
    log_i = (torch.zeros_like(log_f) if log_i is None else log_i.to(f32))
    if initial_state is None:
        C = torch.zeros((B, H, dk, dv), dtype=f32, device=dev)
        n = torch.zeros((B, H, dk), dtype=f32, device=dev)
    else:
        C, n = initial_state
        if n is None:
            n = torch.zeros((B, H, dk), dtype=f32, device=dev)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    ys = []
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        qf, kf, vf = (t[:, sl].to(f32) for t in (q, k, v))
        fi, ii = log_f[:, sl], log_i[:, sl]
        F = torch.cumsum(fi, dim=1)                      # [B, c, H] inclusive
        Ftot = F[:, -1]                                  # [B, H]
        eF = torch.exp(F)
        # inter-chunk: y_t += exp(F_t) q_t^T C_prev
        y_inter = torch.einsum("bthk,bhkv->bthv", qf * eF[..., None], C)
        # intra-chunk: A[t, s] = exp(F_t - F_s + i_s) for s <= t; the
        # gap is masked to -inf above the diagonal before the exponent,
        # where it may overflow: exp gives exactly the reference's 0 there,
        # and its gradient 0 rather than 0 x inf = NaN
        gap = F[:, :, None, :] - F[:, None, :, :] + ii[:, None, :, :]
        A = torch.exp(gap.masked_fill(~tri[None, :, :, None], -torch.inf))
        scores = torch.einsum("bthk,bshk->btsh", qf, kf) * A
        y = y_inter + torch.einsum("btsh,bshv->bthv", scores, vf)
        # decayed keys of the state and normalizer updates
        kdec = kf * torch.exp(Ftot[:, None] - F + ii)[..., None]
        C_new = C * torch.exp(Ftot)[..., None, None] \
            + torch.einsum("bthk,bthv->bhkv", kdec, vf)
        if normalizer:
            n_t = torch.einsum("bshk,btsh->bthk", kf, A) \
                + n[:, None] * eF[..., None]
            denom = torch.abs(torch.einsum("bthk,bthk->bth", qf, n_t))
            y = y / torch.clamp(denom, min=1.0)[..., None]
            n = n * torch.exp(Ftot)[..., None] + kdec.sum(dim=1)
        C = C_new
        ys.append(y)
    y = torch.cat(ys, dim=1).to(v.dtype)
    return y, (C, n if normalizer else None)


def masked_gates(log_f, log_i, valid):
    """Neutral gates at the padded positions of a right-padded batch
    (``valid`` [B, S] False), so that ``chunked_gla`` leaves the state
    bit-identical to running the real tokens only: log_f becomes exactly
    0.0 (no decay) and log_i -1e30 (exp underflows to exactly 0.0).
    ``log_i=None`` (Mamba's convention, the input gate folded into v) maps
    the padded positions to an explicit -1e30 gate, so callers pass the
    returned log_i on."""
    vm = valid[..., None]                        # [B, S, 1] over heads
    log_f = torch.where(vm, log_f, torch.zeros((), dtype=log_f.dtype,
                                               device=log_f.device))
    base = torch.zeros_like(log_f) if log_i is None else log_i
    log_i = torch.where(vm, base, torch.full((), -1e30, dtype=base.dtype,
                                             device=base.device))
    return log_f, log_i


def gla_decode_step(q, k, v, log_f, log_i, state, normalizer: bool = False):
    """One step of the recurrence: q, k [B, H, dk]; v [B, H, dv]; gates
    [B, H]; state (C, n).  Returns (y [B, H, dv] in v's dtype, (C, n))."""
    C, n = state
    f32 = torch.float32
    f = torch.exp(log_f.to(f32))[..., None, None]
    i = torch.exp((torch.zeros_like(log_f) if log_i is None else log_i)
                  .to(f32))[..., None, None]
    kf = k.to(f32)
    kv = torch.einsum("bhk,bhv->bhkv", kf, v.to(f32))
    C_new = f * C + i * kv
    y = torch.einsum("bhk,bhkv->bhv", q.to(f32), C_new)
    if normalizer:
        n_new = f[..., 0] * n + i[..., 0] * kf
        denom = torch.abs(torch.einsum("bhk,bhk->bh", q.to(f32), n_new))
        y = y / torch.clamp(denom, min=1.0)[..., None]
    else:
        n_new = n
    return y.to(v.dtype), (C_new, n_new)
