"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``'s local path).

``moe_apply`` is the reference's exact, capacity-free path (``_moe_local``):
the router's logits in f32, softmax, top-k, the chosen weights renormalised
to sum to 1; the (token, choice) pairs sorted by expert (a stable sort), each
expert's rows through its ``we_gate``/``we_up``/``we_down`` slice with
``torch.matmul``, each result scaled by its routing weight (cast to the
output's dtype first, as the reference casts it) and added back at its
token.  No token is dropped.  The reference computes the grouped products
with ``jax.lax.ragged_dot`` outside any Pallas kernel; here they are one
product per expert that received rows, which needs the group sizes on the
host: one synchronisation a MoE layer.  Only the experts a call routes to
are read, and no [T x k, d, ff] gather of expert weights is ever formed.

A shared (always-on) expert (llama4) goes through ``layers.linear``, so
its ``ws_*`` ``SparseWeight``s take the weight kernels on the card.  The
routed experts are [E, in, out] tensors, as the reference lays them out
for its grouped products, and stay dense: ``sparsify_for_serving`` keeps
3-D leaves as they are.

On a serving mesh the expert stacks are ``ColShard``s, split on their
last dim as the reference's serving placement splits them: a rank holds
``we_gate``/``we_up`` [E, d, F / m] and ``we_down`` [E, F, d / m].  It
computes its F columns of every routed row, gathers the whole [N, F]
hidden rows once, computes its d columns of every row's down product and
gathers the whole [N, d] once: two collectives a MoE layer whatever the
routing, and every output element the same full-length product the
single-device path computes.  The router stays whole on every rank, so
every rank routes alike and reads the same group sizes.  The reference's
expert-parallel path under a mesh (``_moe_ep``: capacity dispatch and
all-to-all) is ROADMAP A12c's; serving never takes it.
"""
from __future__ import annotations

import math

import torch

from ..parallel.tensor_parallel import ColShard
from .layers import activation, dense_init, linear


def init_moe(cfg, generator: torch.Generator, device) -> dict:
    """One layer's MoE parameters: the f32 ``router`` [E, d], the routed
    experts ``we_gate``/``we_up`` [E, d, ff] and ``we_down`` [E, ff, d] in
    ``cfg.dtype``, N(0, 1/in), and with ``shared_expert`` the [out, in]
    ``ws_gate``/``ws_up``/``ws_down``.  Each expert's matrix is drawn in
    f32 and rounded on its own, so the f32 temporaries stay one expert's
    (a llama4-maverick layer's 128 experts are 32 GB in bf16)."""
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.num_experts

    def experts(n_in, n_out):
        out = torch.empty((E, n_in, n_out), dtype=cfg.dtype, device=device)
        for e in range(E):
            w = torch.randn((n_in, n_out), generator=generator,
                            device=device, dtype=torch.float32)
            out[e] = w.div_(math.sqrt(n_in))
        return out

    p = {"router": dense_init(E, d, torch.float32, generator, device),
         "we_gate": experts(d, ff), "we_up": experts(d, ff),
         "we_down": experts(ff, d)}
    if m.shared_expert:
        p["ws_gate"] = dense_init(ff, d, cfg.dtype, generator, device)
        p["ws_up"] = dense_init(ff, d, cfg.dtype, generator, device)
        p["ws_down"] = dense_init(d, ff, cfg.dtype, generator, device)
    return p


def route(p, x2: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights [T, k] f32, experts [T, k]) of tokens ``x2`` [T, d]: the
    f32 router's softmax, its top k, renormalised."""
    probs = torch.softmax(x2.to(torch.float32) @ p["router"].T, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return top_w / top_w.sum(-1, keepdim=True), top_e


def _cols(w):
    """(an expert stack, or a mesh rank's columns of it; its axis or None
    when the stack is whole)."""
    return (w.local, w.axis) if isinstance(w, ColShard) else (w, None)


def _expert_ffn(p, xs: torch.Tensor, counts: list[int], cfg) -> torch.Tensor:
    """Rows ``xs`` [N, d], sorted by expert with ``counts[e]`` rows of
    expert e, each through its expert's FFN; [N, d].  On a mesh rank
    (``ColShard`` stacks) the rank's F columns of each row's hidden are
    gathered whole once, and its d columns of each row's down product
    once: the gathers sit outside the loops over experts, so the layer's
    collectives do not depend on ``counts``."""
    (gate, _), (up, up_axis), (down, down_axis) = (
        _cols(p[k]) for k in ("we_gate", "we_up", "we_down"))
    h = xs.new_empty((xs.shape[0], up.shape[-1]))
    start = 0
    for e, n in enumerate(counts):
        if n:
            x_e = xs[start:start + n]
            if cfg.glu:
                h[start:start + n] = activation(
                    cfg.act, torch.matmul(x_e, gate[e])) \
                    * torch.matmul(x_e, up[e])
            else:
                h[start:start + n] = activation(cfg.act,
                                                torch.matmul(x_e, up[e]))
        start += n
    if up_axis is not None:
        h = up_axis.gather(h, dim=-1)
    out = xs.new_empty((xs.shape[0], down.shape[-1]))
    start = 0
    for e, n in enumerate(counts):
        if n:
            out[start:start + n] = torch.matmul(h[start:start + n], down[e])
        start += n
    return out if down_axis is None else down_axis.gather(out, dim=-1)


def _moe_local(p, x2: torch.Tensor, cfg) -> torch.Tensor:
    T, k = x2.shape[0], cfg.moe.top_k
    top_w, top_e = route(p, x2, cfg)
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(T, device=x2.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    tok = flat_t[order]
    # the group sizes on the host: the layer's one synchronisation
    counts = torch.bincount(flat_e, minlength=cfg.moe.num_experts).tolist()
    ys = _expert_ffn(p, x2[tok], counts, cfg)
    ys = ys * top_w.reshape(-1)[order][:, None].to(ys.dtype)
    return torch.zeros_like(x2).index_add_(0, tok, ys)


def moe_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x [..., d] -> [..., d]: the routed experts plus, with
    ``shared_expert``, the always-on expert."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    out = _moe_local(p, x2, cfg)
    if cfg.moe.shared_expert:
        hidden = activation(cfg.act, linear(p["ws_gate"], x2)) \
            * linear(p["ws_up"], x2)
        out = out + linear(p["ws_down"], hidden)
    return out.reshape(*lead, d)


def aux_load_balance_loss(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: E x the sum over experts
    of the fraction of tokens whose top choice it is times its mean router
    probability."""
    E = cfg.moe.num_experts
    x2 = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(x2.to(torch.float32) @ p["router"].T, dim=-1)
    top_e = torch.argmax(probs, dim=-1)
    frac_tokens = torch.nn.functional.one_hot(top_e, E).to(
        torch.float32).mean(0)
    return E * torch.sum(frac_tokens * probs.mean(0))
