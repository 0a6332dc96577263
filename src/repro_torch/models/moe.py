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
every rank routes alike and reads the same group sizes.

Under an active training policy (``parallel/policy.py``) ``moe_apply``
takes ``_moe_ep``, the reference's GShard-style path: each data shard
routes its own tokens, and a (token, choice) pair's place in its
expert's queue is the running count in flat (token, choice) order; pairs
at or past the capacity ``C = max(8, ceil(T_l k 1.25 / E))`` of the
shard's ``T_l`` tokens are dropped.  The kept pairs fill [E, C, d]
buffers.  When ``E`` and the global token count divide over the data
shards (expert parallelism), one all-to-all sends each shard's buffers
to the experts' owners (shard j owns experts [j E/D, (j+1) E/D)) and one
sends the results back; otherwise every shard runs every expert on its
own buffers.  The products are ``torch.bmm``, as the reference's are
einsums outside any Pallas kernel, and the weights arrive whole
(``parallel/fsdp.py``): the reference's ``psum`` over ``model`` of
hidden-dim partial products has no counterpart.  An owner stacks the
buffers it receives expert by expert ([E/D, D C, d]); the reference
reshapes the [D, E/D, C, d] it receives without that transpose, which
hands expert i's rows from shard j to the wrong expert whenever E/D > 1
(``tests/test_torch_train_mesh.py`` shows it).
``_moe_ep_plain`` is the same function in one process over ``n_fsdp``
virtual shards, with no collective.  Serving never takes either: the
adapters suspend any policy.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

from ..parallel import policy as pol
from ..parallel.tensor_parallel import ColShard, all_to_all
from .layers import activation, dense_init, linear

CAPACITY_FACTOR = 1.25
# a list while ``record_drops`` is active: each EP call appends its data
# shard's dropped (token, choice) pairs, as flat indices t * k + choice
_DROPS: list | None = None


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
        if isinstance(out, FakeTensor):
            return out           # a dry run's shapes: no values to draw
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


def _group_sizes(flat_e: torch.Tensor, E: int) -> list[int]:
    """Rows routed to each expert.  Fake tensors (a dry run,
    ``launch/dryrun.py``) hold no routing: they get the T k pairs split
    evenly, which gives the experts' products the same FLOPs as any
    routing."""
    if isinstance(flat_e, FakeTensor):
        n = flat_e.shape[0]
        return [n // E + (e < n % E) for e in range(E)]
    return torch.bincount(flat_e, minlength=E).tolist()


def _moe_local(p, x2: torch.Tensor, cfg) -> torch.Tensor:
    T, k = x2.shape[0], cfg.moe.top_k
    top_w, top_e = route(p, x2, cfg)
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(T, device=x2.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    tok = flat_t[order]
    # the group sizes on the host: the layer's one synchronisation
    counts = _group_sizes(flat_e, cfg.moe.num_experts)
    ys = _expert_ffn(p, x2[tok], counts, cfg)
    ys = ys * top_w.reshape(-1)[order][:, None].to(ys.dtype)
    return torch.zeros_like(x2).index_add_(0, tok, ys)


def moe_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x [..., d] -> [..., d]: the routed experts (the capacity path under
    an active policy, the exact one otherwise) plus, with
    ``shared_expert``, the always-on expert."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    out = _moe_ep(p, x2, cfg) if pol._current() is not None \
        else _moe_local(p, x2, cfg)
    if cfg.moe.shared_expert:
        hidden = activation(cfg.act, linear(p["ws_gate"], x2)) \
            * linear(p["ws_up"], x2)
        out = out + linear(p["ws_down"], hidden)
    return out.reshape(*lead, d)


# --------------------------------------------------------------------------
# the expert-parallel path (an active training policy)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def record_drops():
    """Collect the dropped (token, choice) pairs of every EP call run
    within: a list of int64 tensors of flat indices ``t * k + choice``
    over the shard's tokens, one per call (a virtual shard's own in
    ``_moe_ep_plain``)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def capacity(T_l: int, cfg) -> int:
    m = cfg.moe
    return max(8, int(math.ceil(T_l * m.top_k * CAPACITY_FACTOR
                                / m.num_experts)))


def _dispatch_local(x2, top_e, E: int, k: int, C: int):
    """The [E, C, d] capacity buffers of tokens ``x2`` [T, d] and the
    combine metadata (flat experts, tokens, queue places, kept)."""
    T = x2.shape[0]
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(T, device=x2.device).repeat_interleave(k)
    onehot = torch.nn.functional.one_hot(flat_e, E)
    pos = torch.cumsum(onehot, 0).gather(1, flat_e[:, None])[:, 0] - 1
    keep = pos < C
    slot = pos.clamp(0, C - 1)
    zero = torch.zeros((), dtype=x2.dtype, device=x2.device)
    rows = torch.where(keep[:, None], x2[flat_t], zero)
    buf = x2.new_zeros((E, C, x2.shape[1])).index_put(
        (flat_e, slot), rows, accumulate=True)
    if _DROPS is not None:
        _DROPS.append((~keep).nonzero()[:, 0].cpu())
    return buf, (flat_e, flat_t, slot, keep)


def _combine_local(y_buf, meta, top_w, T: int):
    flat_e, flat_t, slot, keep = meta
    gathered = y_buf[flat_e, slot]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    w = top_w.reshape(-1)[:, None].to(gathered.dtype)
    out = gathered.new_zeros((T, y_buf.shape[-1]))
    return out.index_add(0, flat_t, gathered * w)


def _expert_ffn_bmm(p, xs, first: int, cfg):
    """Buffers ``xs`` [n, rows, d] through experts first .. first+n-1."""
    n = xs.shape[0]
    gate, up, down = (p[k][first:first + n]
                      for k in ("we_gate", "we_up", "we_down"))
    if cfg.glu:
        h = activation(cfg.act, torch.bmm(xs, gate)) * torch.bmm(xs, up)
    else:
        h = activation(cfg.act, torch.bmm(xs, up))
    return torch.bmm(h, down)


def _moe_ep_body(p, x2, cfg, ep: bool, group=None, n_shards: int = 1,
                 shard: int = 0):
    """One data shard's tokens ``x2`` [T_l, d] through the capacity path:
    route, dispatch, the experts (this shard's E/D after an all-to-all
    over ``group`` when ``ep``, all of them otherwise), combine."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    T_l, d = x2.shape
    top_w, top_e = route(p, x2, cfg)
    C = capacity(T_l, cfg)
    buf, meta = _dispatch_local(x2, top_e, E, k, C)          # [E, C, d]
    if ep and n_shards > 1:
        D, E_l = n_shards, E // n_shards
        recv = all_to_all(buf, group).reshape(D, E_l, C, d)  # [D, E_l, C, d]
        xs = recv.transpose(0, 1).reshape(E_l, D * C, d)     # my experts
        y = _expert_ffn_bmm(p, xs, shard * E_l, cfg)
        back = y.reshape(E_l, D, C, d).transpose(0, 1).reshape(E, C, d)
        y_buf = all_to_all(back, group)
    else:
        y_buf = _expert_ffn_bmm(p, buf, 0, cfg)
    return _combine_local(y_buf, meta, top_w, T_l).to(x2.dtype)


def _moe_ep(p, x2, cfg):
    """The active policy's data shard: ``x2`` [T_l, d] is this rank's rows
    of the global batch (the sharded step splits the batch's rows evenly
    over fsdp, so the reference's test that the global token count
    divides always passes, and EP is ``E % n_fsdp == 0``)."""
    n = pol.n_fsdp()
    if n == 1:
        return _moe_ep_body(p, x2, cfg, True)
    group = pol.fsdp_group()
    return _moe_ep_body(p, x2, cfg, cfg.moe.num_experts % n == 0, group, n,
                        dist.get_rank(group=group))


def _moe_ep_plain(p, x2, cfg, n_fsdp: int):
    """``_moe_ep`` over ``n_fsdp`` data shards in one process: the rows
    split into ``n_fsdp`` contiguous blocks, each dispatched, computed
    and combined with its own capacity.  The all-to-all only moves
    buffers, so this is the same function."""
    return torch.cat([_moe_ep_body(p, xs, cfg, False)
                      for xs in x2.chunk(n_fsdp)])


def aux_load_balance_loss(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: E x the sum over experts
    of the fraction of tokens whose top choice it is times its mean router
    probability, both over the global batch."""
    E = cfg.moe.num_experts
    x2 = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(x2.to(torch.float32) @ p["router"].T, dim=-1)
    top_e = torch.argmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(top_e, E).to(torch.float32)
    if pol.n_fsdp() == 1:
        return E * torch.sum(onehot.mean(0) * probs.mean(0))
    # under a data split both fractions are global means, each reduced
    # over the data shards before their product
    n = x2.shape[0] * pol.n_fsdp()
    frac_tokens = pol.global_sum(onehot.sum(0)) / n
    frac_probs = pol.global_sum(probs.sum(0)) / n
    return E * torch.sum(frac_tokens * frac_probs)
