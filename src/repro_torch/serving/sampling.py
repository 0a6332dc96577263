"""Per-slot token sampling and draft verification (port of
``repro/serving/sampling.py``: ``sample_tokens_logprobs`` and
``verify_draft``).

Greedy rows (temperature <= 0) take the argmax, first index on ties as
``jnp.argmax`` does, so greedy streams match the JAX engine exactly.
Stochastic rows apply temperature and an optional top-k restriction and
draw from a ``torch.Generator`` seeded from the request's (seed, token
index), so a request's stream depends on nothing else in the batch.  The
JAX package derives its keys with threefry ``fold_in``, which torch cannot
reproduce: stochastic rows agree with it in distribution, not in draws.

``verify_draft`` is speculative decoding's acceptance rule over a verify
step's logits (``serving/speculative.py``), leave-one-in rejection
sampling.  Position j of a row checks draft token d_j against the target
distribution p_j (temperature and top-k adjusted, what sampling draws
from):

  greedy rows      accept while argmax(p_j) == d_j; the emitted token at
                   every position is the argmax, so the accepted prefix
                   plus the first correction is token-identical to
                   sequential greedy decode;
  stochastic rows  accept d_j when u < p_j(d_j), u ~ U[0, 1); a rejected
                   position resamples from p_j without d_j (renormalized),
                   which preserves the target distribution for any
                   deterministic proposer.

The position after the last draft (the bonus position) samples from the
full target distribution, so every verify step emits at least one token.
Position j's draws are counter-based, as the reference's threefry keys
are: uniforms hashed (splitmix64) from (seed, step0 + j, stream), stream 0
for the acceptance draw and stream 1 for the resample or bonus draw (by
inverse CDF), as the reference's ``fold_in(k, 0)`` and ``fold_in(k, 1)``.
So a row's draws depend on nothing else in the batch, and the whole batch
is verified in one pass of tensor ops.
"""
from __future__ import annotations

import numpy as np
import torch


def _restricted_logits(logits: torch.Tensor, temperature: float,
                       top_k: int) -> torch.Tensor:
    """Temperature + top-k adjusted logits of one row's positions
    ([..., V] f32)."""
    lf = logits.to(torch.float32) / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(lf, min(top_k, lf.shape[-1])).values[..., -1:]
        lf = torch.where(lf < kth, torch.full((), -torch.inf,
                                              device=lf.device), lf)
    return lf


def row_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one draw: a function of (seed, token index) only."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) & 0xFFFFFFFF) * 1_000_003 + int(step))
    return g


def keyed_uniforms(seeds, steps, stream: int) -> np.ndarray:
    """U[0, 1) draws, one per (seed, token index) pair of the broadcast
    ``seeds`` and ``steps``, for sub-stream ``stream``: the splitmix64
    finalizer of the packed key, its top 53 bits (float64)."""
    key = ((np.asarray(seeds).astype(np.uint64) & np.uint64(0xFFFFFFFF))
           << np.uint64(32)) | (np.asarray(steps).astype(np.uint64)
                                & np.uint64(0xFFFFFFFF))
    z = key + np.uint64(((stream + 1) * 0x9E3779B97F4A7C15)
                        & 0xFFFFFFFFFFFFFFFF)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


def sample_tokens_logprobs(logits, temperatures, top_ks, seeds, steps):
    """logits [B, V]; per-row temperature/top_k/seed/token-index (host
    sequences) -> (tokens [B] int64, chosen-token log-probabilities [B]
    under log-softmax of the raw logits), both on the host."""
    lf = logits.to(torch.float32)
    toks = torch.argmax(lf, dim=-1)
    for b, temp in enumerate(temperatures):
        if temp > 0.0:
            probs = torch.softmax(
                _restricted_logits(lf[b], float(temp), int(top_ks[b])), -1)
            toks[b] = torch.multinomial(
                probs, 1, generator=row_generator(seeds[b], steps[b],
                                                  lf.device))[0]
    logp = torch.log_softmax(lf, dim=-1)
    chosen = torch.gather(logp, -1, toks[:, None])[:, 0]
    return toks.cpu().numpy(), chosen.cpu().numpy()


def _inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Categorical draws from unnormalized ``probs`` [..., V] at uniforms
    ``u`` [...]: the first index whose running mass exceeds u x the total
    (float64, so a zero-mass token is never drawn)."""
    cdf = torch.cumsum(probs.to(torch.float64), dim=-1)
    target = (u * cdf[..., -1])[..., None]
    idx = torch.searchsorted(cdf, target, right=True)[..., 0]
    return idx.clamp(max=probs.shape[-1] - 1)


def _verify_stochastic(lf, draft, n_draft, temperatures, top_ks, seeds,
                       steps):
    """The leave-one-in rule over rows with temperature > 0: lf [n, S, V]
    f32 and draft [n, S] on the device, the rest host arrays of n.
    Returns (n_accept [n], tokens [n, S])."""
    n, S, V = lf.shape
    dev = lf.device
    t = torch.as_tensor(np.maximum(temperatures, 1e-6), dtype=torch.float32,
                        device=dev)
    lf = lf / t[:, None, None]
    k = torch.as_tensor(np.asarray(top_ks), dtype=torch.int64, device=dev)
    if bool((k > 0).any()):
        kmax = min(int(k.max()), V)
        kth = torch.topk(lf, kmax, dim=-1).values.gather(
            -1, (k.clamp(1, kmax) - 1)[:, None, None].expand(n, S, 1))
        lf = torch.where((k > 0)[:, None, None] & (lf < kth),
                         torch.full((), -torch.inf, device=dev), lf)
    probs = torch.softmax(lf, dim=-1)
    pos = np.asarray(steps)[:, None] + np.arange(S)[None]
    seed = np.asarray(seeds)[:, None]

    def draws(stream):
        return torch.as_tensor(keyed_uniforms(seed, pos, stream),
                               device=dev)
    u_accept, u_draw = draws(0), draws(1)
    is_draft = torch.arange(S, device=dev)[None] < torch.as_tensor(
        np.asarray(n_draft), device=dev)[:, None]
    p_draft = probs.gather(-1, draft[..., None])[..., 0]
    accept = is_draft & (u_accept < p_draft)
    # a rejected position resamples with the draft token left out
    resampled = _inverse_cdf(probs.scatter(-1, draft[..., None], 0.0),
                             u_draw)
    bonus = _inverse_cdf(probs, u_draw)
    tok = torch.where(is_draft, torch.where(accept, draft, resampled), bonus)
    n_acc = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
    return n_acc, tok


def verify_draft(logits, draft, n_draft, temperatures, top_ks, seeds, steps):
    """Batched leave-one-in draft verification.

    logits [B, S, V] (device), draft [B, S] and n_draft [B] (host: d_1 ..
    d_{n_draft} left-aligned, the rest padding), per-row sampling
    parameters, and steps [B] = each row's generated-token count (the
    sampling-stream index of its first candidate).  Returns (n_accept [B],
    tokens [B, S], logprobs [B, S]) on the host; row b emits
    ``tokens[b, :n_accept[b] + 1]``, and the logprobs are the chosen
    tokens' under log-softmax of the raw logits.  Positions past a row's
    cut are computed but never read."""
    lf = logits.to(torch.float32)
    dev = lf.device
    tok = torch.argmax(lf, dim=-1)                                 # [B, S]
    d = torch.as_tensor(np.asarray(draft), dtype=torch.int64, device=dev)
    nd = torch.as_tensor(np.asarray(n_draft), dtype=torch.int64, device=dev)
    S = lf.shape[1]
    hit = (tok == d) & (torch.arange(S, device=dev)[None] < nd[:, None])
    n_acc = torch.cumprod(hit.to(torch.int64), dim=1).sum(dim=1)
    temps = np.asarray(temperatures, np.float32)
    rows = np.flatnonzero(temps > 0.0)
    if len(rows):
        pick = torch.as_tensor(rows, device=dev)
        a, t = _verify_stochastic(
            lf[pick], d[pick], np.asarray(n_draft)[rows], temps[rows],
            np.asarray(top_ks)[rows], np.asarray(seeds)[rows],
            np.asarray(steps)[rows])
        n_acc[pick] = a
        tok[pick] = t
    logp = torch.log_softmax(lf, dim=-1)
    chosen = torch.gather(logp, -1, tok[..., None])[..., 0]
    return n_acc.cpu().numpy(), tok.cpu().numpy(), chosen.cpu().numpy()
