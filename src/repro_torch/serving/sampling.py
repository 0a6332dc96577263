"""Per-slot token sampling (port of ``repro/serving/sampling.py``,
``sample_tokens_logprobs``).

Greedy rows (temperature <= 0) take the argmax, first index on ties as
``jnp.argmax`` does, so greedy streams match the JAX engine exactly.
Stochastic rows apply temperature and an optional top-k restriction and
draw from a ``torch.Generator`` seeded from the request's (seed, token
index), so a request's stream depends on nothing else in the batch.  The
JAX package derives its keys with threefry ``fold_in``, which torch cannot
reproduce: stochastic rows agree with it in distribution, not in draws.
``verify_draft`` comes with speculative decoding (ROADMAP A8).
"""
from __future__ import annotations

import torch


def _restricted_logits(logits: torch.Tensor, temperature: float,
                       top_k: int) -> torch.Tensor:
    """Temperature + top-k adjusted logits of one row ([V] f32)."""
    lf = logits.to(torch.float32) / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(lf, min(top_k, lf.shape[-1])).values[-1]
        lf = torch.where(lf < kth, torch.full((), -torch.inf,
                                              device=lf.device), lf)
    return lf


def row_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one draw: a function of (seed, token index) only."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) & 0xFFFFFFFF) * 1_000_003 + int(step))
    return g


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
