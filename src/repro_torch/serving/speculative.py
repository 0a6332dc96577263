"""Draft-verify speculative decoding over the serving engine's pools (port
of ``repro/serving/speculative.py``).

Each decode step of a speculating engine becomes:

            draft                      verify (ONE model call)
  ┌──────────────────────┐   ┌───────────────────────────────────────┐
  │ proposer suggests    │   │ target runs [last_token, d1 .. dk]    │
  │ d1 .. dk per request │ → │ through unified_step at S = k+1:      │
  │ (8:16 model, or      │   │ writes k+1 KV positions, attends in   │
  │  n-gram self-draft)  │   │ place, logits[j] checks draft d_{j+1} │
  └──────────────────────┘   └───────────────────────────────────────┘
                                   ↓ leave-one-in verification
                             accept a leading drafts, emit a+1 tokens
                             (a accepted + 1 correction/bonus), roll
                             the cursor back to pos + a + 1

The verify call is the engine's chunk step (``TransformerAdapter.
step_chunk``) with per-lane ``n_new = k + 1`` at per-lane cursors and S on
``verify_bucket``'s ladder, so on the paged layout it reaches paged
attention's prefill-chunk body (S x n_rep rows above T) or its decode body
(a draft-free verify at S = 1; S = 2 at n_rep <= 4 when k is configured
at 1), and a sparse target's weights the fused kernel's bodies at
M = B x S rows.

Rollback is free in both KV layouts.  The pool's cursor counts positions
actually written, and the last emitted token's KV is written only when it
is fed to the next step; a verify step feeds k+1 tokens and accepts a, so
the cursor moves to ``pos + a + 1`` and the positions beyond it hold
rejected-draft KV that the cursor's length mask hides (slot) or that sits
in blocks the row still owns (paged) until the next step overwrites it.

Two proposers:

  ``ModelDrafter``  a second model (the 8:16-compressed counterpart of the
      target) with its own slot-layout KV arena on the engine's device,
      on a mesh placed as the target is (``ServingPlacement.for_draft``).
      It keeps a per-slot draft cursor ``dpos`` and catches up lazily:
      before drafting it absorbs ``seq[dpos:]`` in one bucketed chunk,
      which covers fresh requests (the drafter prefills the prompt),
      resumes after preemption and prefix-cache hits alike (the drafter has
      no prefix cache; ``dpos`` resets to 0 whenever the target
      (re)allocates the slot), then proposes k tokens greedily with k - 1
      batched S = 1 decodes.  After verification the draft cursor rolls
      back to the accepted prefix.  Its model calls attribute as
      ``draft_step`` and ``draft_decode`` in traces.
  ``NGramProposer``  prompt-lookup self-drafting: match the last n tokens
      of the sequence against its own history and propose the
      continuation of the most recent earlier occurrence.  No model call,
      no state; rows with no match verify 0 drafts (a plain decode).

Acceptance-aware k adaptation lives in the engine (it owns the Request): a
request that accepts everything grows its ``draft_k`` toward ``max_k``;
one that rejects more than half shrinks toward ``min_k``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .families import TransformerAdapter


def _bucket(n: int, lo: int = 1) -> int:
    """Power-of-two ladder from ``lo`` (the engine's chunk ladder starts at
    8; speculation's starts at 1)."""
    b = lo
    while b < n:
        b *= 2
    return b


def verify_bucket(n_new_max: int, k0: int) -> int:
    """S bucket of the verify step's query axis.

    Rung 1 covers draft-free steps (every proposer came back empty, so the
    verify is a decode-shaped step); a drafted step lands on a power-of-two
    ladder anchored at the configured operating point ``_bucket(k0 + 1)``,
    so proposers with variable draft length (n-gram matches of 0..k tokens,
    adaptive k within [min_k, max_k]) share one verify shape across
    [1, k0] and only excursions above k0 add rungs (at most
    log2(max_k / k0)).  Pad positions are masked by per-lane ``n_new``."""
    if n_new_max <= 1:
        return 1
    b = _bucket(k0 + 1)
    while b < n_new_max:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Engine-level speculative decoding configuration (``draft=``).

    ``method="model"`` drafts with a second model (``params`` required,
    typically the 8:16+outlier compressed counterpart of the target, on
    the engine's device; ``cfg`` defaults to the target's config and must
    share its vocab).  ``method="ngram"`` self-drafts by prompt lookup
    (suffix length ``ngram``).  ``k`` is the initial per-request draft
    length; with ``adaptive`` on, each request's k walks within
    [min_k, max_k] by its own acceptance history."""
    k: int = 4
    method: str = "model"
    params: Any = None
    cfg: Any = None
    ngram: int = 2
    adaptive: bool = True
    min_k: int = 1
    max_k: int = 8

    def __post_init__(self):
        if self.method not in ("model", "ngram"):
            raise ValueError(
                f"draft method must be 'model' or 'ngram', not "
                f"{self.method!r}")
        if self.method == "model" and self.params is None:
            raise ValueError("draft method 'model' needs draft params")
        if not (1 <= self.min_k <= self.k <= self.max_k):
            raise ValueError(
                f"need 1 <= min_k <= k <= max_k, got min_k={self.min_k} "
                f"k={self.k} max_k={self.max_k}")
        if self.ngram < 1:
            raise ValueError("ngram suffix length must be >= 1")


class NGramProposer:
    """Prompt-lookup drafting: propose the continuation of the most recent
    earlier occurrence of the sequence's last-``n`` suffix."""

    def __init__(self, n: int = 2):
        self.n = n

    def propose(self, seq: list[int], k: int) -> list[int]:
        n = self.n
        if k <= 0 or len(seq) <= n:
            return []
        suffix = seq[-n:]
        for start in range(len(seq) - n - 1, -1, -1):
            if seq[start:start + n] == suffix:
                return list(seq[start + n:start + n + k])
        return []


class ModelDrafter:
    """A second model proposing tokens over its own slot-layout KV arena.

    Shares slot identity with the target engine (slot i of the draft arena
    belongs to whichever request holds target slot i) and its placement:
    on a mesh the draft params are each rank's out rows by the target's
    rules, the draft arena holds the rank's KV heads where the target's
    does, and the draft logits are read after the head's gather, so every
    rank takes the same argmax (``ServingPlacement.for_draft``).  Proposals are
    greedy (argmax): for a deterministic proposer the leave-one-in rule of
    ``sampling.verify_draft`` preserves the target distribution anyway,
    and greedy maximizes acceptance on the low-temperature traffic
    speculation serves."""

    def __init__(self, cfg, params, placement, *, n_slots: int,
                 max_len: int, device, kv_dtype: str = "bf16"):
        placement = placement.for_draft(cfg)
        self.cfg = cfg
        self.adapter = TransformerAdapter(
            cfg, placement.place_params(params), n_slots=n_slots,
            max_len=max_len, device=device, kv_layout="slot",
            kv_dtype=kv_dtype, placement=placement)
        self.adapter.trace_kind_prefix = "draft_"
        self.max_len = max_len
        # dpos[slot]: draft-arena positions holding the slot's true
        # sequence prefix (the draft cursor); _from[slot]: the sequence
        # length at the last catch-up, where this round's proposals
        # started writing, which rollback measures acceptance against
        self.dpos = np.zeros((n_slots,), np.int64)
        self._from = np.zeros((n_slots,), np.int64)

    def on_admit(self, slot: int) -> None:
        """The target (re)allocated this slot: whatever the draft arena
        holds there belongs to a previous occupant."""
        self.dpos[slot] = 0

    def propose(self, slots: list[int], seqs: list[list[int]],
                ks: list[int]) -> list[list[int]]:
        """Catch the draft KV up to each row's sequence and propose up to
        ``ks[i]`` greedy continuations.  One bucketed chunk absorbs
        ``seq[dpos:]`` for every row at once (per-lane cursors), whose last
        real logit gives d1; then max(k) - 1 batched S = 1 decodes extend
        the drafts."""
        pool = self.adapter.pool
        # constant batch width: pad lanes point past the arena and write
        # nothing, so the catch-up's shapes vary only in S
        B = _bucket(pool.n_slots)
        # the engine speculates only on decoding rows, which emitted at
        # least one token since the last catch-up or rollback: every row
        # has >= 1 token to absorb and a d1 logit to read
        needs = [len(seq) - int(self.dpos[s]) for s, seq in zip(slots, seqs)]
        ks = [min(k, self.max_len - len(seq))
              for k, seq in zip(ks, seqs)]           # never write past arena
        S = _bucket(max(needs))
        tokens = np.zeros((B, S), np.int64)
        cur = np.zeros((B,), np.int64)
        n_new = np.zeros((B,), np.int64)
        for i, (slot, seq, need) in enumerate(zip(slots, seqs, needs)):
            tokens[i, :need] = seq[len(seq) - need:]
            cur[i] = self.dpos[slot]
            n_new[i] = need
        logits = self.adapter.step_chunk(pool.lane_rows(slots, B), cur,
                                         n_new, tokens)
        pool.advance_prefill(slots, [len(seq) for seq in seqs])
        for slot, seq in zip(slots, seqs):
            self.dpos[slot] = self._from[slot] = len(seq)
        rows = torch.arange(len(slots), device=logits.device)
        last = torch.as_tensor(needs, device=logits.device) - 1
        first = torch.argmax(logits[rows, last], -1).cpu().numpy()
        drafts = [[int(first[i])] if ks[i] >= 1 else []
                  for i in range(len(slots))]

        feed = np.zeros((pool.n_slots, 1), np.int64)
        for i, slot in enumerate(slots):
            feed[slot, 0] = first[i]
        for j in range(1, max(ks, default=0)):
            act = [s for i, s in enumerate(slots) if ks[i] > j]
            if not act:
                break
            logits = self.adapter.step_decode(feed, act)
            mask = np.zeros((pool.n_slots,), bool)
            mask[act] = True
            pool.advance_decode(mask)
            self.dpos[act] += 1
            nxt = torch.argmax(logits[:, 0], -1).cpu().numpy()
            for i, slot in enumerate(slots):
                if ks[i] > j:
                    drafts[i].append(int(nxt[slot]))
                    feed[slot, 0] = nxt[slot]
        return drafts

    def rollback(self, slot: int, n_drafted: int, n_accepted: int) -> None:
        """Roll the draft cursor back to the verified prefix.  The last
        round wrote drafts d1..d_{k-1} at sequence positions
        [_from, _from + k - 1); the first ``n_accepted`` of them are now
        true sequence tokens, the rest is KV the cursor hides."""
        if n_drafted > 0:
            self.dpos[slot] = self._from[slot] + min(n_accepted,
                                                     n_drafted - 1)


class Speculator:
    """The engine's handle on speculation: one proposer and the config."""

    def __init__(self, spec: SpeculativeConfig, target_cfg, placement, *,
                 n_slots: int, max_len: int, device, kv_dtype: str = "bf16"):
        self.cfg = spec
        self.drafter = None
        self.ngram = None
        if spec.method == "model":
            dcfg = spec.cfg if spec.cfg is not None else target_cfg
            if dcfg.vocab != target_cfg.vocab:
                raise ValueError(
                    f"draft vocab {dcfg.vocab} != target vocab "
                    f"{target_cfg.vocab}: draft tokens must be target "
                    f"tokens")
            if spec.params["embed"].device != device:
                raise ValueError(
                    f"draft params live on {spec.params['embed'].device}, "
                    f"the engine runs on {device}")
            self.drafter = ModelDrafter(dcfg, spec.params, placement,
                                        n_slots=n_slots, max_len=max_len,
                                        device=device, kv_dtype=kv_dtype)
        else:
            self.ngram = NGramProposer(spec.ngram)

    def set_tracer(self, tracer) -> None:
        if self.drafter is not None:
            self.drafter.adapter.tracer = tracer

    def on_admit(self, slot: int) -> None:
        if self.drafter is not None:
            self.drafter.on_admit(slot)

    def propose(self, slots: list[int], seqs: list[list[int]],
                ks: list[int]) -> list[list[int]]:
        if self.drafter is not None:
            return self.drafter.propose(slots, seqs, ks)
        return [self.ngram.propose(seq, k) for seq, k in zip(seqs, ks)]

    def rollback(self, slot: int, n_drafted: int, n_accepted: int) -> None:
        if self.drafter is not None:
            self.drafter.rollback(slot, n_drafted, n_accepted)
