"""Request traces: synthetic workloads (Poisson open-loop, long-prompt
chunked-prefill stress, fleet-shaped tenant mixes), JSON round-trip, and
replay (copy of ``repro/serving/trace.py``, pure numpy and host code).

A trace is a list of ``TraceRequest`` — arrival offset (seconds from trace
start), prompt, and sampling params.  Every generator draws from one
``np.random.default_rng(seed)`` in the reference's order, so both packages
make the same requests from the same seed, and the JSON files are one
format.  ``replay`` drives a ServingEngine against wall-clock arrivals
(scaled by ``time_scale``): requests are submitted once their arrival time
passes, the engine steps whenever it has work, and the loop exits when
everything drains.  Used by the ``--trace`` mode of launch/serve.py.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from .request import SamplingParams
from .scheduler import QueueFull


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    arrival_s: float                   # offset from trace start
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    # session/tenant id for fleet routing affinity; -1 = no session.
    # Defaulted so pre-fleet trace JSON still loads.
    session: int = -1

    def sampling(self) -> SamplingParams:
        return SamplingParams(max_new_tokens=self.max_new_tokens,
                              temperature=self.temperature,
                              top_k=self.top_k, seed=self.seed)


def poisson_trace(*, n_requests: int, rate_per_s: float, vocab: int,
                  prompt_len: tuple[int, int] = (8, 32),
                  max_new_tokens: int = 16, temperature: float = 0.0,
                  seed: int = 0) -> list[TraceRequest]:
    """Synthetic open-loop workload: exponential interarrival gaps at
    ``rate_per_s``, prompt lengths uniform over [lo, hi], random token ids."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_per_s))
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        prompt = rng.integers(0, vocab, size=plen).tolist()
        out.append(TraceRequest(arrival_s=t, prompt=prompt,
                                max_new_tokens=max_new_tokens,
                                temperature=temperature, seed=i))
    return out


def long_prompt_trace(*, n_short: int, short_len: int, gen_short: int,
                      n_long: int, long_len: int, gen_long: int,
                      vocab: int, long_after_s: float = 0.05,
                      seed: int = 0) -> list[TraceRequest]:
    """The chunked-prefill stress workload: a burst of short decode-heavy
    requests, then very long prompts landing while everyone is mid-decode.

    Without a token budget each long prompt prefills in one engine step and
    every decoding request observes that step's full latency as one
    inter-token gap; with chunked prefill the prompt advances
    ``token_budget`` tokens per step and decode gaps stay bounded.  The
    benchmark replays this trace one-shot vs chunked and compares the
    decode-tail (pooled inter-token latency p99) at an equal KV budget.
    """
    rng = np.random.default_rng(seed)
    out = [TraceRequest(arrival_s=0.001 * i,
                        prompt=rng.integers(0, vocab, size=short_len).tolist(),
                        max_new_tokens=gen_short, seed=i)
           for i in range(n_short)]
    for j in range(n_long):
        out.append(TraceRequest(
            arrival_s=long_after_s * (j + 1),
            prompt=rng.integers(0, vocab, size=long_len).tolist(),
            max_new_tokens=gen_long, seed=n_short + j))
    return out


def fleet_trace(*, n_requests: int, n_tenants: int, vocab: int,
                sys_len: int = 32, rate_per_s: float = 20.0,
                burst_mean: float = 4.0,
                prompt_median: int = 16, prompt_sigma: float = 0.8,
                prompt_max: int = 64,
                gen_median: int = 6, gen_sigma: float = 1.0,
                gen_max: int = 48, temperature: float = 0.0,
                seed: int = 0) -> list[TraceRequest]:
    """The fleet-scale workload: shared-system-prompt tenants, heavy
    tails, bursts — the "millions of users" shape, shrunk to a trace.

    * **tenant mix**: each request belongs to one of ``n_tenants``
      sessions and opens with that tenant's fixed ``sys_len``-token
      system prompt followed by a per-request tail — the prefix-cache
      sharing opportunity routing is meant to exploit (and round-robin
      is meant to squander, by spreading every tenant over every
      replica's cache);
    * **heavy-tailed lengths**: prompt-tail and output lengths are
      lognormal (median/sigma, clipped to [1, max]) — a few stragglers
      decode long after the cohort retires, which is exactly where one
      wide engine burns its full fused-decode lane complement on
      near-empty batches;
    * **bursty arrivals**: arrival epochs are Poisson at ``rate_per_s``
      and each epoch lands a geometric burst (mean ``burst_mean``) of
      back-to-back requests — queues actually form, giving
      work-stealing something to level.

    Deterministic in ``seed`` and — by construction — independent of
    who consumes it: every sample is drawn from one generator in one
    fixed order, so 1-replica and N-replica runs (any routing policy)
    replay the identical request stream (pinned by tests/test_fleet.py).
    """
    rng = np.random.default_rng(seed)
    sys_prompts = [rng.integers(0, vocab, size=sys_len).tolist()
                   for _ in range(n_tenants)]

    def _lognormal(median: int, sigma: float, hi: int) -> int:
        x = rng.lognormal(mean=float(np.log(max(median, 1))), sigma=sigma)
        return int(np.clip(round(x), 1, hi))

    out: list[TraceRequest] = []
    t = 0.0
    while len(out) < n_requests:
        t += float(rng.exponential(1.0 / rate_per_s))
        burst = min(1 + int(rng.geometric(1.0 / burst_mean)),
                    n_requests - len(out))
        for j in range(burst):
            i = len(out)
            tenant = int(rng.integers(n_tenants))
            tail = _lognormal(prompt_median, prompt_sigma, prompt_max)
            prompt = sys_prompts[tenant] \
                + rng.integers(0, vocab, size=tail).tolist()
            out.append(TraceRequest(
                arrival_s=t + 1e-4 * j, prompt=prompt,
                max_new_tokens=_lognormal(gen_median, gen_sigma, gen_max),
                temperature=temperature, seed=i, session=tenant))
    return out


def save_trace(path: str, trace: list[TraceRequest]) -> None:
    with open(path, "w") as f:
        json.dump([dataclasses.asdict(t) for t in trace], f)


def load_trace(path: str) -> list[TraceRequest]:
    with open(path) as f:
        return [TraceRequest(**d) for d in json.load(f)]


def replay(engine, trace: list[TraceRequest], *, time_scale: float = 1.0,
           verbose: bool = False) -> dict:
    """Feed ``trace`` into ``engine`` against the wall clock.

    ``time_scale`` compresses (<1) or stretches (>1) arrival gaps.  Requests
    rejected by admission control are recorded, not retried (open-loop
    workload).  Returns {"finished": [...], "rejected": n, "wall_s": s}.
    """
    pending = sorted(trace, key=lambda t: t.arrival_s)
    t0 = time.monotonic()
    rejected = 0
    i = 0
    while i < len(pending) or engine.has_work:
        now = time.monotonic() - t0
        while i < len(pending) and pending[i].arrival_s * time_scale <= now:
            tr = pending[i]
            i += 1
            try:
                # fleets take a session id for routing affinity; plain
                # engines don't — feature-detect so one replay drives both
                if tr.session >= 0 and getattr(engine, "accepts_session",
                                               False):
                    engine.submit(tr.prompt, tr.sampling(),
                                  session=tr.session)
                else:
                    engine.submit(tr.prompt, tr.sampling())
            except (QueueFull, ValueError) as e:
                # queue at capacity, or the request can never fit a slot —
                # open-loop workload: count it rejected, keep replaying
                rejected += 1
                if verbose:
                    print(f"rejected request {i - 1}: {e}")
        if engine.has_work:
            engine.step()
        elif i < len(pending):
            # idle until the next arrival is due
            next_due = pending[i].arrival_s * time_scale
            time.sleep(min(max(next_due - (time.monotonic() - t0), 0.0), 0.05))
    wall_s = time.monotonic() - t0
    return {"finished": engine.finished, "rejected": rejected, "wall_s": wall_s}
