"""Serving latency instrumentation (near-copy of ``repro/runtime/metrics.py``).

``RequestMetrics`` records one request's lifecycle timestamps (all from the
engine's injected clock, so tests can drive virtual time) plus the chunked-
prefill trail: how many prefill chunks the request took to reach its first
token, and every inter-token gap its consumer observed.  ``summarize`` folds
a set of finished requests into the numbers the benchmark reports:
throughput (generated tok/s over the measured window), p50/p99 of
time-to-first-token, per-output-token latency, end-to-end latency, the
pooled inter-token-latency percentiles (the decode-tail stall metric
chunked prefill exists to shrink), and a prefill-chunk histogram.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class RequestMetrics:
    # model family that served the request ("" outside the engine)
    family: str = ""
    arrival: float = 0.0               # submitted to the queue
    admitted: float = 0.0              # scheduled into a slot (prefill start)
    first_token: float = 0.0           # first generated token emitted
    finished: float = 0.0              # final token emitted / evicted
    n_tokens: int = 0                  # generated tokens (prompt excluded)
    # chunked-prefill trail: prefill calls this request's prompt (plus any
    # re-prefilled history after a preemption) was split into
    prefill_chunks: int = 0
    # scheduler interventions: how many times this request was preempted
    # back to the queue, and why the LAST preemption/eviction happened
    # ("" = never preempted) — the paged pool's aggregate count can't
    # distinguish one thrashing request from many lightly-touched ones
    n_preemptions: int = 0
    last_preempt_reason: str = ""
    # every observed gap between consecutive generated tokens — includes
    # engine stalls (a long prefill sharing the step, preemption waits),
    # which is exactly what the decode-tail p99 must capture
    itl: list = dataclasses.field(default_factory=list)
    last_token_at: float = 0.0         # internal: previous emit timestamp

    @property
    def queue_wait(self) -> float:
        return self.admitted - self.arrival

    @property
    def ttft(self) -> float:
        """Time to first token, from arrival (includes queueing)."""
        return self.first_token - self.arrival

    @property
    def e2e(self) -> float:
        return self.finished - self.arrival

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first."""
        if self.n_tokens <= 1:
            return 0.0
        return (self.finished - self.first_token) / (self.n_tokens - 1)


def percentiles(values, ps=(50, 99)) -> dict[str, float]:
    if not len(values):
        return {f"p{p}": float("nan") for p in ps}
    arr = np.asarray(values, np.float64)
    return {f"p{p}": float(np.percentile(arr, p)) for p in ps}


def histogram(values) -> dict[str, int]:
    """Exact counts keyed by value (chunk counts are small integers).
    Keys are sorted numerically so serialized histograms are diff-stable
    across runs regardless of first-occurrence order."""
    counts = collections.Counter(int(x) for x in values)
    return {str(v): counts[v] for v in sorted(counts)}


def histogram_str(values) -> dict[str, int]:
    """Exact counts for string-valued categories (preemption reasons),
    keys sorted lexically for diff stability."""
    counts = collections.Counter(values)
    return {k: counts[k] for k in sorted(counts)}


def summarize(metrics: list[RequestMetrics], wall_s: float) -> dict:
    """Aggregate finished-request metrics over a ``wall_s``-second window."""
    done = [m for m in metrics if m.n_tokens > 0]
    total_tokens = sum(m.n_tokens for m in done)
    gaps = [g for m in done for g in m.itl]
    chunks = [m.prefill_chunks for m in done]
    out = {
        "n_requests": len(done),
        "total_tokens": total_tokens,
        "wall_s": wall_s,
        "tok_per_s": total_tokens / wall_s if wall_s > 0 else float("nan"),
        "ttft": percentiles([m.ttft for m in done]),
        "tpot": percentiles([m.tpot for m in done if m.n_tokens > 1]),
        "itl": percentiles(gaps),
        "e2e": percentiles([m.e2e for m in done]),
        "queue_wait": percentiles([m.queue_wait for m in done]),
        "prefill_chunks": {
            "mean": float(np.mean(chunks)) if chunks else math.nan,
            "max": int(max(chunks, default=0)),
            "hist": histogram(chunks),
        },
        "preemptions": {
            "total": sum(m.n_preemptions for m in done),
            "n_requests_preempted": sum(
                1 for m in done if m.n_preemptions > 0),
            "max_per_request": max(
                (m.n_preemptions for m in done), default=0),
            "by_reason": histogram_str(
                m.last_preempt_reason for m in done
                if m.last_preempt_reason),
        },
    }
    return out
