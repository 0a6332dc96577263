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
``format_summary`` renders a summary as the one-line report the serving CLI
prints (a copy of the reference's).  Speculative decoding's per-request
trail (``spec_drafted``, ``spec_accepted``) folds into the summary's
``speculative`` block, which ``format_summary`` prints as the acceptance.
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
    # speculative decoding trail: draft tokens proposed for this request
    # and how many the target accepted (spec_accepted / spec_drafted is
    # how closely the draft tracks the target)
    spec_drafted: int = 0
    spec_accepted: int = 0
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
    drafted = sum(m.spec_drafted for m in done)
    if drafted:
        accepted = sum(m.spec_accepted for m in done)
        out["speculative"] = {
            "drafted": drafted,
            "accepted": accepted,
            "acceptance_rate": accepted / drafted,
        }
    families = sorted({m.family for m in done if m.family})
    if families:
        # per-family throughput and latency tails over the SAME wall clock
        # (families sharing a step loop each get their share of the
        # window, not a solo run's rate); absent when no request carries
        # a family (served outside an engine)
        out["families"] = {
            fam: {
                "n_requests": len(sub),
                "total_tokens": sum(m.n_tokens for m in sub),
                "tok_per_s": (sum(m.n_tokens for m in sub) / wall_s
                              if wall_s > 0 else float("nan")),
                "ttft": percentiles([m.ttft for m in sub]),
                "itl": percentiles([g for m in sub for g in m.itl]),
            }
            for fam in families
            for sub in [[m for m in done if m.family == fam]]
        }
    return out


def format_summary(name: str, s: dict) -> str:
    tps = s["tok_per_s"]
    line = (f"{name:>8}: {s['n_requests']} req, {s['total_tokens']} tok "
            f"in {s['wall_s']:.2f}s"
            + (f" = {tps:.1f} tok/s" if not math.isnan(tps) else ""))
    # ttft/tpot are NaN when no (multi-token) request finished in the
    # window — skip the segment rather than printing "nanms", same guard
    # itl has always had
    ttft = s.get("ttft", {})
    if ttft and not math.isnan(ttft.get("p99", math.nan)):
        line += (f" | ttft p50 {ttft['p50']*1e3:.0f}ms "
                 f"p99 {ttft['p99']*1e3:.0f}ms")
    tpot = s.get("tpot", {})
    if tpot and not math.isnan(tpot.get("p99", math.nan)):
        line += (f" | tpot p50 {tpot['p50']*1e3:.1f}ms "
                 f"p99 {tpot['p99']*1e3:.1f}ms")
    e2e = s.get("e2e", {})
    if e2e and not math.isnan(e2e.get("p99", math.nan)):
        line += (f" | e2e p50 {e2e['p50']*1e3:.0f}ms "
                 f"p99 {e2e['p99']*1e3:.0f}ms")
    itl = s.get("itl", {})
    if itl and not math.isnan(itl.get("p99", math.nan)):
        line += f" | itl p99 {itl['p99']*1e3:.1f}ms"
    ch = s.get("prefill_chunks", {})
    if ch.get("max", 0) > 1:
        line += f" | chunks max {ch['max']}"
    pre = s.get("preemptions", {})
    if pre.get("total", 0) > 0:
        line += f" | preempt {pre['total']}"
    sp = s.get("speculative")
    if sp:
        line += f" | spec accept {sp['acceptance_rate']:.2f}"
    return line
