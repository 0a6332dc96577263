"""Request queue (admission/eviction) and the token-budgeted step policy
(near-copy of ``repro/serving/scheduler.py``).

Admission control is two-level: ``submit`` rejects outright when the queue is
at capacity or the request can never fit the KV pool (prompt + max_new_tokens
> pool capacity); queued requests past ``queue_timeout_s`` are evicted at the
head of every engine step, bounding worst-case queue wait.

Per-step scheduling is **token-budget accounting** (``plan_chunks``): every
engine step may spend up to ``token_budget`` prompt tokens on prefill work,
split into per-request *chunks*.  A prompt longer than the budget advances
chunk-by-chunk across steps (the engine tracks a ``prefill_cursor`` per
request), so one long prompt can no longer monopolize a step and stall every
decoding request — the Sarathi/vLLM-style chunked-prefill schedule, here on
top of the paper's 8:16+outlier compressed-weight serving path.  Priority
order inside a step:

  1. in-flight partial prefills, oldest admission first — they hold
     rows/blocks, so finishing them releases capacity soonest;
  2. new admissions from the queue head, strictly FIFO — the head is never
     skipped (a long prompt at the head is admitted and simply takes more
     steps), which is what makes the policy starvation-free.

Chunk lengths are quantized to ``CHUNK_QUANTUM`` (except a sequence's final
chunk), so cursor values — and with them the compiled (prefix_len, bucket)
shape ladder of the chunked prefill function — stay small.

``max_prefill_per_step`` (the old bounded-request-count interleave knob) is
deprecated: ``resolve_token_budget`` maps it to the equivalent token budget
(N requests of up to ``max_len`` tokens each) and warns once.

A preempted request goes back to the queue head (``pick_preemption_victim``
picks the youngest); the slot layout re-prefills its prompt + generated
tokens, which recomputes the same KV, so token streams are preserved.
"""
from __future__ import annotations

import collections
import warnings
from typing import Callable, Iterator

from .request import Request, Status

# chunk lengths (and therefore prefill cursors) are multiples of this,
# except a sequence's final chunk — bounds the compiled shape ladder
CHUNK_QUANTUM = 8

# preemption reasons, recorded on RequestMetrics and as counter labels:
# decode pressure = the arena ran dry growing a decode step; prefill
# pressure = an in-flight chunk could not get blocks for its next cursor
PREEMPT_DECODE_PRESSURE = "decode_pressure"
PREEMPT_PREFILL_PRESSURE = "prefill_pressure"


class QueueFull(RuntimeError):
    """Raised by ServingEngine.submit when admission control rejects."""


_budget_alias_warned = False


def resolve_token_budget(token_budget: int | None,
                         max_prefill_per_step: int | None,
                         max_len: int) -> int:
    """Resolve the engine's per-step prefill token budget.

    ``max_prefill_per_step`` is the deprecated request-count knob; when
    given it maps to the equivalent token budget — N requests of up to
    ``max_len`` tokens each per step — and warns once per process.  With
    neither knob set the default budget is ``2 * max_len`` (the historical
    default of two full prefills between decode steps).
    """
    global _budget_alias_warned
    if max_prefill_per_step is not None:
        if not _budget_alias_warned:
            warnings.warn(
                "max_prefill_per_step is deprecated; pass token_budget "
                "instead (mapping N requests/step to N * max_len tokens)",
                DeprecationWarning, stacklevel=3)
            _budget_alias_warned = True
        if token_budget is None:
            token_budget = max(int(max_prefill_per_step), 1) * max_len
    if token_budget is None:
        token_budget = 2 * max_len
    return validate_token_budget(int(token_budget), max_len=max_len)


def validate_token_budget(token_budget: int, *, max_len: int,
                          quantum: int = CHUNK_QUANTUM) -> int:
    """Construction-time validation of the engine's per-step budget — a
    clear ``ValueError`` at ``ServingEngine(...)`` instead of a deep stall
    or failure inside ``plan_chunks``.

    The budget must cover (a) the chunk quantum, or no mid-sequence chunk
    can ever be scheduled and the queue head stalls forever, and (b) the
    FIRST chunk of the longest admissible prompt — for ``max_len`` below
    the quantum that first chunk is the whole prompt (final chunks are
    exempt from quantization), so the effective floor is
    ``min(quantum, max_len)``; any budget that also satisfies (a) covers
    it.  Returns the validated budget for chaining.
    """
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    floor = min(quantum, max_len)
    if token_budget < floor:
        raise ValueError(
            f"token_budget={token_budget} cannot schedule any prefill "
            f"chunk: it must cover the chunk quantum ({quantum}) and the "
            f"longest admissible prompt's first chunk "
            f"(min(quantum, max_len={max_len}) = {floor})")
    return token_budget


def _chunk_take(budget: int, remaining: int, quantum: int) -> int:
    """Tokens to schedule for one request: the whole remainder when it
    fits, else the largest quantum multiple within budget (0 = no room)."""
    take = min(budget, remaining)
    if take < remaining:
        take -= take % quantum
    return take


def plan_chunks(in_flight: list[tuple], queued: list[tuple],
                token_budget: int, quantum: int,
                try_admit: Callable) -> list[tuple]:
    """One step's prefill schedule under a token budget.

    ``in_flight``: [(key, remaining_tokens)] partial prefills in admission
    order; ``queued``: [(key, seq_len)] FIFO.  ``try_admit(key, chunk)`` is
    called for queue entries in order — it performs the layout-specific
    admission (row/block allocation, prefix-cache match) and returns the
    tokens actually left to compute (< seq_len on a prefix-cache hit), or
    None when the request cannot be placed (planning then stops: the head
    is deferred, never skipped, preserving FIFO).

    Returns [(key, take)] with sum(take) <= token_budget and every take
    positive and quantum-aligned unless it finishes its sequence.
    """
    budget = int(token_budget)
    chunks: list[tuple] = []
    for key, remaining in in_flight:
        if budget <= 0:
            break
        take = _chunk_take(budget, remaining, quantum)
        if take == 0:
            break                       # head-of-line keeps its turn
        chunks.append((key, take))
        budget -= take
    for key, seq_len in queued:
        if budget <= 0:
            break
        want = _chunk_take(budget, seq_len, quantum)
        if want == 0:
            break
        remaining = try_admit(key, want)
        if remaining is None:
            break                       # no capacity: defer the head, stop
        take = min(want, remaining)
        chunks.append((key, take))
        budget -= take
    return chunks


class RequestQueue:
    def __init__(self, max_size: int = 64, queue_timeout_s: float | None = None):
        self.max_size = max_size
        self.queue_timeout_s = queue_timeout_s
        self._q: collections.deque[Request] = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self) -> Iterator[Request]:
        """FIFO view (head first) — the planner peeks without popping."""
        return iter(self._q)

    def try_push(self, req: Request) -> bool:
        if len(self._q) >= self.max_size:
            return False
        self._q.append(req)
        return True

    def pop(self) -> Request | None:
        return self._q.popleft() if self._q else None

    def push_front(self, req: Request) -> None:
        """Return an already-admitted request to the head of the queue
        (paged admission ran out of blocks, or a preemption).  Bypasses
        the capacity check: the request was accepted once and must not be
        silently dropped."""
        self._q.appendleft(req)

    def evict_expired(self, now: float) -> list[Request]:
        """Drop queued requests older than queue_timeout_s (FIFO order).

        The timeout bounds the wait for FIRST service: requests that were
        already served and preempted back to the queue (generated tokens
        in hand) are exempt — evicting them would silently discard
        completed work, violating push_front's no-drop contract."""
        if self.queue_timeout_s is None:
            return []
        evicted = []
        kept = collections.deque()
        for req in self._q:
            if (now - req.metrics.arrival > self.queue_timeout_s
                    and not req.tokens and req.n_preempted == 0):
                evicted.append(req)
            else:
                kept.append(req)
        self._q = kept
        return evicted


def pick_preemption_victim(running: dict[int, Request]) -> int:
    """Slot of the request to preempt.

    Youngest-first (latest admission): the request that has sunk the
    least work is restarted, and repeated preemption converges — older
    requests keep their blocks and drain, releasing memory.  Ties (one
    admission group) break toward the higher request id."""
    return max(running,
               key=lambda s: (running[s].metrics.admitted,
                              running[s].request_id))
