"""Request objects for the continuous-batching serving engine (near-copy of
``repro/serving/request.py``).

A ``Request`` carries the prompt, per-request sampling parameters, and
optional streaming callbacks; the engine mutates its lifecycle state as it
moves through the token-budgeted step pipeline:

    QUEUED -> PREFILLING -> RUNNING -> FINISHED
       ^          |            |
       +----------+------------+   (preempted back to the queue head)

``prefill_cursor`` is the request's position in that pipeline: how many
tokens of prompt + already-generated history have their KV written.  The
engine advances it chunk-by-chunk under the step token budget; when the
cursor reaches the full sequence length the request samples its first
(next) token and joins the fused decode batch.  A preempted request's
cursor resets — on re-admission it is restored to however many leading
0 and the request re-prefills prompt + generated tokens (the slot layout
has no prefix cache; the recompute is exact).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Sequence

from ..runtime.metrics import RequestMetrics


class Status(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"          # scheduled; prompt KV partially written
    RUNNING = "running"                # prefill complete; in the decode batch
    FINISHED = "finished"
    EVICTED = "evicted"                # timed out in queue


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls.

    ``temperature <= 0`` is greedy argmax (the default — matches the one-shot
    serve loop token-for-token); otherwise softmax sampling at the given
    temperature, optionally restricted to the ``top_k`` highest logits.
    """
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0                     # 0 = no top-k restriction
    seed: int = 0
    eos_id: int | None = None


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: Sequence[int]              # token ids
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # streaming hooks: on_token(request, token_id) per generated token,
    # on_finish(request) once the request leaves the engine (any status)
    on_token: Callable | None = None
    on_finish: Callable | None = None

    # engine-managed state
    status: Status = Status.QUEUED
    slot: int | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    metrics: RequestMetrics = dataclasses.field(default_factory=RequestMetrics)
    # tokens of prompt + generated history whose KV is written (valid while
    # scheduled; reset on preemption, restored from prefix-cache matches)
    prefill_cursor: int = 0
    # times the engine preempted this request back to the queue
    # (generated tokens are kept; the resume re-prefills them)
    n_preempted: int = 0
    # per-token chosen-token log-probabilities (log-softmax of the raw
    # logits at each emitted token), parallel to ``tokens``
    logprobs: list[float] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.status in (Status.FINISHED, Status.EVICTED)

    def _emit(self, token: int, now: float,
              logprob: float | None = None) -> None:
        if not self.tokens:
            self.metrics.first_token = now
        else:
            # inter-token gap as the user experiences it: includes any
            # engine stall (long prefill in the step, preemption wait)
            self.metrics.itl.append(now - self.metrics.last_token_at)
        self.metrics.last_token_at = now
        self.tokens.append(token)
        if logprob is not None:
            self.logprobs.append(logprob)
        self.metrics.n_tokens = len(self.tokens)
        if self.on_token is not None:
            self.on_token(self, token)

    def _finish(self, status: Status, now: float) -> None:
        self.status = status
        self.metrics.finished = now
        if self.on_finish is not None:
            self.on_finish(self)
