"""Continuous-batching serving engine, dense family on the slot KV layout
(port of ``repro/serving/engine.py``).

Every ``step()`` evicts expired queue entries, spends up to
``token_budget`` prompt tokens on prefill chunks (in-flight cursors first,
then FIFO admissions), and advances every prefill-complete request by one
token in a single fused decode.  All model work is
``models/transformer.unified_step`` over a ``SlotPoolView``: each step
writes its fresh KV into the arena and attends in place with the
per-request cursor as a length mask, so chunked prefill computes what the
one-shot prefill does.  Chunks at the same cursor are padded to
power-of-two length buckets (``_bucket``) and batched; padding lanes write
nothing and their outputs are never read.

On the card every ``SparseWeight`` product goes through the hand-written
kernels (``kernels/``).  Left out of this slice, each raising
``NotImplementedError``: ``kv_layout="paged"`` (ROADMAP A5),
``kv_dtype="int8"`` (A6), ``draft=`` (A8), ``tracer=`` (A9), ``mesh=``
(A12).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve
from .cache_pool import CachePoolError
from .families import TransformerAdapter
from .request import Request, SamplingParams, Status
from .sampling import sample_tokens_logprobs
from .scheduler import (CHUNK_QUANTUM, PREEMPT_DECODE_PRESSURE, QueueFull,
                        RequestQueue, pick_preemption_victim, plan_chunks,
                        resolve_token_budget)

SUPPORTED_FAMILIES = ("dense",)
KV_LAYOUTS = ("slot",)


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class ServingEngine:
    def __init__(self, cfg, params, *, device="cuda", n_slots: int = 8,
                 max_len: int = 256, max_queue: int = 64,
                 queue_timeout_s: float | None = None,
                 token_budget: int | None = None,
                 max_prefill_per_step: int | None = None,
                 kv_layout: str = "slot", kv_dtype: str = "bf16",
                 mesh=None, clock=time.monotonic, tracer=None, draft=None):
        if cfg.family not in SUPPORTED_FAMILIES:
            raise ValueError(
                f"ServingEngine supports {SUPPORTED_FAMILIES} families, not "
                f"{cfg.family!r}")
        if kv_layout == "paged":
            raise _not_ported('kv_layout="paged"', "A5")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, "
                             f"not {kv_layout!r}")
        if kv_dtype != "bf16":
            raise _not_ported(f"kv_dtype={kv_dtype!r}", "A6")
        if draft is not None:
            raise _not_ported("speculative decoding (draft=)", "A8")
        if tracer is not None:
            raise _not_ported("the serving tracer (tracer=)", "A9")
        if mesh is not None:
            raise _not_ported("mesh placement (mesh=)", "A12")
        self.device = resolve(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.adapter = TransformerAdapter(cfg, params, n_slots=n_slots,
                                          max_len=max_len, device=self.device)
        self.kv_layout = kv_layout
        self.kv_dtype = kv_dtype
        self.pool = self.adapter.pool
        self.queue = RequestQueue(max_queue, queue_timeout_s)
        self.token_budget = resolve_token_budget(
            token_budget, max_prefill_per_step, max_len)
        self.chunk_quantum = CHUNK_QUANTUM
        self.running: dict[int, Request] = {}        # slot -> request
        self.finished: list[Request] = []
        self._clock = clock
        self._next_id = 0
        self.n_steps = 0
        self.n_preemptions = 0
        self.max_running = 0

        # per-slot sampling state (host side, fixed shapes)
        self._temps = np.zeros((n_slots,), np.float32)
        self._topks = np.zeros((n_slots,), np.int32)
        self._seeds = np.zeros((n_slots,), np.int64)
        self._gen_count = np.zeros((n_slots,), np.int64)
        self._last_token = np.zeros((n_slots,), np.int64)
        # logits of each slot's most recent position (a final prefill chunk
        # writes here so first-token sampling reuses the slot-wide sampler)
        self._slot_logits = torch.zeros((n_slots, cfg.vocab),
                                        dtype=torch.float32,
                                        device=self.device)

    # ------------------------------------------------------------ admission
    def submit(self, prompt, sampling: SamplingParams | None = None,
               on_token=None, on_finish=None,
               request_id: int | None = None) -> Request:
        """Enqueue a request; raises QueueFull when the queue is at capacity
        and ValueError when the request can never fit the pool."""
        sampling = sampling or SamplingParams()
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if sampling.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not all(0 <= t < self.cfg.vocab for t in prompt):
            raise ValueError(f"prompt token outside the vocab "
                             f"[0, {self.cfg.vocab})")
        capacity = self.pool.max_request_tokens
        if len(prompt) + sampling.max_new_tokens > capacity:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({sampling.max_new_tokens}) exceeds KV capacity "
                f"{capacity}")
        rid = self._next_id if request_id is None else int(request_id)
        req = Request(rid, prompt, sampling, on_token=on_token,
                      on_finish=on_finish)
        req.metrics.family = self.cfg.family
        self._next_id = max(self._next_id + 1, rid + 1)
        req.metrics.arrival = self._clock()
        if not self.queue.try_push(req):
            raise QueueFull(f"queue at capacity ({self.queue.max_size})")
        return req

    # ------------------------------------------------------------ stepping
    @property
    def has_work(self) -> bool:
        return bool(self.running) or len(self.queue) > 0

    def step(self) -> dict:
        """One token-budgeted iteration: evict -> prefill chunks under the
        budget (in-flight cursors first, then admissions) -> fused decode
        of every prefill-complete request."""
        now = self._clock()
        stats = {"evicted": 0, "admitted": 0, "finished": 0, "decoded": 0,
                 "preempted": 0, "prefill_tokens": 0, "prefill_chunks": 0}
        for req in self.queue.evict_expired(now):
            req._finish(Status.EVICTED, now)
            self.finished.append(req)
            stats["evicted"] += 1

        self._prefill_phase(stats, now)

        self.max_running = max(self.max_running, len(self.running))
        if any(r.status is Status.RUNNING for r in self.running.values()):
            stats["finished"] += self._decode_once(stats)
        self.n_steps += 1
        return stats

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Step until queue and slots drain; returns finished requests."""
        steps = 0
        while self.has_work and (max_steps is None or steps < max_steps):
            self.step()
            steps += 1
        return self.finished

    def stats(self) -> dict:
        return {"n_steps": self.n_steps, "max_running": self.max_running,
                "n_preemptions": self.n_preemptions,
                "n_running": len(self.running),
                "queue_depth": len(self.queue),
                "n_finished": len(self.finished),
                "n_model_calls": self.adapter.n_model_calls,
                "family": self.cfg.family, "kv_layout": self.kv_layout,
                "kv_dtype": self.kv_dtype, "token_budget": self.token_budget,
                "device": str(self.device), "pool": self.pool.stats()}

    # ------------------------------------------------------------ internals
    @staticmethod
    def _seq(req: Request) -> list[int]:
        """The tokens prefill must cover: the prompt plus anything generated
        before a preemption."""
        return list(req.prompt) + req.tokens

    def _prefill_phase(self, stats: dict, now: float) -> None:
        """Spend up to the token budget: advance in-flight prefill cursors
        first (admission order), then admit from the queue head, FIFO."""
        in_flight = sorted(
            (r for r in self.running.values()
             if r.status is Status.PREFILLING),
            key=lambda r: (r.metrics.admitted, r.request_id))
        flight = [(r, len(self._seq(r)) - r.prefill_cursor)
                  for r in in_flight]
        queued = [(r, len(self._seq(r))) for r in self.queue]

        def try_admit(req, chunk):
            row = self.pool.alloc()
            if row is None:
                return None
            popped = self.queue.pop()          # the planned head, by FIFO
            if popped is not req:
                raise CachePoolError("queue head changed during planning")
            self._install_running(req, row, now)
            req.prefill_cursor = 0
            stats["admitted"] += 1
            return len(self._seq(req))

        chunk_plan = plan_chunks(flight, queued, self.token_budget,
                                 self.chunk_quantum, try_admit)

        by_shape: dict[tuple[int, int], list] = {}
        for req, take in chunk_plan:
            by_shape.setdefault((req.prefill_cursor, _bucket(take)),
                                []).append((req, take))
        for (cursor, bucket), group in sorted(by_shape.items()):
            stats["finished"] += self._run_chunk_group(group, cursor, bucket,
                                                       stats)

    def _install_running(self, req: Request, slot: int, now: float) -> None:
        req.slot = slot
        req.status = Status.PREFILLING
        req.metrics.admitted = now
        self.running[slot] = req
        self._temps[slot] = req.sampling.temperature
        self._topks[slot] = req.sampling.top_k
        self._seeds[slot] = req.sampling.seed
        # a resumed request continues its sampling stream at len(tokens)
        self._gen_count[slot] = len(req.tokens)

    def _run_chunk_group(self, group: list[tuple], cursor: int, bucket: int,
                         stats: dict) -> int:
        """One batched step for rows sharing (cursor, bucket): write tokens
        [cursor, cursor+take) into the arena and attend in place, then emit
        a first token for every row whose cursor reached its sequence end.
        Returns the number of requests that finished at once."""
        n = len(group)
        B = _bucket(n, 1)                   # batch pad, power-of-two ladder
        rows = [req.slot for req, _ in group]
        seqs = [self._seq(req) for req, _ in group]
        takes = [take for _, take in group]
        tokens = np.zeros((B, bucket), np.int64)
        cur = np.zeros((B,), np.int64)
        n_new = np.zeros((B,), np.int64)
        for i, (seq, take) in enumerate(zip(seqs, takes)):
            tokens[i, :take] = seq[cursor:cursor + take]
            cur[i] = cursor
            n_new[i] = take
        self.pool.chunk_end_check(cursor, takes)
        lanes = self.pool.lane_rows(rows, B)
        logits = self.adapter.step_chunk(lanes, cur, n_new, tokens)
        self.pool.advance_prefill(rows, [cursor + t for t in takes])
        stats["prefill_tokens"] += sum(takes)
        stats["prefill_chunks"] += n

        done_idx, done_rows, done_last = [], [], []
        for i, ((req, take), seq) in enumerate(zip(group, seqs)):
            req.prefill_cursor = cursor + take
            req.metrics.prefill_chunks += 1
            if req.prefill_cursor == len(seq):
                req.status = Status.RUNNING
                done_idx.append(i)
                done_rows.append(req.slot)
                done_last.append(take - 1)
        if not done_rows:
            return 0
        dev = self.device
        last = logits[torch.as_tensor(done_idx, device=dev),
                      torch.as_tensor(done_last, device=dev)]
        self._slot_logits[torch.as_tensor(done_rows, device=dev)] = \
            last.to(torch.float32)
        return self._emit_tokens(done_rows)

    # -------------------------------------------------------------- decode
    def _preempt_one(self, stats: dict, exclude: Request | None = None,
                     reason: str = PREEMPT_DECODE_PRESSURE) -> None:
        """Push the youngest running request (never ``exclude``) back to
        the queue head and release its slot.  On re-admission it
        re-prefills prompt + generated tokens, which recomputes the same KV,
        so its token stream is unchanged."""
        candidates = ({s: r for s, r in self.running.items()
                       if r is not exclude}
                      if exclude is not None else self.running)
        victim_slot = pick_preemption_victim(candidates)
        req = self.running.pop(victim_slot)
        self.pool.release(victim_slot)
        req.slot = None
        req.status = Status.QUEUED
        req.prefill_cursor = 0
        req.n_preempted += 1
        req.metrics.n_preemptions += 1
        req.metrics.last_preempt_reason = reason
        self.queue.push_front(req)
        self.n_preemptions += 1
        stats["preempted"] += 1

    def _decode_rows(self) -> list[int]:
        return sorted(s for s, r in self.running.items()
                      if r.status is Status.RUNNING)

    def _decode_once(self, stats: dict) -> int:
        """Advance every prefill-complete request one token in a single
        fused step (``unified_step`` at S=1 over every lane).  Rows
        mid-prefill and free rows share the batch but are masked out of
        position updates and sampling; their lanes write a garbage token at
        their position, which is overwritten before anyone reads it."""
        active = self._decode_rows()
        stats["decoded"] = len(active)
        logits = self.adapter.step_decode(self._last_token[:, None])
        self._slot_logits = logits[:, 0].to(torch.float32)
        n_finished = self._emit_tokens(active)
        advanced = np.zeros((self.pool.n_slots,), bool)
        advanced[[s for s in active if s in self.running]] = True
        self.pool.advance_decode(advanced)
        return n_finished

    def _emit_tokens(self, slots: list[int]) -> int:
        """Sample one token for ``slots`` from _slot_logits, stream it, and
        retire requests that hit max_new_tokens / EOS."""
        toks, lps = sample_tokens_logprobs(
            self._slot_logits, self._temps, self._topks, self._seeds,
            self._gen_count)
        now = self._clock()
        n_finished = 0
        for slot in slots:
            req = self.running[slot]
            tok = int(toks[slot])
            req._emit(tok, now, logprob=float(lps[slot]))
            self._last_token[slot] = tok
            self._gen_count[slot] += 1
            sp = req.sampling
            if (len(req.tokens) >= sp.max_new_tokens
                    or (sp.eos_id is not None and tok == sp.eos_id)):
                req._finish(Status.FINISHED, now)
                self.finished.append(req)
                del self.running[slot]
                self.pool.release(slot)
                n_finished += 1
        return n_finished
