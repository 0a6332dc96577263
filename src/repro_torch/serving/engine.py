"""Continuous-batching serving engine for the dense, moe, ssm, hybrid and
encdec families, on the slot and paged KV layouts (port of
``repro/serving/engine.py``).

Every ``step()`` evicts expired queue entries, spends up to
``token_budget`` prompt tokens on prefill chunks (in-flight cursors first,
then FIFO admissions), and advances every prefill-complete request by one
token in a single fused decode.  All model work goes through the family
adapter (``serving/families.py``): for the dense family
``models/transformer.unified_step`` over a ``SlotPoolView``, where each
step writes its fresh KV into the arena and attends in place with the
per-request cursor as a length mask, so chunked prefill computes what the
one-shot prefill does (the moe family the same, its FFN routed through
``models/moe.py``); for ssm (xLSTM) ``models/xlstm.unified_step`` over
recurrent state slots, for hybrid (Zamba2) ``models/zamba.unified_step``
over state slots and the shared attention's KV, and for encdec (Whisper)
``models/whisper.unified_step`` over decoder KV slots and the encoder
context rows its adapter projected at admission from the request's
``embeds`` (``submit(embeds=)``; ``max_ctx`` frames a slot).  An ssm
engine serves the slot layout whatever was asked, and its token budget
needs no chunk quantum (any budget; chunks as wide as the budget).  Chunks
at the same cursor are padded to power-of-two length buckets (``_bucket``)
and batched; padding lanes write nothing and their outputs are never
read.  MoE's routing is the exact, capacity-free one there, so padding
cannot evict a real token: every model call runs under
``policy.suspended()`` (in the adapters), since an active training policy
would put it on the capacity path.

Two KV layouts behind one API (``kv_layout=``):

  "slot"   ``SlotKVPool``: contiguous [L, n_slots, max_len, KV, hd] arenas,
           one slot reserved per request for its lifetime.
  "paged"  ``PagedKVPool`` (serving/paged/): KV in ``block_size``-token
           blocks allocated on demand from one shared arena, addressed
           through per-request block tables and attended by the paged
           attention kernel.  Allocation is chunk-aware; identical prefixes
           share blocks read-only (prefix cache); decode or prefill
           pressure preempts the youngest request back to the queue, after
           publishing its fully written blocks to the prefix cache so the
           resume restarts at the last full block.

Either layout stores bf16 KV or, with ``kv_dtype="int8"``, int8 KV with an
f32 scale per position and KV head (quantized as it is written, dequantized
inside attention).

On the card every ``SparseWeight`` product goes through the hand-written
kernels (``kernels/``; int8 N:M values through their int8 variants), and
paged attention through its decode and prefill-chunk bodies
(``csrc/paged_attention_decode.cu``, ``csrc/paged_attention_prefill.cu``).

``draft=`` takes a ``SpeculativeConfig`` (``serving/speculative.py``):
each decode step then drafts k tokens per decoding request (a second
model over its own slot arena, or n-gram prompt lookup), verifies all
k + 1 candidate positions in one chunk-shaped model call at per-lane
cursors, emits the accepted prefix plus a correction or bonus token
(``sampling.verify_draft``) and rolls the cursor back over the rejected
tail.  Greedy speculative streams are the plain engine's tokens.  The
verify tokens are charged against the step's token budget before prefill
planning (``scheduler.spec_verify_reserve``).

``tracer=`` takes a ``ServingTracer`` (``serving/observe.py``): Perfetto
spans of every step, phase and request lifecycle, the serving counters and
per-variant attribution of the model calls (a drafter's as ``draft_step``
and ``draft_decode``).  The default ``NULL_TRACER`` does nothing, and
every hook's call site is guarded by ``tracer.enabled``, so an untraced
step does no observability work: no synchronize, no event, no span.

``ingest``, ``withdraw`` and ``steal_youngest`` move queued, slotless
requests between engines: the fleet's replicas (``serving/fleet/``).

``mesh=`` (a ``DeviceMesh`` from ``launch/mesh.make_serving_mesh``)
serves tensor-parallel through ``ServingPlacement``
(``serving/placement.py``): out-dim splits of every projection, the
embedding and the head, KV heads split across the ranks' arenas, explicit
gathers in the layers.  One process a rank, every rank running this
engine on the same requests; every clock read is rank 0's, broadcast, so
every rank evicts, admits and plans the same work and its collectives
meet the others'.  Every family is served so (ROADMAP A12a and A12b:
recurrent-state blocks, expert columns, context rows), and so is
``draft=``: the drafter rides the target's placement, and every
speculative decision (k, the adaptive ``draft_k``, acceptance) reads the
gathered logits and the shared clock alone.

Every registered config of the five families is served (mixtral-8x7b and
llama4-maverick-400b-a17b for moe, whisper-medium for encdec); the vlm
family is refused, as the reference's engine refuses it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve
from .cache_pool import CachePoolError
from .families import build_adapter
from .observe import NULL_TRACER
from .paged import OutOfBlocks
from .placement import ServingPlacement
from .request import Request, SamplingParams, Status
from .sampling import sample_tokens_logprobs, verify_draft
from .scheduler import (CHUNK_QUANTUM, PREEMPT_DECODE_PRESSURE,
                        PREEMPT_PREFILL_PRESSURE, QueueFull, RequestQueue,
                        pick_preemption_victim, plan_chunks,
                        resolve_token_budget, spec_verify_reserve)
from .speculative import SpeculativeConfig, Speculator, verify_bucket

SUPPORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
KV_LAYOUTS = ("slot", "paged")


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class ServingEngine:
    def __init__(self, cfg, params, *, device="cuda", n_slots: int = 8,
                 max_len: int = 256, max_queue: int = 64,
                 queue_timeout_s: float | None = None,
                 token_budget: int | None = None,
                 max_prefill_per_step: int | None = None,
                 kv_layout: str = "slot", kv_dtype: str = "bf16",
                 block_size: int = 16, n_blocks: int | None = None,
                 prefix_caching: bool = True, lookahead_blocks: int = 1,
                 mesh=None, max_ctx: int | None = None,
                 clock=time.monotonic, tracer=None,
                 draft: SpeculativeConfig | None = None):
        if cfg.family not in SUPPORTED_FAMILIES:
            raise ValueError(
                f"ServingEngine supports {SUPPORTED_FAMILIES} families, not "
                f"{cfg.family!r}")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, "
                             f"not {kv_layout!r}")
        self.placement = ServingPlacement(mesh, cfg)
        if draft is not None:
            # refusals of the draft come before any tensor is placed
            if cfg.family not in ("dense", "moe"):
                raise ValueError(
                    "speculative decoding needs a KV-transformer target "
                    f"(dense/moe), not family {cfg.family!r}: rollback "
                    "relies on the cursor hiding rejected positions, which "
                    "recurrent state cannot do")
            if draft.method == "model":
                # a draft whose KV heads cannot follow the target's split
                self.placement.for_draft(draft.cfg or cfg)
        params = self.placement.place_params(params)
        self.device = resolve(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        # the family adapter owns the state substrate (pools and arenas)
        # and the model calls; the engine schedules against its pool.  ssm
        # has no KV to page: its layout is coerced to "slot"; encdec
        # refuses "paged"
        if cfg.family == "ssm":
            kv_layout = "slot"
        self.adapter = build_adapter(
            cfg, params, device=self.device, kv_layout=kv_layout,
            n_slots=n_slots, max_len=max_len, block_size=block_size,
            n_blocks=n_blocks, prefix_caching=prefix_caching,
            kv_dtype=kv_dtype, max_ctx=max_ctx, placement=self.placement)
        self.kv_layout = kv_layout
        self.kv_dtype = kv_dtype
        self.pool = self.adapter.pool
        self.queue = RequestQueue(max_queue, queue_timeout_s)
        # a pure-recurrent request carries O(1) state: no block math and
        # no shape ladder worth bounding, so the quantum floor check is
        # waived (quantum 1) and the planning quantum widens to the budget
        ssm = cfg.family == "ssm"
        self.token_budget = resolve_token_budget(
            token_budget, max_prefill_per_step, max_len,
            quantum=1 if ssm else CHUNK_QUANTUM)
        self.chunk_quantum = self.token_budget if ssm else CHUNK_QUANTUM
        self.lookahead_blocks = lookahead_blocks
        # speculative decoding (serving/speculative.py): the proposer
        # shares slot identity with the target; each decode step verifies
        # every row's k+1 candidates in one chunk-shaped model call
        self.spec = None
        if draft is not None:
            self.spec = Speculator(draft, cfg, self.placement,
                                   n_slots=n_slots, max_len=max_len,
                                   device=self.device, kv_dtype=kv_dtype)
        self.n_spec_steps = 0
        self.n_drafted = 0
        self.n_accepted = 0
        self.running: dict[int, Request] = {}        # slot -> request
        self.finished: list[Request] = []
        self._clock = clock
        # what scheduling reads (arrivals, queue timeouts, admission
        # order): ``clock`` itself, or rank 0's on a mesh
        self.shared_clock = self.placement.shared_clock(clock)
        # observability: NULL_TRACER is a no-op singleton and every call
        # site is guarded by ``tracer.enabled`` (serving/observe.py)
        self.tracer = NULL_TRACER if tracer is None else tracer
        if self.tracer.enabled:
            self.tracer.attach(self)
            self.adapter.tracer = self.tracer
            if self.spec is not None:
                self.spec.set_tracer(self.tracer)
        self._next_id = 0
        self.n_steps = 0
        self.n_preemptions = 0
        self.max_running = 0
        self.n_prefill_tokens = 0

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
               on_token=None, on_finish=None, embeds=None,
               request_id: int | None = None) -> Request:
        """Enqueue a request; raises QueueFull when the queue is at capacity
        and ValueError when the request can never fit the pool or its
        family refuses it (``adapter.validate_submit``).  ``embeds`` is the
        enc-dec family's encoder input ([S_enc, d] frontend features, run
        once at admission); every other family refuses it."""
        prompt, sampling = self.check_request(prompt, sampling, embeds)
        rid = self._next_id if request_id is None else int(request_id)
        req = Request(rid, prompt, sampling, on_token=on_token,
                      on_finish=on_finish, embeds=embeds)
        req.metrics.family = self.cfg.family
        self._next_id = max(self._next_id + 1, rid + 1)
        req.metrics.arrival = self.shared_clock()
        if not self.queue.try_push(req):
            raise QueueFull(f"queue at capacity ({self.queue.max_size})")
        if self.tracer.enabled:
            self.tracer.on_submit(req)
        return req

    def check_request(self, prompt, sampling: SamplingParams | None = None,
                      embeds=None) -> tuple[list[int], SamplingParams]:
        """``submit``'s admission checks without enqueueing: the prompt as
        a list of ints and the sampling, or the ValueError ``submit``
        would raise (a fleet on replica meshes asks its own replica for
        a request routed to another slice)."""
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
        self.adapter.validate_submit(prompt, sampling, embeds)
        return prompt, sampling

    def ingest(self, req: Request) -> None:
        """Adopt a request from another engine (fleet work-stealing or
        preemption drain).  It must be queued and hold no slot, so it holds
        no KV and no per-engine state and migrating it is re-enqueueing:
        its sampling stream is keyed by (seed, tokens generated), so the
        tokens do not depend on the engine.  Its metrics (arrival time,
        preemption count) ride along untouched."""
        if req.status is not Status.QUEUED or req.slot is not None:
            raise ValueError(
                f"ingest needs a queued, unscheduled request, got "
                f"{req.status} (slot={req.slot})")
        capacity = self.pool.max_request_tokens
        need = len(self._seq(req)) + req.sampling.max_new_tokens \
            - len(req.tokens)
        if need > capacity:
            raise ValueError(
                f"request {req.request_id} needs {need} tokens, over this "
                f"engine's KV capacity {capacity}")
        if not self.queue.try_push(req):
            raise QueueFull(f"queue at capacity ({self.queue.max_size})")
        self._next_id = max(self._next_id, req.request_id + 1)
        if self.tracer.enabled:
            self.tracer.on_submit(req)

    def withdraw(self, req: Request) -> bool:
        """Remove a queued request so a fleet router can ``ingest`` it
        elsewhere.  False when it is no longer in this engine's queue
        (admitted or evicted since the router looked)."""
        if not self.queue.remove(req):
            return False
        if self.tracer.enabled:
            self.tracer.on_withdraw(req)
        return True

    def steal_youngest(self) -> Request | None:
        """Withdraw the youngest queued request (fleet work-stealing): the
        tail of the FIFO queue, so the head of the line and the service
        order the scheduler has promised stay put.  None when the queue is
        empty."""
        req = self.queue.pop_back()
        if req is not None and self.tracer.enabled:
            self.tracer.on_withdraw(req)
        return req

    def prefix_match_length(self, prompt) -> int:
        """How many leading tokens of ``prompt`` the prefix cache holds: a
        side-effect-free host probe (0 on the slot layout)."""
        if self.kv_layout != "paged":
            return 0
        return self.pool.prefix_match_length(
            [int(t) for t in np.asarray(prompt).reshape(-1)])

    # ------------------------------------------------------------ stepping
    @property
    def has_work(self) -> bool:
        return bool(self.running) or len(self.queue) > 0

    def step(self) -> dict:
        """One token-budgeted iteration: evict -> prefill chunks under the
        budget (in-flight cursors first, then admissions) -> fused decode
        of every prefill-complete request."""
        now = self.shared_clock()
        tr = self.tracer
        if tr.enabled:
            tr.begin_step(self.n_steps, now)
        stats = {"evicted": 0, "admitted": 0, "finished": 0, "decoded": 0,
                 "preempted": 0, "prefill_tokens": 0, "prefill_chunks": 0}
        for req in self.queue.evict_expired(now):
            req._finish(Status.EVICTED, now)
            self.finished.append(req)
            stats["evicted"] += 1
            if tr.enabled:
                tr.on_evict(req)

        # speculation charges each decoding request's k+1 verify tokens
        # against the step's token budget before prefill planning: the
        # verify runs through the chunk pipeline prefill uses, so the
        # budget stays a bound on the step's token work
        budget = self.token_budget
        if self.spec is not None:
            reserve = spec_verify_reserve(self.running, self.spec.cfg.k)
            budget = max(budget - reserve, 0)
            stats["spec_reserved"] = min(reserve, self.token_budget)

        self._prefill_phase(stats, now, budget)

        self.max_running = max(self.max_running, len(self.running))
        if any(r.status is Status.RUNNING for r in self.running.values()):
            stats["finished"] += self._decode_once(stats)
        self.n_steps += 1
        self.n_prefill_tokens += stats["prefill_tokens"]
        if tr.enabled:
            tr.end_step(self, stats)
        return stats

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Step until queue and slots drain; returns finished requests."""
        steps = 0
        while self.has_work and (max_steps is None or steps < max_steps):
            self.step()
            steps += 1
        return self.finished

    def stats(self) -> dict:
        out = {"n_steps": self.n_steps, "max_running": self.max_running,
               "n_preemptions": self.n_preemptions,
               "n_running": len(self.running),
               "queue_depth": len(self.queue),
               "n_finished": len(self.finished),
               "n_model_calls": self.adapter.n_model_calls,
               "n_prefill_tokens": self.n_prefill_tokens,
               "family": self.cfg.family, "kv_layout": self.kv_layout,
               "kv_dtype": self.kv_dtype, "token_budget": self.token_budget,
               "device": str(self.device), "pool": self.pool.stats(),
               "placement": self.placement.describe()}
        if self.spec is not None:
            out["speculative"] = {
                "method": self.spec.cfg.method,
                "k": self.spec.cfg.k,
                "n_spec_steps": self.n_spec_steps,
                "drafted": self.n_drafted,
                "accepted": self.n_accepted,
                "acceptance_rate": (self.n_accepted / self.n_drafted
                                    if self.n_drafted else 0.0),
                # > 1: each verify step emits accepted / steps drafts
                # plus its correction or bonus token
                "accepted_per_step": (self.n_accepted / self.n_spec_steps
                                      if self.n_spec_steps else 0.0)}
        return out

    def reset_stats(self) -> None:
        """Zero the step, preemption, concurrency, prefill-token,
        speculation and prefix-cache counters (cached KV is kept):
        benchmarks call this between a warm-up pass and the measured
        window."""
        self.n_steps = 0
        self.n_preemptions = 0
        self.max_running = 0
        self.n_prefill_tokens = 0
        self.n_spec_steps = 0
        self.n_drafted = 0
        self.n_accepted = 0
        if self.kv_layout == "paged":
            self.pool.reset_stats()

    # ------------------------------------------------------------ internals
    @staticmethod
    def _seq(req: Request) -> list[int]:
        """The tokens prefill must cover: the prompt plus anything generated
        before a preemption."""
        return list(req.prompt) + req.tokens

    def _written_seq(self, req: Request) -> list[int]:
        """The leading tokens whose KV the request has written: what a
        preemption can publish to the prefix cache.  Mid-prefill that is the
        cursor; for a decoding request everything but the last generated
        token (its KV is written when it is fed to the next decode)."""
        seq = self._seq(req)
        if req.status is Status.PREFILLING:
            return seq[:req.prefill_cursor]
        return seq[:-1] if req.tokens else seq

    def _prefill_phase(self, stats: dict, now: float, budget: int) -> None:
        """Spend up to ``budget`` prompt tokens: advance in-flight prefill
        cursors first (admission order), then admit from the queue head,
        FIFO."""
        tr = self.tracer
        if tr.enabled:
            tr.begin_phase("plan")
        in_flight = sorted(
            (r for r in self.running.values()
             if r.status is Status.PREFILLING),
            key=lambda r: (r.metrics.admitted, r.request_id))
        flight = [(r, len(self._seq(r)) - r.prefill_cursor)
                  for r in in_flight]
        queued = [(r, len(self._seq(r))) for r in self.queue]

        def try_admit(req, chunk):
            seq = self._seq(req)
            cache_lookup = False
            if self.kv_layout == "paged":
                if not self.pool.can_admit(chunk, self.lookahead_blocks):
                    return None
                cache_lookup = self.pool.prefix_cache is not None
                try:
                    row, n_cached = self.pool.admit(seq, alloc_tokens=0)
                except OutOfBlocks:
                    return None
                end = n_cached + min(chunk, len(seq) - n_cached)
                try:
                    self.pool.ensure_capacity(row, end)
                except OutOfBlocks:
                    self.pool.release(row)
                    return None
            else:
                row = self.pool.alloc()
                if row is None:
                    return None
                n_cached = 0
            popped = self.queue.pop()          # the planned head, by FIFO
            if popped is not req:
                raise CachePoolError("queue head changed during planning")
            self._install_running(req, row, now)
            if tr.enabled:
                tr.on_admit(req, n_cached, cache_lookup)
            # family admission work: a swap-preempted request of a stateful
            # slot layout resumes with its saved state and cursor
            n_cached = max(n_cached, self.adapter.on_admit(req, row))
            req.prefill_cursor = n_cached
            stats["admitted"] += 1
            return len(seq) - n_cached

        chunk_plan = plan_chunks(flight, queued, budget,
                                 self.chunk_quantum, try_admit)

        runnable = []
        for req, take in chunk_plan:
            if self.running.get(req.slot) is not req:
                continue                       # preempted by a prior chunk
            if (self.kv_layout == "paged"
                    and not self._ensure_chunk_capacity(req, take, stats)):
                continue
            runnable.append((req, take))

        by_shape: dict[tuple[int, int], list] = {}
        for req, take in runnable:
            by_shape.setdefault((req.prefill_cursor, _bucket(take)),
                                []).append((req, take))
        if tr.enabled:
            tr.end_phase(planned=len(runnable))
        for (cursor, bucket), group in sorted(by_shape.items()):
            # a later plan entry's capacity loop may have preempted a request
            # after it was validated into runnable: re-check each one
            group = [(r, t) for r, t in group
                     if self.running.get(r.slot) is r
                     and r.prefill_cursor == cursor]
            if group:
                if tr.enabled:
                    tr.begin_phase("chunk", cursor=cursor, bucket=bucket,
                                   n_rows=len(group),
                                   tokens=sum(t for _, t in group))
                stats["finished"] += self._run_chunk_group(group, cursor,
                                                           bucket, stats)
                if tr.enabled:
                    tr.end_phase()

    def _ensure_chunk_capacity(self, req: Request, take: int,
                               stats: dict) -> bool:
        """Grow the row's block table to hold the next chunk.  Under
        pressure: if anything is decoding, skip the chunk this step (the
        decoders drain and free blocks); otherwise preempt the youngest
        other request and retry, so the oldest prefill always progresses."""
        while True:
            try:
                self.pool.ensure_capacity(req.slot,
                                          req.prefill_cursor + take)
                return True
            except OutOfBlocks:
                if any(r.status is Status.RUNNING
                       for r in self.running.values()):
                    return False
                if not any(r is not req for r in self.running.values()):
                    # submit bounds prompt + generation by the pool's
                    # capacity, so this is an accounting bug
                    raise CachePoolError(
                        "sole prefilling request cannot grow its KV")
                self._preempt_one(stats, exclude=req,
                                  reason=PREEMPT_PREFILL_PRESSURE)

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
        if self.spec is not None:
            if req.draft_k == 0:
                req.draft_k = self.spec.cfg.k
            # whatever the draft arena holds at this slot belongs to a
            # previous occupant; the drafter catches up lazily from 0
            self.spec.on_admit(slot)

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
        if self.kv_layout == "paged":
            lanes = self.pool.lane_tables(rows, B)
        else:
            self.pool.chunk_end_check(cursor, takes)
            lanes = self.pool.lane_rows(rows, B)
        logits = self.adapter.step_chunk(lanes, cur, n_new, tokens,
                                         rows=rows)
        self.pool.advance_prefill(rows, [cursor + t for t in takes])
        stats["prefill_tokens"] += sum(takes)
        stats["prefill_chunks"] += n

        tr = self.tracer
        done_idx, done_rows, done_last = [], [], []
        for i, ((req, take), seq) in enumerate(zip(group, seqs)):
            req.prefill_cursor = cursor + take
            req.metrics.prefill_chunks += 1
            if tr.enabled:
                tr.on_chunk(req, cursor, take)
            if req.prefill_cursor == len(seq):
                req.status = Status.RUNNING
                if self.kv_layout == "paged":
                    self.pool.register_prefix(req.slot, seq)
                if tr.enabled:
                    tr.on_prefill_complete(req)
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
        the queue head and release its slot or blocks.  On re-admission a
        dense request re-prefills prompt + generated tokens, which
        recomputes the same KV, so its token stream is unchanged; on the
        paged layout its fully written blocks are first published to the
        prefix cache, so the resume starts at the last full block.  A
        stateful slot-layout family (ssm, hybrid on slots) saves its state
        instead (``adapter.save_for_preempt``) and resumes it verbatim."""
        candidates = ({s: r for s, r in self.running.items()
                       if r is not exclude}
                      if exclude is not None else self.running)
        victim_slot = pick_preemption_victim(candidates)
        req = self.running.pop(victim_slot)
        # stateful slot-layout families swap their state out (recompute
        # would change float summation order); attention-only families
        # return None and recompute exactly
        req.swap = self.adapter.save_for_preempt(
            req, victim_slot, len(self._written_seq(req)))
        if self.kv_layout == "paged":
            self.pool.register_prefix(victim_slot, self._written_seq(req))
            self.pool.n_preemptions += 1
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
        if self.tracer.enabled:
            self.tracer.on_preempt(req, reason)

    def _decode_rows(self) -> list[int]:
        return sorted(s for s, r in self.running.items()
                      if r.status is Status.RUNNING)

    def _decode_once(self, stats: dict) -> int:
        """Advance every prefill-complete request one token in a single
        fused step (``unified_step`` at S=1 over every lane).  Rows
        mid-prefill and free rows share the batch but are masked out of
        position updates and sampling.  On the slot layout their lanes write
        a garbage token at their position, which is overwritten before anyone
        reads it; on the paged layout only the active rows write, into
        blocks ``prepare_decode`` made private (it preempts under
        OutOfBlocks).  On the card the step of a dense engine without a
        mesh is a replayed CUDA graph (``families.CapturedStep``).  A
        speculating engine drafts and verifies instead."""
        if self.spec is not None:
            return self._speculative_decode(stats)
        active = self._decode_rows()
        if self.kv_layout == "paged":
            active = self._prepare_decode(active, stats)
            if not active:
                return 0
        stats["decoded"] = len(active)
        tr = self.tracer
        if tr.enabled:
            tr.begin_phase("decode", n_active=len(active))
        logits = self.adapter.step_decode(self._last_token[:, None], active)
        # a copy: a replayed decode's logits are its graph's own output
        self._slot_logits = logits[:, 0].to(torch.float32, copy=True)
        n_finished = self._emit_tokens(active)
        advanced = np.zeros((self.pool.n_slots,), bool)
        advanced[[s for s in active if s in self.running]] = True
        self.pool.advance_decode(advanced)
        if tr.enabled:
            tr.end_phase(finished=n_finished)
        return n_finished

    def _prepare_decode(self, active: list[int], stats: dict,
                        n_tokens: dict | None = None) -> list[int]:
        """Paged layout: make every decoding row able to write its next
        ``n_tokens[row]`` positions (1 each when None), preempting the
        youngest running request while the arena is dry.  Returns the rows
        still decoding."""
        while True:
            try:
                self.pool.prepare_decode(
                    active, None if n_tokens is None
                    else [n_tokens[s] for s in active])
                return active
            except OutOfBlocks:
                if len(self.running) <= 1:
                    # submit bounds prompt + generation by the pool's
                    # capacity, so this is an accounting bug
                    raise CachePoolError(
                        "sole running request cannot grow its KV")
                self._preempt_one(stats, reason=PREEMPT_DECODE_PRESSURE)
                active = self._decode_rows()

    def _speculative_decode(self, stats: dict) -> int:
        """Draft k tokens per decoding request, verify all k+1 candidate
        positions in one chunk-shaped model call, emit the accepted prefix
        plus a correction or bonus token, and roll the cursor back over
        the rejected tail.

        The verify call is ``step_chunk`` at per-lane cursors
        ``len(seq) - 1`` (the last emitted token's KV is written here,
        keeping the written-positions invariant) with ``n_new = n_draft +
        1``, over every lane of the pool (a constant batch width) and S on
        ``verify_bucket``'s ladder.  Rollback is ``advance_prefill`` to
        ``cursor + accepted + 1``: the KV beyond it is hidden by the
        cursor's length mask (slot) or sits in blocks the row still owns
        (paged) until the next step overwrites it."""
        tr = self.tracer
        spec = self.spec
        active = self._decode_rows()
        seqs = {s: self._seq(self.running[s]) for s in active}
        cap = self.pool.max_request_tokens
        ks = []
        for s in active:
            req = self.running[s]
            # never draft past the request's finish line or the row's KV
            # capacity (the verify writes len(seq) - 1 + k + 1 positions)
            k = min(req.draft_k,
                    req.sampling.max_new_tokens - len(req.tokens) - 1,
                    cap - len(seqs[s]))
            ks.append(max(k, 0))

        if tr.enabled:
            tr.begin_phase("draft", n_rows=len(active))
        proposals = spec.propose(active, [seqs[s] for s in active], ks)
        drafts = dict(zip(active, proposals))
        if tr.enabled:
            tr.end_phase(drafted=sum(len(d) for d in proposals))

        if self.kv_layout == "paged":
            active = self._prepare_decode(
                active, stats, {s: len(drafts[s]) + 1 for s in active})
            if not active:
                return 0

        n = len(active)
        nds = [len(drafts[s]) for s in active]
        B = _bucket(self.pool.n_slots, 1)
        S = verify_bucket(max(nds) + 1, spec.cfg.k)
        tokens = np.zeros((B, S), np.int64)
        cur = np.zeros((B,), np.int64)
        n_new = np.zeros((B,), np.int64)
        draft_arr = np.zeros((n, S), np.int64)
        for i, s in enumerate(active):
            nd = nds[i]
            cur[i] = len(seqs[s]) - 1
            tokens[i, 0] = self._last_token[s]
            tokens[i, 1:1 + nd] = drafts[s]
            draft_arr[i, :nd] = drafts[s]
            n_new[i] = nd + 1
        if self.kv_layout == "paged":
            lanes = self.pool.lane_tables(active, B)
        else:
            lanes = self.pool.lane_rows(active, B)
        if tr.enabled:
            tr.begin_phase("verify", n_rows=n, s_bucket=S,
                           drafted=sum(nds))
        logits = self.adapter.step_chunk(lanes, cur, n_new, tokens)
        # the real lanes only: padding lanes are never read
        n_acc, v_toks, v_lps = verify_draft(
            logits[:n], draft_arr, nds, self._temps[active],
            self._topks[active], self._seeds[active],
            self._gen_count[active])
        if tr.enabled:
            tr.end_phase(accepted=int(n_acc.sum()))

        # cursor rollback/advance before emission releases any slot: each
        # row's written positions become len(seq) - 1 again once its
        # accepted + 1 tokens are appended (the engine invariant)
        self.pool.advance_prefill(
            active, [int(cur[i]) + 1 + int(n_acc[i]) for i in range(n)])

        if tr.enabled:
            tr.begin_phase("emit", n_rows=n)
        now = self.shared_clock()
        n_finished = 0
        drafted = accepted = emitted = 0
        for i, s in enumerate(active):
            req = self.running[s]
            nd, a = nds[i], int(n_acc[i])
            drafted += nd
            accepted += a
            req.metrics.spec_drafted += nd
            req.metrics.spec_accepted += a
            if spec.cfg.adaptive and nd > 0:
                if a == nd:
                    req.draft_k = min(req.draft_k + 1, spec.cfg.max_k)
                elif 2 * a < nd:
                    req.draft_k = max(req.draft_k - 1, spec.cfg.min_k)
            spec.rollback(s, nd, a)
            sp = req.sampling
            for j in range(a + 1):
                tok = int(v_toks[i, j])
                req._emit(tok, now, logprob=float(v_lps[i, j]))
                self._last_token[s] = tok
                self._gen_count[s] += 1
                emitted += 1
                if (len(req.tokens) >= sp.max_new_tokens
                        or (sp.eos_id is not None and tok == sp.eos_id)):
                    req._finish(Status.FINISHED, now)
                    self.finished.append(req)
                    del self.running[s]
                    self.pool.release(s)
                    n_finished += 1
                    if tr.enabled:
                        tr.on_finish(req)
                    break
        self.n_spec_steps += 1
        self.n_drafted += drafted
        self.n_accepted += accepted
        stats["decoded"] = n
        stats["spec_drafted"] = drafted
        stats["spec_accepted"] = accepted
        stats["spec_emitted"] = emitted
        if tr.enabled:
            tr.end_phase(finished=n_finished)
        return n_finished

    def _emit_tokens(self, slots: list[int]) -> int:
        """Sample one token for ``slots`` from _slot_logits, stream it, and
        retire requests that hit max_new_tokens / EOS."""
        tr = self.tracer
        if tr.enabled:
            tr.begin_phase("emit", n_rows=len(slots))
        toks, lps = sample_tokens_logprobs(
            self._slot_logits, self._temps, self._topks, self._seeds,
            self._gen_count)
        now = self.shared_clock()
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
                if tr.enabled:
                    tr.on_finish(req)
        if tr.enabled:
            tr.end_phase(finished=n_finished)
        return n_finished
