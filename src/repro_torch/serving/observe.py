"""Serving observability: request/step tracing, the serving counter set,
and step-time attribution — zero-cost when disabled (port of
``repro/serving/observe.py``'s engine tracer; the fleet's router tracers
wait for ROADMAP A10).

The engine takes a ``tracer=`` at construction.  The default is
``NULL_TRACER``, a singleton whose every hook is a no-op and whose
``enabled`` flag is False; every call site in the hot path is guarded by
``if tracer.enabled`` so the disabled engine allocates NOTHING for
observability per step (tests/test_observe.py pins both the identity and
the token-identity of traced vs untraced runs; tests/test_torch_observe.py
holds the port to the same, with no ``torch.cuda.synchronize`` and no CUDA
event on the untraced path).  Pass a ``ServingTracer``
and the same hooks populate three artifacts:

1. **Spans** (``runtime/telemetry.py`` ``TraceBuffer``, Chrome/Perfetto
   ``trace_event`` JSON — load the written file in ``ui.perfetto.dev``):

   - an *engine* process: one "step" span per ``engine.step()`` with
     child spans for the plan / chunk / decode / emit phases and each
     model call ("jit:step", "jit:decode", ...), plus instants for
     compiles and retraces (a new shape variant of a model call),
     preemptions (victim + reason), and prefix-cache lookups
     (matched-block depth);
   - a *requests* process: one thread per request id carrying its
     lifecycle spans — "queued" (arrival -> admitted, re-opened on
     preemption), "prefill" (admitted -> prefill complete, with "chunk"
     instants per chunk), "decode" (first-token eligibility -> finish) —
     and a final "request_summary" instant whose args restate the
     request's ``RequestMetrics`` (admit time, chunk count, token count,
     preemptions), so traces and summaries come from one event stream
     and can be cross-checked exactly.

2. **Counters/gauges** (``MetricsRegistry``): tokens prefilled/decoded,
   requests finished/evicted, preemptions by reason, compiles/retraces
   per model-call kind, prefix-cache lookups/hit-tokens, speculative
   draft/accept/emit token counters (plus a per-step acceptance-rate
   gauge — the live Divergent-Token probe), and per-step
   gauges (queue depth, running, pool occupancy, budget utilization) —
   all labelled by model family — rendered as a Prometheus text snapshot
   (``counters_text()``) and sampled into the trace as "C" counter
   events every ``sample_every`` steps.

3. **Step-time attribution** (``jit_call``): every model call is
   wall-clocked, blocking on the card before the second clock read, and
   keyed by its argument shapes as the reference keys its jitted calls.
   The port compiles nothing, so a "compile" here is the first call of a
   new shape variant; the hook keeps the reference's name, its
   "jit:<kind>" span and its ``serving_jit_*`` counters.  Besides the
   wall time each record keeps ``issue_s``, the host time until the call
   returned (enqueuing its launches), and the call's work from
   ``launch/step_cost.py`` (FLOPs and bytes counted from the shapes, not
   XLA's figure), so a tok/s regression decomposes into compute
   (flops/bytes grew), host issue (issue_s grew), scheduling (more steps,
   lower budget utilization) or new variants.  The wall time of a call
   spans the card's idle gaps too: it is not busy device time, which
   only the profiler reads.

Multiple engines can share one ``TraceBuffer`` and one
``MetricsRegistry`` (a run comparing dense/sparse x slot/paged engines
traces them into a single file): give each engine its own
``ServingTracer`` with the shared ``buffer=``/``registry=`` — each tracer
allocates its own process-id pair and labels its metrics by engine name
and family.

Timestamps come from the engine's injected clock (``attach`` adopts it
unless the tracer was built with an explicit ``clock=``), so virtual-time
tests produce exact, deterministic traces.
"""
from __future__ import annotations

import time

import torch

from ..runtime.telemetry import MetricsRegistry, TraceBuffer


class _NullSpan:
    """Inert context manager; one shared instance, never allocates."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every hook is a no-op returning a shared
    singleton.  ``enabled`` is False so engine call sites skip even
    argument construction; the hooks still exist so an unguarded call is
    harmless rather than fatal."""
    enabled = False

    def attach(self, engine, name=""):
        return self

    def begin_step(self, n_step, now):
        return NULL_SPAN

    def end_step(self, engine, stats):
        pass

    def begin_phase(self, name, **args):
        return NULL_SPAN

    def end_phase(self, **args):
        pass

    def instant(self, name, **args):
        pass

    def on_submit(self, req):
        pass

    def on_admit(self, req, n_cached=0, cache_lookup=False):
        pass

    def on_chunk(self, req, cursor, take):
        pass

    def on_prefill_complete(self, req):
        pass

    def on_preempt(self, req, reason):
        pass

    def on_finish(self, req):
        pass

    def on_evict(self, req):
        pass

    def on_withdraw(self, req):
        pass

    def jit_call(self, kind, fn, args):
        return fn(*args)


NULL_TRACER = NullTracer()

_ENGINE_TID = 0


class ServingTracer:
    """The enabled tracer; see the module docstring for what it records.

    ``buffer``/``registry`` default to fresh private instances; pass
    shared ones to merge several engines into one trace/counter set.
    ``clock`` defaults to adopting the engine's clock at ``attach`` (falling
    back to ``time.monotonic``); pass the engine's virtual clock explicitly
    only when events must be stamped before an engine exists.
    ``sample_every`` thins the per-step counter samples written into the
    trace (the registry itself is always current).
    """

    enabled = True

    def __init__(self, *, buffer: TraceBuffer | None = None,
                 registry: MetricsRegistry | None = None,
                 clock=None, sample_every: int = 1, name: str = ""):
        self.buffer = buffer if buffer is not None else TraceBuffer()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.clock = clock
        self.sample_every = max(int(sample_every), 1)
        self.t0: float | None = None
        self.name = name
        self.family = ""
        self._pid_engine: int | None = None
        self._pid_requests: int | None = None
        # open spans: engine-phase stack, per-step state, per-request state
        self._phase_stack: list[tuple[str, float, dict]] = []
        self._step_t0: float | None = None
        self._step_n: int = 0
        self._req_open: dict[int, dict[str, float]] = {}
        self._req_cached: dict[int, int] = {}
        # model-call variants: shape key -> attribution record
        self._variants: dict[tuple, dict] = {}
        self._kind_counts: dict[str, int] = {}
        # the card to block on (None on the CPU) and the work of a call
        self._device: torch.device | None = None
        self._cost = None

    # --------------------------------------------------------------- setup
    def attach(self, engine, name: str = "") -> "ServingTracer":
        """Bind this tracer to an engine: adopt its clock (unless one was
        given), allocate the engine/requests process ids, and register the
        serving counter set labelled by the engine's family."""
        if self.clock is None:
            self.clock = getattr(engine, "_clock", time.monotonic)
        if self.t0 is None:
            self.t0 = self.clock()
        self.family = getattr(getattr(engine, "cfg", None), "family", "")
        self.name = (self.name or name
                     or (f"{self.family}/{getattr(engine, 'kv_layout', '')}"
                         if self.family else "engine"))
        base = len(self.buffer._named_processes)
        self._pid_engine = 2 * base + 1
        self._pid_requests = 2 * base + 2
        self.buffer.set_process_name(self._pid_engine,
                                     f"engine {self.name}")
        self.buffer.set_process_name(self._pid_requests,
                                     f"requests {self.name}")
        self.buffer.set_thread_name(self._pid_engine, _ENGINE_TID, "steps")
        device = getattr(engine, "device", None)
        self._device = (device if device is not None
                        and device.type == "cuda" else None)
        self._cost = getattr(getattr(engine, "adapter", None), "step_cost",
                             None)
        self._make_counters()
        return self

    def _make_counters(self):
        r = self.registry
        self.c_prefilled = r.counter(
            "serving_tokens_prefilled_total",
            "prompt tokens written through prefill chunks")
        self.c_decoded = r.counter(
            "serving_tokens_decoded_total", "generated tokens emitted")
        self.c_finished = r.counter(
            "serving_requests_finished_total",
            "requests retired, by terminal status")
        self.c_preempted = r.counter(
            "serving_preemptions_total",
            "requests preempted back to the queue, by pressure source")
        self.c_compiles = r.counter(
            "serving_jit_compiles_total",
            "first-time compilations of a jitted step variant")
        self.c_retraces = r.counter(
            "serving_jit_retraces_total",
            "additional shape-bucket variants of an already-compiled fn")
        self.c_cache_lookups = r.counter(
            "serving_prefix_cache_lookups_total",
            "prefix-cache lookups at admission")
        self.c_cache_hits = r.counter(
            "serving_prefix_cache_hits_total",
            "admissions that matched at least one cached block")
        self.c_cache_hit_tokens = r.counter(
            "serving_prefix_cache_hit_tokens_total",
            "prompt tokens skipped via prefix-cache matches")
        self.c_steps = r.counter("serving_steps_total", "engine steps run")
        self.c_spec_drafted = r.counter(
            "serving_spec_tokens_drafted_total",
            "draft tokens proposed to the speculative verify step")
        self.c_spec_accepted = r.counter(
            "serving_spec_tokens_accepted_total",
            "draft tokens the target model accepted")
        self.c_spec_emitted = r.counter(
            "serving_spec_tokens_emitted_total",
            "tokens emitted by speculative steps (accepted + bonus)")
        self.g_spec_accept = r.gauge(
            "serving_spec_acceptance_rate",
            "per-step draft acceptance rate (accepted / drafted)")
        self.g_queue = r.gauge("serving_queue_depth", "requests queued")
        self.g_running = r.gauge("serving_running", "requests in slots")
        self.g_pool_free = r.gauge(
            "serving_pool_free", "free concurrency units (slots/rows)")
        self.g_blocks_free = r.gauge(
            "serving_kv_blocks_free", "free KV blocks (paged layout)")
        self.g_cache_entries = r.gauge(
            "serving_prefix_cache_entries", "live prefix-cache entries")
        self.g_budget_util = r.gauge(
            "serving_budget_utilization",
            "prefill tokens spent this step / token budget")

    def _labels(self) -> dict:
        """Shared metric labels: several engines can feed one registry
        (the benchmark's dense/sparse x slot/paged grid), so every series
        carries both the engine name and its family."""
        return {"engine": self.name, "family": self.family}

    # ---------------------------------------------------------- time/pids
    def _ts(self, t: float | None = None) -> float:
        if self.t0 is None:
            self.t0 = self.clock() if self.clock else 0.0
        t = self.clock() if t is None else t
        return (t - self.t0) * 1e6

    # -------------------------------------------------------- step spans
    def begin_step(self, n_step: int, now: float) -> None:
        self._step_t0 = now
        self._step_n = n_step

    def end_step(self, engine, stats: dict) -> None:
        now = self.clock()
        lb = self._labels()
        self.c_steps.inc(**lb)
        self.c_prefilled.inc(stats.get("prefill_tokens", 0), **lb)
        util = (stats.get("prefill_tokens", 0)
                / max(engine.token_budget, 1))
        self.g_budget_util.set(util, **lb)
        queue_depth = len(engine.queue)
        running = len(engine.running)
        self.g_queue.set(queue_depth, **lb)
        self.g_running.set(running, **lb)
        self.g_pool_free.set(engine.pool.n_free, **lb)
        sample = {"queue_depth": queue_depth, "running": running,
                  "pool_free": engine.pool.n_free,
                  "budget_utilization": round(util, 4)}
        if "spec_drafted" in stats:
            drafted = stats["spec_drafted"]
            accepted = stats.get("spec_accepted", 0)
            self.c_spec_drafted.inc(drafted, **lb)
            self.c_spec_accepted.inc(accepted, **lb)
            self.c_spec_emitted.inc(stats.get("spec_emitted", 0), **lb)
            rate = accepted / drafted if drafted else 0.0
            self.g_spec_accept.set(rate, **lb)
            sample["spec_acceptance_rate"] = round(rate, 4)
        if engine.kv_layout == "paged":
            pool = engine.pool
            self.g_blocks_free.set(pool.blocks.n_free, **lb)
            sample["blocks_free"] = pool.blocks.n_free
            if pool.prefix_cache is not None:
                self.g_cache_entries.set(len(pool.prefix_cache), **lb)
                sample["prefix_cache_entries"] = len(pool.prefix_cache)
        ts0 = self._ts(self._step_t0)
        if self._step_n % self.sample_every == 0:
            self.buffer.counter("engine", self._ts(now), sample,
                                pid=self._pid_engine, tid=_ENGINE_TID)
        self.buffer.complete("step", ts0, self._ts(now) - ts0,
                             pid=self._pid_engine, tid=_ENGINE_TID,
                             cat="step", args=dict(stats))
        self._step_t0 = None

    def begin_phase(self, name: str, **args) -> None:
        self._phase_stack.append((name, self.clock(), args))

    def end_phase(self, **args) -> None:
        if not self._phase_stack:
            return
        name, t0, a = self._phase_stack.pop()
        if args:
            a.update(args)
        ts0 = self._ts(t0)
        self.buffer.complete(name, ts0, self._ts() - ts0,
                             pid=self._pid_engine, tid=_ENGINE_TID,
                             cat="phase", args=a or None)

    def instant(self, name: str, **args) -> None:
        self.buffer.instant(name, self._ts(), pid=self._pid_engine,
                            tid=_ENGINE_TID, cat="engine", args=args or None)

    # ----------------------------------------------------- request spans
    def _req_begin(self, req, span: str, t: float) -> None:
        self._req_open.setdefault(req.request_id, {})[span] = t

    def _req_end(self, req, span: str, t: float,
                 args: dict | None = None) -> None:
        open_spans = self._req_open.get(req.request_id, {})
        t0 = open_spans.pop(span, None)
        if t0 is None:
            return
        ts0 = self._ts(t0)
        self.buffer.complete(span, ts0, self._ts(t) - ts0,
                             pid=self._pid_requests, tid=req.request_id,
                             cat="request", args=args)

    def on_submit(self, req) -> None:
        self.buffer.set_thread_name(self._pid_requests, req.request_id,
                                    f"req {req.request_id}")
        self._req_begin(req, "queued", req.metrics.arrival)

    def on_admit(self, req, n_cached: int = 0,
                 cache_lookup: bool = False) -> None:
        t = req.metrics.admitted
        self._req_end(req, "queued", t)
        self._req_begin(req, "prefill", t)
        self._req_cached[req.request_id] = \
            self._req_cached.get(req.request_id, 0) + n_cached
        if cache_lookup:
            lb = self._labels()
            self.c_cache_lookups.inc(**lb)
            if n_cached > 0:
                self.c_cache_hits.inc(**lb)
                self.c_cache_hit_tokens.inc(n_cached, **lb)
            self.instant("prefix_cache",
                         request=req.request_id,
                         hit=n_cached > 0, cached_tokens=n_cached)

    def on_chunk(self, req, cursor: int, take: int) -> None:
        self.buffer.instant("chunk", self._ts(), pid=self._pid_requests,
                            tid=req.request_id, cat="request",
                            args={"cursor": cursor, "take": take})

    def on_prefill_complete(self, req) -> None:
        t = self.clock()
        self._req_end(req, "prefill", t,
                      args={"chunks": req.metrics.prefill_chunks,
                            "cached_tokens":
                                self._req_cached.get(req.request_id, 0)})
        self._req_begin(req, "decode", t)

    def on_preempt(self, req, reason: str) -> None:
        t = self.clock()
        self._req_end(req, "prefill", t)
        self._req_end(req, "decode", t)
        self.c_preempted.inc(reason=reason, **self._labels())
        self.buffer.instant("preempted", self._ts(t),
                            pid=self._pid_requests, tid=req.request_id,
                            cat="request", args={"reason": reason})
        self.instant("preempt", victim=req.request_id, reason=reason,
                     tokens_kept=len(req.tokens))
        self._req_begin(req, "queued", t)

    def _summary(self, req) -> None:
        m = req.metrics
        self.buffer.instant(
            "request_summary", self._ts(m.finished),
            pid=self._pid_requests, tid=req.request_id, cat="lifecycle",
            args={"id": req.request_id, "family": m.family,
                  "status": req.status.value, "admitted": m.admitted,
                  "first_token": m.first_token, "finished": m.finished,
                  "n_tokens": m.n_tokens,
                  "prefill_chunks": m.prefill_chunks,
                  "n_preemptions": m.n_preemptions,
                  "last_preempt_reason": m.last_preempt_reason,
                  "cached_tokens":
                      self._req_cached.pop(req.request_id, 0)})
        self._req_open.pop(req.request_id, None)

    def on_finish(self, req) -> None:
        t = req.metrics.finished
        self.c_decoded.inc(req.metrics.n_tokens, **self._labels())
        self.c_finished.inc(status=req.status.value, **self._labels())
        self._req_end(req, "decode", t,
                      args={"n_tokens": req.metrics.n_tokens})
        self._summary(req)

    def on_evict(self, req) -> None:
        t = req.metrics.finished
        self.c_finished.inc(status=req.status.value, **self._labels())
        self._req_end(req, "queued", t)
        self.buffer.instant("evicted", self._ts(t), pid=self._pid_requests,
                            tid=req.request_id, cat="request",
                            args={"reason": "queue_timeout"})
        self._summary(req)

    def on_withdraw(self, req) -> None:
        """A fleet router pulled this queued request out of the engine
        (work-steal or preemption drain); the destination engine's tracer
        re-opens "queued" via its own ``on_submit``, so the request's
        thread shows one queued span per engine it visited."""
        t = self.clock()
        self._req_end(req, "queued", t, args={"withdrawn": True})
        self.buffer.instant("withdrawn", self._ts(t),
                            pid=self._pid_requests, tid=req.request_id,
                            cat="request")

    # ---------------------------------------------- model-call attribution
    def jit_call(self, kind: str, fn, args):
        """Run ``fn(*args)`` timed and attributed.

        The variant key is the tuple of top-level array argument shapes
        and dtypes, as the reference keys its jitted calls.  The port has
        no jit: a new variant's first call is what the reference's compile
        was, and is counted as a compile (the kind's first variant) or a
        retrace (a later one).  The call's work comes from the adapter's
        ``step_cost`` (``launch/step_cost.py``), taken before the clock
        starts.  ``issue_s`` is the host time until ``fn`` returned; the
        wall time blocks on the card (``torch.cuda.synchronize``) before
        the second clock read, as the reference blocks on its outputs.
        """
        shapes = tuple((tuple(a.shape), str(a.dtype)) for a in args
                       if hasattr(a, "shape"))
        key = (kind, shapes)
        cost = self._cost(*args) if self._cost is not None else {}
        rec = self._variants.get(key)
        if rec is None:
            n = self._kind_counts.get(kind, 0)
            self._kind_counts[kind] = n + 1
            rec = self._variants[key] = {
                "kind": kind, "variant": f"{kind}#{n}",
                "shapes": [list(s) for s, _ in shapes],
                "calls": 0, "total_s": 0.0, "first_call_s": None,
                "issue_s": 0.0, "first_issue_s": None,
                "flops": 0, "bytes_accessed": 0}
            is_retrace = n > 0
            (self.c_retraces if is_retrace else self.c_compiles).inc(
                fn=kind, engine=self.name)
            self.instant("retrace" if is_retrace else "compile",
                         fn=kind, variant=rec["variant"],
                         flops=cost.get("flops"),
                         bytes_accessed=cost.get("bytes_accessed"))
        t0 = self.clock()
        out = fn(*args)
        t_issue = self.clock()
        if self._device is not None:
            torch.cuda.synchronize(self._device)
        t1 = self.clock()
        dt, issue = t1 - t0, t_issue - t0
        rec["calls"] += 1
        rec["total_s"] += dt
        rec["issue_s"] += issue
        if rec["first_call_s"] is None:
            rec["first_call_s"] = dt     # first use of a new shape
            rec["first_issue_s"] = issue
        if cost:
            rec["flops"] += cost["flops"]
            rec["bytes_accessed"] += cost["bytes_accessed"]
        ts0 = self._ts(t0)
        self.buffer.complete(f"jit:{kind}", ts0, self._ts(t1) - ts0,
                             pid=self._pid_engine, tid=_ENGINE_TID,
                             cat="jit", args={"variant": rec["variant"]})
        return out

    def attribution(self) -> dict:
        """Per-variant wall-clock, issue and cost table, JSON-embeddable:
        tok/s regressions decompose into compute (flops/bytes), host issue
        (issue_s), schedule (calls) and new variants (first_call_s).
        ``flops``/``bytes_accessed`` are the mean per call (a decode
        variant's attention grows with its lanes' cursors); steady means
        leave the first call out."""
        out = {}
        for rec in self._variants.values():
            calls = rec["calls"]
            steady_calls = max(calls - 1, 0)
            steady_s = rec["total_s"] - (rec["first_call_s"] or 0.0)
            steady_issue = rec["issue_s"] - (rec["first_issue_s"] or 0.0)
            out[rec["variant"]] = {
                "kind": rec["kind"], "shapes": rec["shapes"],
                "calls": calls, "total_s": rec["total_s"],
                "first_call_s": rec["first_call_s"],
                "steady_mean_s": (steady_s / steady_calls
                                  if steady_calls else None),
                "issue_s": rec["issue_s"],
                "steady_issue_mean_s": (steady_issue / steady_calls
                                        if steady_calls else None),
                "flops": (rec["flops"] / calls
                          if calls and self._cost is not None else None),
                "bytes_accessed": (rec["bytes_accessed"] / calls
                                   if calls and self._cost is not None
                                   else None),
            }
        return out

    # -------------------------------------------------------------- export
    def counters_text(self) -> str:
        return self.registry.prometheus_text()

    def write_trace(self, path: str) -> None:
        self.buffer.write(path)
