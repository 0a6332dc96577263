"""N in-process serving-engine replicas behind one router (port of
``repro/serving/fleet/replica_set.py``).

``ReplicaSet`` takes the single-engine surface that trace replay and the
CLI drive (``submit`` / ``step`` / ``run`` / ``has_work`` / ``stats`` /
``finished``), so everything built on one engine runs unchanged against a
fleet.  Each replica is a full ``ServingEngine`` with its own KV pool,
prefix cache, scheduler and request queue; the set owns what must be
fleet-global:

  * **request ids**: one counter across replicas, so ids are unique in a
    shared trace and ``finished`` (sorted by id) lines up with submission
    order wherever each request ran;
  * **routing**: every ``submit`` asks the ``Router`` to score replicas
    (prefix-cache hit potential, load, session affinity);
  * **rebalance**, after each fleet step:
      - *drain/re-admit*: a PREEMPTED request stuck at the head of a
        replica whose pool cannot re-admit it moves to a replica that can
        admit it right now, instead of waiting for its evictor to retire;
      - *work-stealing*: when max-min queue depth crosses
        ``steal_threshold``, the youngest queued requests move from the
        richest to the poorest queue.

Migration is safe by construction: only QUEUED, slotless requests move
(they hold no KV and no per-engine state), and a request's token stream
depends only on (params, prompt, sampling): sampling keys derive from
(seed, tokens generated), and prefill after a preemption recomputes
prompt + generated.  So WHERE a request runs does not change WHAT it
generates at f32 (tests/test_torch_fleet.py: N replicas against one
engine and against the JAX package's fleet, with forced steals).  At bf16
on the card a request's chunks are grouped differently in a fleet and a
prefix hit reuses KV that another chunk shape wrote, so streams may part
at near-ties.

In the port the replicas share one card and step one after another on
one stream.  Every replica holds the one ``params`` dict that was passed
in, with no copy and no per-replica conversion (the counterpart of the
reference's shared compile cache): the compressed weights are held once,
and each replica adds only its KV arenas.  ``meshes=`` (a device slice
per replica, ``launch/mesh.make_replica_meshes``) waits for ROADMAP A12b;
``ServingEngine(mesh=)`` serves one engine on a mesh.
"""
from __future__ import annotations

import time

import numpy as np

from ..engine import ServingEngine, _not_ported
from ..observe import NULL_ROUTER_TRACER
from ..request import Request, SamplingParams
from .router import Router

# bound on requests moved per rebalance check: keeps one badly skewed
# burst from thrashing every queue in a single step
_MAX_MOVES_PER_STEP = 8


class ReplicaSet:
    # trace.replay passes each TraceRequest's session id to targets that
    # advertise this (single engines don't take sessions)
    accepts_session = True

    def __init__(self, cfg, params, *, n_replicas: int = 2,
                 routing: str = "prefix", meshes=None, tracers=None,
                 router_tracer=None, router_kwargs: dict | None = None,
                 steal_threshold: int = 4, clock=time.monotonic,
                 **engine_kwargs):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if meshes is not None:
            raise _not_ported("replica meshes (meshes=)", "A12b")
        if tracers is not None and len(tracers) != n_replicas:
            raise ValueError(
                f"{len(tracers)} tracers for {n_replicas} replicas")
        self._clock = clock
        self.replicas = [
            ServingEngine(cfg, params,
                          tracer=tracers[i] if tracers is not None else None,
                          clock=clock, **engine_kwargs)
            for i in range(n_replicas)]
        self.router = Router(self.replicas, routing,
                             **(router_kwargs or {}))
        self.tracer = NULL_ROUTER_TRACER if router_tracer is None \
            else router_tracer
        if self.tracer.enabled:
            self.tracer.attach(self)
        self.steal_threshold = max(int(steal_threshold), 1)
        self._next_id = 0
        self.home: dict[int, int] = {}       # request id -> replica index
        self.n_steals = 0
        self.n_drains = 0
        # per-replica busy wall time: with a card per replica the fleet's
        # makespan would be the CRITICAL PATH, max over replicas of busy
        # time plus routing/rebalance, not the sum this loop pays stepping
        # them one by one.  Host time around ``step()``, no synchronize: a
        # step that ends in a non-final chunk returns before the card
        # finishes, and its tail lands in the next replica's time
        self.busy_s = [0.0] * n_replicas
        self.router_busy_s = 0.0

    # ------------------------------------------------------------ admission
    def submit(self, prompt, sampling: SamplingParams | None = None,
               on_token=None, on_finish=None, embeds=None,
               session=None) -> Request:
        """Route and enqueue one request (an enc-dec request's ``embeds``
        go to its replica with it).  Raises QueueFull when every replica's
        queue is at capacity and ValueError when the request can never fit
        a replica's pool: the single-engine contract, so replay and the CLI
        handle admission unchanged."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        decision = self.router.route(prompt, session)
        rid = self._next_id
        req = self.replicas[decision.replica].submit(
            prompt, sampling, on_token=on_token, on_finish=on_finish,
            embeds=embeds, request_id=rid)
        self._next_id += 1
        self.home[rid] = decision.replica
        if self.tracer.enabled:
            self.tracer.on_route(rid, decision)
        return req

    # ------------------------------------------------------------ stepping
    @property
    def has_work(self) -> bool:
        return any(e.has_work for e in self.replicas)

    def step(self) -> dict:
        """One fleet iteration: step every replica that has work (an idle
        replica costs nothing), then rebalance queues."""
        stepped = 0
        for i, e in enumerate(self.replicas):
            if e.has_work:
                t0 = time.monotonic()
                e.step()
                self.busy_s[i] += time.monotonic() - t0
                stepped += 1
        t0 = time.monotonic()
        moved = self._rebalance()
        self.router_busy_s += time.monotonic() - t0
        return {"stepped": stepped, "moved": moved}

    def run(self, max_steps: int | None = None) -> list[Request]:
        steps = 0
        while self.has_work and (max_steps is None or steps < max_steps):
            self.step()
            steps += 1
        return self.finished

    # ----------------------------------------------------------- rebalance
    def _can_admit_now(self, i: int, req: Request) -> bool:
        """Could replica i place ``req`` in its next step?  Conservative: a
        free row, and (paged) obtainable blocks for the whole
        sequence-so-far plus the engine's decode lookahead."""
        e = self.replicas[i]
        if e.pool.n_free < 1:
            return False
        if e.kv_layout != "paged":
            return True
        seq_len = len(req.prompt) + len(req.tokens)
        return e.pool.can_admit(seq_len, e.lookahead_blocks)

    def _move(self, req: Request, src: int, dst: int, kind: str) -> None:
        self.replicas[dst].ingest(req)
        self.home[req.request_id] = dst
        if kind == "steal":
            self.n_steals += 1
        else:
            self.n_drains += 1
        if self.tracer.enabled:
            self.tracer.on_reroute(req.request_id, kind, src, dst)

    def _rebalance(self) -> int:
        moved = 0
        n = len(self.replicas)
        if n < 2:
            return 0

        # drain/re-admit: a preempted request parked at the head of a
        # replica that cannot re-admit it is blocked on ITS OWN victim's
        # memory; any replica with room now serves it sooner (and FIFO is
        # kept where it matters: the head was going nowhere)
        for i, e in enumerate(self.replicas):
            head = next(iter(e.queue), None)
            if head is None or head.n_preempted == 0 \
                    or self._can_admit_now(i, head):
                continue
            for j in sorted(range(n),
                            key=lambda j: (self.router.load(j), j)):
                if j == i or not self.router._admissible(j) \
                        or not self._can_admit_now(j, head):
                    continue
                if e.withdraw(head):
                    self._move(head, i, j, "drain")
                    moved += 1
                break

        # work-stealing: level queue depths when the spread crosses the
        # threshold, moving youngest-queued requests rich -> poor
        depths = [len(e.queue) for e in self.replicas]
        if self.tracer.enabled:
            self.tracer.on_imbalance(max(depths) - min(depths))
        while moved < _MAX_MOVES_PER_STEP:
            rich = max(range(n), key=lambda i: (depths[i], -i))
            poor = min(range(n), key=lambda i: (depths[i], i))
            if depths[rich] - depths[poor] <= self.steal_threshold:
                break
            if depths[poor] >= self.replicas[poor].queue.max_size:
                break
            req = self.replicas[rich].steal_youngest()
            if req is None:
                break
            self._move(req, rich, poor, "steal")
            depths[rich] -= 1
            depths[poor] += 1
            moved += 1
        return moved

    # ------------------------------------------------------------- results
    @property
    def finished(self) -> list[Request]:
        """All retired requests fleet-wide, sorted by (globally unique)
        request id: submission order, wherever each one ran."""
        out: list[Request] = []
        for e in self.replicas:
            out.extend(e.finished)
        return sorted(out, key=lambda r: r.request_id)

    def clear_finished(self) -> None:
        for e in self.replicas:
            e.finished.clear()

    def prefix_match_length(self, prompt) -> int:
        """Best cached-prefix length across the fleet (a probe, no side
        effects): what a router one level up would see."""
        return max(e.prefix_match_length(prompt) for e in self.replicas)

    # ------------------------------------------------------------ counters
    def stats(self) -> dict:
        per = [e.stats() for e in self.replicas]
        agg = {"lookups": 0, "hits": 0, "hit_tokens": 0, "probes": 0}
        for p in per:
            pc = p.get("pool", {}).get("prefix_cache")
            if pc:
                for k in agg:
                    agg[k] += pc.get(k, 0)
        agg["hit_rate"] = agg["hits"] / agg["lookups"] if agg["lookups"] \
            else 0.0
        return {"n_replicas": len(self.replicas),
                "routing": self.router.policy,
                "n_steps": max((p["n_steps"] for p in per), default=0),
                "n_steals": self.n_steals,
                "n_drains": self.n_drains,
                "busy_s": list(self.busy_s),
                "critical_path_s": max(self.busy_s) + self.router_busy_s,
                "router_busy_s": self.router_busy_s,
                "router": self.router.stats(),
                "prefix_cache": agg,
                "replicas": per}

    def reset_stats(self) -> None:
        for e in self.replicas:
            e.reset_stats()
        self.router.reset_stats()
        self.n_steals = 0
        self.n_drains = 0
        self.busy_s = [0.0] * len(self.replicas)
        self.router_busy_s = 0.0
