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

With no ``meshes`` (or a list of None) the replicas share one card and
step one after another on one stream.  Every replica holds the one
``params`` dict that was passed in, with no copy and no per-replica
conversion (the counterpart of the reference's shared compile cache): the
compressed weights are held once, and each replica adds only its KV
arenas.

``meshes=`` (``launch/mesh.make_replica_meshes``: one ``DeviceMesh`` a
replica over disjoint, consecutive rank slices of the process group)
serves each replica tensor-parallel on its own slice.  One process a
rank, every rank running this set's loop on the same submissions (replay
and the CLI run the same loop everywhere); a rank belongs to exactly one
replica and builds a real ``ServingEngine(mesh=)`` for that one alone, so
the replicas step concurrently, each on its own ranks, and ``busy_s[i]``
is replica i's own host time.  Every other replica is a ``_Remote``
proxy holding no weights and no arena: it answers the router's and the
rebalance's reads (running and queued counts, queue capacity, slots,
free rows, the queue head's ``n_preempted`` and whether it can be
admitted, prefix-match lengths) from numbers gathered over one
world-wide gloo group after every fleet step and at every prefix-routed
submission, kept current through this step's routes and moves.  So every
rank computes the same routes, steals and drains from the same numbers,
and they are the one-process fleet's decisions.  A move withdraws the
request on the source slice; its leader sends the request's id, prompt,
sampling, generated tokens, log-probs, ``n_preempted`` and metrics (with
each source rank's block of a swap blob) to the destination slice, whose
ranks ``ingest`` it.  ``finished`` and ``stats()`` are gathered, so they
are whole on every rank, and the request objects ``submit`` returned take
the served request's tokens and metrics when ``finished`` is read; the
``on_token``/``on_finish`` hooks run on the serving slice's ranks.  The
fleet's clock is world rank 0's: ``shared_clock`` broadcasts it, and each
replica engine schedules on it (this rank's clock plus the offset to rank
0's, measured at every fleet step).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..engine import ServingEngine
from ..observe import NULL_ROUTER_TRACER
from ..request import Request, SamplingParams
from .router import Router

# bound on requests moved per rebalance check: keeps one badly skewed
# burst from thrashing every queue in a single step
_MAX_MOVES_PER_STEP = 8


@dataclasses.dataclass
class _Ticket:
    """A request queued on another slice, as this rank knows it."""
    request_id: int | None
    n_preempted: int = 0
    seq_len: int = 0


class _RemoteQueue:
    def __init__(self, max_size: int):
        self.max_size = max_size
        self.n = 0
        self.head: _Ticket | None = None

    def __len__(self) -> int:
        return self.n


class _RemotePool:
    def __init__(self, n_slots: int, n_free: int):
        self.n_slots = n_slots
        self.n_free = n_free


class _Remote:
    """Another slice's replica: its numbers as last gathered, kept current
    through this rank's routes and moves.  No weights, no arena."""

    def __init__(self, engine: ServingEngine):
        self.kv_layout = engine.kv_layout
        self.queue = _RemoteQueue(engine.queue.max_size)
        self.pool = _RemotePool(engine.pool.n_slots, engine.pool.n_free)
        self.running = range(0)                  # len() is what is read
        self.prefix_hints: dict[tuple, int] = {}
        # head request id -> whether this replica can admit it now
        self.admits: dict[int, bool] = {}

    @property
    def has_work(self) -> bool:
        return len(self.running) > 0 or len(self.queue) > 0

    def prefix_match_length(self, prompt) -> int:
        return self.prefix_hints[tuple(prompt)]

    def head(self) -> _Ticket | None:
        return self.queue.head

    def enqueue(self, ticket: _Ticket) -> None:
        if self.queue.n == 0:
            self.queue.head = ticket
        self.queue.n += 1

    def withdraw(self, ticket) -> bool:
        self.queue.n -= 1
        self.queue.head = None
        return True

    def steal_youngest(self) -> _Ticket | None:
        if self.queue.n == 0:
            return None
        self.queue.n -= 1
        if self.queue.n == 0:
            self.queue.head = None
        return _Ticket(None)


def _seq_len(req) -> int:
    if isinstance(req, _Ticket):
        return req.seq_len
    return len(req.prompt) + len(req.tokens)


def _map_tensors(obj, fn):
    """``obj`` (nested dicts, lists and tuples) with every tensor mapped."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


# what a moved or finished request carries between slices
_CARRIED = ("request_id", "prompt", "sampling", "tokens", "logprobs",
            "n_preempted", "metrics", "draft_k", "status", "embeds")


def _carried(req: Request, embeds: bool = True) -> dict:
    return {f: getattr(req, f) for f in _CARRIED
            if embeds or f != "embeds"}


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
        if meshes is not None and len(meshes) != n_replicas:
            raise ValueError(
                f"{len(meshes)} meshes for {n_replicas} replicas")
        if tracers is not None and len(tracers) != n_replicas:
            raise ValueError(
                f"{len(tracers)} tracers for {n_replicas} replicas")
        self._clock = clock
        self._me = None                      # this rank's replica (meshes)
        # request id -> the object ``submit`` returned here (meshes)
        self._requests: dict[int, Request] = {}
        if meshes is None or all(m is None for m in meshes):
            self.replicas = [
                ServingEngine(cfg, params,
                              tracer=tracers[i] if tracers is not None
                              else None, clock=clock, **engine_kwargs)
                for i in range(n_replicas)]
        else:
            self._join_slices(meshes)
            own = ServingEngine(
                cfg, params, mesh=meshes[self._me],
                tracer=tracers[self._me] if tracers is not None else None,
                clock=self._engine_clock, **engine_kwargs)
            self.replicas = [own if i == self._me else _Remote(own)
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
        # finishes, and its tail lands in the next replica's time.  On
        # replica meshes each entry is that slice's own time, gathered
        self.busy_s = [0.0] * n_replicas
        self.router_busy_s = 0.0

    # ------------------------------------------------- replica meshes
    def _join_slices(self, meshes) -> None:
        """This rank's replica, its place in the slice, every slice's
        leader (its first rank), the world-wide gloo group of the fleet's
        exchange, and the offset of this rank's clock to rank 0's."""
        if not all(hasattr(m, "get_coordinate") for m in meshes):
            raise TypeError("replica meshes must all be DeviceMeshes "
                            "(launch/mesh.make_replica_meshes), or all None")
        rank = dist.get_rank()
        slices = [m.mesh.flatten().tolist() for m in meshes]
        mine = [i for i, ranks in enumerate(slices) if rank in ranks]
        if not mine:
            raise ValueError(f"rank {rank} is in no replica's slice")
        self._me = mine[0]
        self._local = slices[self._me].index(rank)
        self._leaders = [ranks[0] for ranks in slices]
        self._world = dist.get_world_size()
        self._group = None if dist.get_backend() == "gloo" \
            else dist.new_group(backend="gloo")
        self._offset = 0.0
        self._offset = self.shared_clock() - self._clock()

    def _engine_clock(self) -> float:
        return self._clock() + self._offset

    @property
    def _remote(self) -> bool:
        """Whether the replicas are on disjoint rank slices."""
        return self._me is not None

    @property
    def own_replica(self) -> int | None:
        """This rank's replica on replica meshes (the only real engine in
        ``replicas``), else None."""
        return self._me

    def _gather(self, row) -> np.ndarray:
        """[world, len(row)] float64: every rank's ``row``."""
        t = torch.as_tensor(row, dtype=torch.float64)
        parts = [torch.empty_like(t) for _ in range(self._world)]
        dist.all_gather(parts, t, group=self._group)
        return torch.stack(parts).numpy()

    def _gather_objects(self, obj) -> list:
        parts = [None] * self._world
        dist.all_gather_object(parts, obj, group=self._group)
        return parts

    def _from_leaders(self, obj) -> list:
        """Each replica's leader's ``obj`` (every rank of a slice holds
        the same): one gather, the other ranks sending None."""
        parts = self._gather_objects(obj if self._local == 0 else None)
        return [parts[r] for r in self._leaders]

    def shared_clock(self) -> float:
        """The fleet's clock: world rank 0's, read on every rank (a
        broadcast on replica meshes)."""
        if not self._remote:
            return self._clock()
        t = torch.tensor([self._clock() if dist.get_rank() == 0 else 0.0],
                         dtype=torch.float64)
        dist.broadcast(t, src=0, group=self._group)
        return float(t[0])

    def probe_prefixes(self, prompts) -> None:
        """Gather every replica's prefix-match length of each prompt in one
        exchange (replica meshes under prefix routing: what ``submit``
        routes on; valid until the next step changes a prefix cache)."""
        if not self._remote or self.router.policy != "prefix":
            return
        prompts = [[int(t) for t in np.asarray(p).reshape(-1)]
                   for p in prompts]
        own = self.replicas[self._me]
        rows = self._gather([own.prefix_match_length(p) for p in prompts])
        for i, e in enumerate(self.replicas):
            if i != self._me:
                for p, n in zip(prompts, rows[self._leaders[i]]):
                    e.prefix_hints[tuple(p)] = int(n)

    def _sync(self) -> None:
        """After a fleet step: every replica's counts, queue head and busy
        time from its leader, and this rank's clock offset to rank 0's."""
        own = self.replicas[self._me]
        head = next(iter(own.queue), None)
        row = [len(own.running), len(own.queue), own.pool.n_free,
               -1 if head is None else head.request_id,
               0 if head is None else head.n_preempted,
               0 if head is None else _seq_len(head),
               head is not None and self._can_admit_now(self._me, head),
               self.busy_s[self._me], self._clock()]
        rows = self._gather(row)
        self._offset = rows[0][-1] - row[-1]
        candidates = []
        for i, e in enumerate(self.replicas):
            r = rows[self._leaders[i]]
            self.busy_s[i] = float(r[7])
            if r[3] >= 0 and r[4] > 0 and not r[6]:
                candidates.append((i, int(r[3]), int(r[5])))
            if i == self._me:
                continue
            e.running = range(int(r[0]))
            e.queue.n = int(r[1])
            e.pool.n_free = int(r[2])
            e.queue.head = None if r[3] < 0 else _Ticket(
                int(r[3]), int(r[4]), int(r[5]))
            e.admits = {} if r[3] < 0 else {int(r[3]): bool(r[6])}
            e.prefix_hints = {}
        if not candidates:
            return
        # a drain may move these heads: whether each replica can admit each
        rows = self._gather([self._admits(own, n) for _, _, n in candidates])
        for j, e in enumerate(self.replicas):
            if j != self._me:
                e.admits.update({rid: bool(a) for (_, rid, _), a in zip(
                    candidates, rows[self._leaders[j]])})

    def _transfer(self, req, src: int, dst: int):
        """Move a withdrawn request from slice ``src`` to slice ``dst``:
        the request (from the source's leader) and each source rank's
        block of its swap blob, to the destination's ranks.  Returns the
        Request to ingest on the destination's ranks, a ticket
        elsewhere."""
        payload = None
        if self._me == src:
            blob = _map_tensors(req.swap, lambda t: t.cpu())
            payload = (_carried(req) if self._local == 0 else None, blob)
        parts = self._gather_objects(payload)
        fields = parts[self._leaders[src]][0]
        if self._me != dst:
            return _Ticket(fields["request_id"], fields["n_preempted"],
                           len(fields["prompt"]) + len(fields["tokens"]))
        own = self.replicas[self._me]
        req = Request(**fields)
        req.swap = _map_tensors(
            parts[self._leaders[src] + self._local][1],
            lambda t: t.to(own.device))
        return req

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
        remotes = [e for e in self.replicas if isinstance(e, _Remote)]
        if remotes and tuple(prompt) not in remotes[0].prefix_hints:
            self.probe_prefixes([prompt])
        decision = self.router.route(prompt, session)
        rid = self._next_id
        e = self.replicas[decision.replica]
        if isinstance(e, _Remote):
            # served on another slice: the same checks its engine makes,
            # and a request object that ``finished`` completes
            prompt, sampling = self.replicas[self._me].check_request(
                prompt, sampling, embeds)
            req = Request(rid, prompt, sampling, on_token=on_token,
                          on_finish=on_finish, embeds=embeds)
            e.enqueue(_Ticket(rid, 0, len(prompt)))
        else:
            req = e.submit(prompt, sampling, on_token=on_token,
                           on_finish=on_finish, embeds=embeds,
                           request_id=rid)
        if self._remote:
            self._requests[rid] = req
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
        replica costs nothing), then rebalance queues.  On replica meshes
        this rank steps its own replica, then the fleet gathers every
        replica's numbers: a barrier, where a slice waits for the slowest
        replica's step, so it is counted in neither ``busy_s`` nor
        ``router_busy_s``."""
        stepped = 0
        for i, e in enumerate(self.replicas):
            if e.has_work:
                stepped += 1
                if isinstance(e, _Remote):
                    continue
                t0 = time.monotonic()
                e.step()
                self.busy_s[i] += time.monotonic() - t0
        if self._remote:
            self._sync()
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
    @staticmethod
    def _admits(e: ServingEngine, seq_len: int) -> bool:
        """Could engine ``e`` place a request of ``seq_len`` tokens so far
        in its next step?  Conservative: a free row, and (paged)
        obtainable blocks for the whole sequence plus the engine's decode
        lookahead."""
        if e.pool.n_free < 1:
            return False
        if e.kv_layout != "paged":
            return True
        return e.pool.can_admit(seq_len, e.lookahead_blocks)

    def _can_admit_now(self, i: int, req) -> bool:
        """Could replica i place ``req`` in its next step?  Another slice's
        replica answers from the last gather."""
        e = self.replicas[i]
        if isinstance(e, _Remote):
            return e.admits[req.request_id]
        return self._admits(e, _seq_len(req))

    def _move(self, req, src: int, dst: int, kind: str) -> None:
        if self._remote:
            req = self._transfer(req, src, dst)
        e = self.replicas[dst]
        if isinstance(e, _Remote):
            e.enqueue(req)
        else:
            e.ingest(req)
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
            head = e.head() if isinstance(e, _Remote) \
                else next(iter(e.queue), None)
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
        request id: submission order, wherever each one ran.  On replica
        meshes a gather: each is the object ``submit`` returned on this
        rank, holding the served request's tokens and metrics."""
        if not self._remote:
            out: list[Request] = []
            for e in self.replicas:
                out.extend(e.finished)
            return sorted(out, key=lambda r: r.request_id)
        own = self.replicas[self._me].finished
        served_here = {id(r) for r in own}
        out = []
        for part in self._from_leaders([_carried(r, embeds=False)
                                        for r in own]):
            for fields in part:
                req = self._requests[fields["request_id"]]
                if id(req) not in served_here:
                    for f, v in fields.items():
                        setattr(req, f, v)
                out.append(req)
        return sorted(out, key=lambda r: r.request_id)

    def clear_finished(self) -> None:
        for e in self.replicas:
            if not isinstance(e, _Remote):
                e.finished.clear()
        self._requests = {rid: r for rid, r in self._requests.items()
                          if not r.done}

    def prefix_match_length(self, prompt) -> int:
        """Best cached-prefix length across the fleet (a probe, no side
        effects): what a router one level up would see."""
        if self._remote:
            own = self.replicas[self._me].prefix_match_length(prompt)
            return int(self._gather([own])[:, 0].max())
        return max(e.prefix_match_length(prompt) for e in self.replicas)

    # ------------------------------------------------------------ counters
    def stats(self) -> dict:
        if self._remote:
            per = self._from_leaders(self.replicas[self._me].stats())
        else:
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
            if not isinstance(e, _Remote):
                e.reset_stats()
        self.router.reset_stats()
        self.n_steals = 0
        self.n_drains = 0
        self.busy_s = [0.0] * len(self.replicas)
        self.router_busy_s = 0.0
