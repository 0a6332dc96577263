"""Request routing across serving-engine replicas (port of
``repro/serving/fleet/router.py``; host code, the same decisions as the
reference on the same replica states).

One ``Router`` scores every incoming request against every replica and
picks where it runs.  The score combines the three signals that matter
for a prefix-cached continuous-batching fleet:

  score(i) = w_prefix   * prefix_frac(i)        cached-prompt fraction,
                                                via the side-effect-free
                                                ``prefix_match_length``
           - w_load     * load(i)               occupancy + queue depth,
                                                normalized by capacity
           + w_affinity * [session sticky to i] last replica this session
                                                was routed to

``prefix_frac(i)`` is ``match_length(prompt) / len(prompt)`` probed
against replica i's hash-chained prefix cache — host-side dict walks, no
refcounts, no LRU disturbance (see ``PrefixCache.match_length``), so
probing all N replicas per request costs microseconds.  The prefix term
is what concentrates each tenant's shared system prompt on one replica
(N small caches behave like one big cache instead of N thrashing
copies); the load term keeps a hot tenant from melting its home replica;
session affinity breaks ties toward cache locality before the first
block is ever cached.

Three policies share the machinery — ``prefix`` (the full score),
``least_loaded`` (load term only), ``round_robin`` (cycling baseline) —
so benchmarks compare them on identical workloads.  Replicas whose
admission queue is full are never candidates; when every queue is full
the router raises ``QueueFull``, same contract as a single engine.

Scoring is deterministic (ties break toward the less-loaded, then
lower-indexed replica) — with a seeded trace, a fleet run is exactly
reproducible.
"""
from __future__ import annotations

import dataclasses

from ..scheduler import QueueFull

ROUTING_POLICIES = ("prefix", "round_robin", "least_loaded")


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One routing decision, carrying enough to audit it later: which
    replica won, under which policy, which score component decided it
    ("prefix" / "affinity" / "load" / "round_robin"), how much of the
    prompt that replica already had cached, and every replica's load at
    decision time."""
    replica: int
    policy: str
    picked_by: str
    score: float
    prefix_frac: float
    prefix_tokens: int
    loads: tuple


class Router:
    def __init__(self, replicas, policy: str = "prefix", *,
                 w_prefix: float = 2.0, w_load: float = 1.0,
                 w_affinity: float = 0.25):
        if policy not in ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r}; "
                f"choose from {ROUTING_POLICIES}")
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("Router needs at least one replica")
        self.policy = policy
        self.w_prefix = w_prefix
        self.w_load = w_load
        self.w_affinity = w_affinity
        self._rr_next = 0
        # session -> replica index of the most recent routing decision
        self.affinity: dict = {}
        self.n_decisions = 0
        self.decisions_by: dict[str, int] = {}
        self.prefix_tokens_routed = 0

    # ------------------------------------------------------------ signals
    def load(self, i: int) -> float:
        """Replica load: requests holding or waiting for a slot, per slot
        of compute.  1.0 = exactly full, 2.0 = a full batch is queued
        behind the running one.  Normalizing by SLOTS (not slots+queue
        room) keeps the signal proportional to waiting time, so a deep
        queue actually outweighs ``w_prefix`` — with a near-zero load
        term, prefix affinity piles every tenant onto the first replica
        that caches it and the fleet serializes."""
        e = self.replicas[i]
        return (len(e.running) + len(e.queue)) / max(e.pool.n_slots, 1)

    def _admissible(self, i: int) -> bool:
        e = self.replicas[i]
        return len(e.queue) < e.queue.max_size

    # ------------------------------------------------------------ routing
    def route(self, prompt, session=None) -> RouteDecision:
        """Pick a replica for ``prompt``; raises QueueFull when every
        replica's queue is at capacity.  ``session`` is an opaque
        hashable id; consecutive requests of one session prefer each
        other's replica (and the affinity map is updated to the winner,
        whatever policy chose it)."""
        n = len(self.replicas)
        candidates = [i for i in range(n) if self._admissible(i)]
        if not candidates:
            raise QueueFull("every replica's queue is at capacity")
        loads = tuple(self.load(i) for i in range(n))

        if self.policy == "round_robin":
            pick = next(i for off in range(n)
                        for i in [(self._rr_next + off) % n]
                        if i in candidates)
            self._rr_next = (pick + 1) % n
            decision = RouteDecision(pick, self.policy, "round_robin",
                                     0.0, 0.0, 0, loads)
        elif self.policy == "least_loaded":
            pick = min(candidates, key=lambda i: (loads[i], i))
            decision = RouteDecision(pick, self.policy, "load",
                                     -loads[pick], 0.0, 0, loads)
        else:                                       # prefix (full score)
            prompt = list(prompt)
            toks = {i: self.replicas[i].prefix_match_length(prompt)
                    for i in candidates}
            home = self.affinity.get(session) if session is not None \
                else None
            scores = {
                i: (self.w_prefix * toks[i] / max(len(prompt), 1)
                    - self.w_load * loads[i]
                    + (self.w_affinity if i == home else 0.0))
                for i in candidates}
            pick = max(candidates,
                       key=lambda i: (scores[i], -loads[i], -i))
            picked_by = ("prefix" if toks[pick] > 0
                         else "affinity" if pick == home else "load")
            decision = RouteDecision(
                pick, self.policy, picked_by, scores[pick],
                toks[pick] / max(len(prompt), 1), toks[pick], loads)

        if session is not None:
            self.affinity[session] = decision.replica
        self.n_decisions += 1
        self.decisions_by[decision.picked_by] = \
            self.decisions_by.get(decision.picked_by, 0) + 1
        self.prefix_tokens_routed += decision.prefix_tokens
        return decision

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"policy": self.policy,
                "weights": {"prefix": self.w_prefix, "load": self.w_load,
                            "affinity": self.w_affinity},
                "n_decisions": self.n_decisions,
                "decisions_by": dict(self.decisions_by),
                "prefix_tokens_routed": self.prefix_tokens_routed,
                "sessions": len(self.affinity)}

    def reset_stats(self) -> None:
        """Zero decision counters; affinity and round-robin state persist
        (they are routing state, not measurement)."""
        self.n_decisions = 0
        self.decisions_by = {}
        self.prefix_tokens_routed = 0
