"""Multi-replica serving: N engines behind a prefix-aware router (port of
``repro/serving/fleet/``).

::

                         submit(prompt, session)
                                  │
                            ┌─────▼─────┐   score(i) = w_p·prefix_frac(i)
                            │  Router   │             - w_l·load(i)
                            │ (3 pols)  │             + w_a·affinity(i)
                            └─────┬─────┘
              ┌───────────────────┼───────────────────┐
        ┌─────▼─────┐       ┌─────▼─────┐       ┌─────▼─────┐
        │ Engine 0  │ steal │ Engine 1  │ drain │ Engine 2  │
        │ KV+prefix │◄─────►│ KV+prefix │◄─────►│ KV+prefix │
        └───────────┘       └───────────┘       └───────────┘
                       one card, one params dict

See ``router`` and ``replica_set`` module docstrings for the scoring,
rebalance, and token-identity contracts.
"""
from .replica_set import ReplicaSet
from .router import ROUTING_POLICIES, RouteDecision, Router

__all__ = ["ReplicaSet", "Router", "RouteDecision", "ROUTING_POLICIES"]
