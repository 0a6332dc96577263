"""The activation-sharding policy (port of ``repro/parallel/policy.py``).

The training driver runs every step inside ``activation_sharding(mesh)``,
as the reference's does; ``suspended()`` switches it off for the code it
wraps (the serving adapters run every model call under it).  The state is
thread-local and nests: leaving a context restores the policy it found.

In the reference ``shard(x, axes)`` is a layout constraint for GSPMD: it
changes where a value lives, never the value.  In the port a rank's layout
is explicit (``parallel/fsdp.py`` gathers each parameter, the batch is cut
by ``sharding.batch_spec``), so ``shard`` returns ``x`` unchanged.  The
policy's values are read in two places: ``models/moe.py`` takes the
expert-parallel path with capacity dispatch when a policy is active, as
the reference does, and the losses sum over the policy's data shards
(``global_sum``), which GSPMD does for the reference implicitly.

Symbolic axes: "fsdp" -> ("pod", "data") / ("data",), "model" ->
"model", None -> replicated.  ``mesh`` is a ``fsdp.TrainMesh``, a
``DeviceMesh`` or a mapping ``{axis name: size}``
(``sharding.axis_sizes``); the policy carries it, and a collective over
more than one data shard reads its group from a ``TrainMesh``
(``fsdp_group``).
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from .fsdp import TrainMesh
from .sharding import axis_sizes
from .tensor_parallel import all_sum

_STATE = threading.local()


def _current():
    return getattr(_STATE, "policy", None)


@contextlib.contextmanager
def activation_sharding(mesh, seq_shard: bool = False):
    """Enable the policy for the code run within this context."""
    sizes = mesh.sizes if isinstance(mesh, TrainMesh) else axis_sizes(mesh)
    fsdp = ("pod", "data") if "pod" in sizes else ("data",)
    prev = _current()
    _STATE.policy = {"mesh": mesh, "sizes": sizes, "fsdp": fsdp,
                     "seq_shard": seq_shard}
    try:
        yield
    finally:
        _STATE.policy = prev


@contextlib.contextmanager
def suspended():
    """Deactivate any ambient policy for the code run within this context.

    Serving must not inherit a training policy: an active policy flips MoE
    onto the capacity-bounded expert-parallel path, where bucket padding
    competes with real tokens for expert capacity and token streams stop
    being batch-invariant."""
    prev = _current()
    _STATE.policy = None
    try:
        yield
    finally:
        _STATE.policy = prev


@contextlib.contextmanager
def _restored(policy):
    prev = _current()
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev


def checkpoint_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: (the forward's
    context, the recompute's).  On the card autograd runs the backward,
    and so the recompute, in a thread of its own, which has no policy:
    the recompute re-enters the one active at the forward, so it takes
    the forward's path (a moe layer's capacity path)."""
    return contextlib.nullcontext(), _restored(_current())


def shard(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` itself: the reference's constraint to symbolic ``axes`` is a
    layout hint that changes no value, and a rank's layout is explicit in
    the port."""
    return x


def seq_sharded() -> bool:
    pol = _current()
    return bool(pol and pol["seq_shard"])


def divides(axis: str, dim: int) -> bool:
    """True if ``dim`` can shard over ``axis`` under the active policy
    (False when no policy: callers then skip layout specialization)."""
    pol = _current()
    if pol is None:
        return False
    real = pol["fsdp"] if axis == "fsdp" else (axis,)
    return dim % math.prod(pol["sizes"][a] for a in real) == 0


def n_fsdp() -> int:
    """The number of data shards under the active policy (1 with none)."""
    pol = _current()
    if pol is None:
        return 1
    return math.prod(pol["sizes"][a] for a in pol["fsdp"])


def fsdp_group():
    """The process group over the active policy's data shards (None with
    one shard).  More than one shard needs the policy's mesh to be a
    ``TrainMesh``, which holds the groups."""
    if n_fsdp() == 1:
        return None
    mesh = _current()["mesh"]
    if not isinstance(mesh, TrainMesh):
        raise TypeError("a policy over more than one data shard reduces "
                        "over a TrainMesh's group: pass "
                        "activation_sharding(TrainMesh(mesh))")
    return mesh.fsdp_group


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active policy's data shards: the sum over the
    global batch of a per-rank sum.  Differentiable (its backward sums
    the cotangents over the same ranks); ``t`` itself with one shard."""
    group = fsdp_group()
    return t if group is None else all_sum(t, group)


def global_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum(values * mask) / max(Sum(mask), 1) over the global batch: both
    sums reduced over the data shards before the division (a mean of the
    shards' means is another loss)."""
    return global_sum(torch.sum(values * mask)) \
        / global_sum(torch.sum(mask)).clamp_min(1.0)
