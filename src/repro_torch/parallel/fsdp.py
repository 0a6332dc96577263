"""Sharded training state over a ("data", "model") or ("pod", "data",
"model") mesh: the counterpart of the reference's ``train.build``
(``jit`` with parameter and optimizer ``in_shardings`` from
``param_shardings``) and of the gathers GSPMD inserts.

Every rank stores only its block of each parameter and of each AdamW
moment, under ``sharding.param_spec`` (``param_shardings``), cut by
``sharding.local_shard``.  In the step each leaf is gathered whole over
the axes its spec splits (``tensor_parallel.gather_blocks``), the model
runs on the rank's rows of the batch, and the gather's backward leaves
the rank's block of the global gradient: summed over the data shards,
divided by their number.  AdamW then updates each block where it lies
(``optim.adamw.step(sharding=)``).

The ``model`` axis is storage here, not compute: the ranks of one data
row compute the same rows with the same whole weights.  Every leaf is
gathered when the step starts, since autograd keeps the gathered weights
for the backward in any case; gathering layer by layer, freeing after
use and re-gathering in the backward, and tensor-parallel compute in
training are speed and memory work for later.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch
import torch.distributed as dist

from ..core.pipeline import map_leaves
from ..tree import flatten, unflatten
from .sharding import (axis_sizes, fsdp_axes, local_shard, param_shardings,
                       splits)
from .tensor_parallel import all_gather_leaf, gather_blocks


class TrainMesh:
    """A training mesh (a ``DeviceMesh``) as the step uses it: the axis
    sizes, this rank's coordinates, and a process group over each set of
    axes a spec can split (the fsdp axes, ``model``, and both), with the
    coordinates of the group's members in group-rank order.  Creating
    groups is a collective call: every rank of the mesh builds its
    ``TrainMesh`` together, once (``launch/train.build`` does), and the
    state's shardings and the activation policy carry it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.fsdp = fsdp_axes(mesh)
        self.n_fsdp = math.prod(self.sizes[a] for a in self.fsdp)
        names = list(self.sizes)
        ranks = mesh.mesh
        self.coords = dict(zip(names, (ranks == dist.get_rank()).nonzero()[0]
                               .tolist()))
        self._groups = {}
        for axes in (self.fsdp, ("model",), tuple(names)):
            self._groups[frozenset(axes)] = self._build(ranks, names, axes)

    def _build(self, ranks, names, axes):
        """(my group over ``axes`` or None when it has one rank, its
        members' coordinates in group-rank order)."""
        free = [a for a in names if a in axes]
        fixed = [a for a in names if a not in axes]
        mine = None
        for rest in itertools.product(*(range(self.sizes[a]) for a in fixed)):
            base = dict(zip(fixed, rest))
            members = [{**base, **dict(zip(free, c))}
                       for c in itertools.product(
                           *(range(self.sizes[a]) for a in free))]
            if len(members) == 1:
                if all(self.coords[a] == base[a] for a in fixed):
                    mine = (None, members)
                continue
            member_ranks = [int(ranks[tuple(m[a] for a in names)])
                            for m in members]
            group = dist.new_group(member_ranks)
            if all(self.coords[a] == base[a] for a in fixed):
                order = dist.get_process_group_ranks(group)
                by_rank = dict(zip(member_ranks, members))
                mine = (group, [by_rank[r] for r in order])
        return mine

    def group_for(self, spec) -> tuple[Any, list]:
        """(the group over the axes ``spec`` splits, or None when it
        splits none; the members' coordinates)."""
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        if not used:
            return None, [self.coords]
        if used <= set(self.fsdp):
            return self._groups[frozenset(self.fsdp)]
        if used == {"model"}:
            return self._groups[frozenset(("model",))]
        return self._groups[frozenset(self.sizes)]

    def splits_fsdp(self, spec) -> bool:
        return any(e is not None and set((e,) if isinstance(e, str) else e)
                   & set(self.fsdp) for e in spec)

    @property
    def fsdp_group(self):
        return self._groups[frozenset(self.fsdp)][0]

    @property
    def fsdp_members(self) -> list[dict]:
        return self._groups[frozenset(self.fsdp)][1]

    @property
    def fsdp_index(self) -> int:
        """This rank's data shard: its place over the fsdp axes."""
        i = 0
        for a in self.fsdp:
            i = i * self.sizes[a] + self.coords[a]
        return i

    @property
    def world_group(self):
        return self._groups[frozenset(self.sizes)][0]


# --------------------------------------------------------------------------
# the state's specs and blocks
# --------------------------------------------------------------------------

def shapes_of(zoo, opt_init):
    """(params, ``opt_init(params)``) of ``zoo`` as fake tensors: the
    shapes and dtypes of the whole state, with nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = zoo.init(torch.Generator())
        return params, opt_init(params)


@dataclasses.dataclass(frozen=True)
class StateSharding:
    """The training mesh and the spec tree of a sharded tree: the port's
    counterpart of the reference's tree of ``NamedSharding``s
    (``CheckpointManager.restore(shardings=)`` takes one)."""
    tm: TrainMesh
    specs: Any
    shapes: Any          # the global shape of every leaf, as a tree


def state_sharding(tm: TrainMesh, tree) -> StateSharding:
    """``tree``'s specs under ``param_shardings`` on ``tm``'s mesh (whole
    leaves or fake tensors give the global shapes)."""
    specs = param_shardings(tm.mesh, tree)
    shapes = map_leaves(tree, lambda _, t: tuple(t.shape))
    return StateSharding(tm, specs, shapes)


def shard_tree(tree, sh: StateSharding):
    """Each whole leaf's block on this rank, as its own contiguous
    tensor."""
    tm = sh.tm
    return unflatten(tree, [
        local_shard(t, spec, tm.sizes, tm.coords).contiguous().clone()
        if splits(spec) else t
        for t, spec in zip(flatten(tree), flatten(sh.specs))])


def gather_tree(tree, sh: StateSharding):
    """Every block gathered whole (``gather_blocks``: differentiable).  A
    leaf that is neither split nor reduced over data shards is its block
    itself, with no copy."""
    tm = sh.tm
    return unflatten(tree, [
        t if tm.n_fsdp == 1 and tm.group_for(spec)[0] is None
        else gather_blocks(t, tm, spec, shape)
        for t, spec, shape in zip(flatten(tree), flatten(sh.specs),
                                  flatten(sh.shapes))])


@torch.no_grad()
def unshard_tree(tree, sh: StateSharding):
    """Every block gathered whole, outside autograd (a checkpoint's
    save, a test's comparison)."""
    tm = sh.tm
    return unflatten(tree, [
        all_gather_leaf(t, tm, spec, shape)
        for t, spec, shape in zip(flatten(tree), flatten(sh.specs),
                                  flatten(sh.shapes))])


def owns(tm: TrainMesh, spec) -> bool:
    """Whether this rank counts its block of a leaf under ``spec`` in a
    sum over the whole leaf: of the ranks holding equal blocks (those
    that differ only on axes the spec does not split), the one at
    coordinate 0 on those axes."""
    used = {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}
    return all(tm.coords[a] == 0 for a in tm.sizes if a not in used)
