"""Out-dim tensor parallelism: the collectives the layers call over the
mesh's ``"model"`` group, and the markers that tell them a weight holds
only this rank's rows.

A ``RowShard`` stands in a parameter tree for a projection (or an
embedding table) whose out rows (vocab rows) are split over the model
axis: ``layers.linear`` runs the rank's rows through the same kernel the
whole weight would take and all-gathers the outputs along the last dim,
so every output element is the same full-length dot product the
single-device engine computes; ``layers.embed`` looks up the tokens this
rank holds, zeroes the rest, and sums over ranks (exact: one rank
contributes each row).  ``HeadShard`` takes a rank's contiguous query and
KV heads out of whole projections and gathers the attention output back
over heads.  ``ColShard`` stands for a leaf split on its last dim (a
moe layer's [E, in, out] expert stacks: ``models/moe.py`` computes the
rank's columns and gathers them), and ``StateShard`` for how a recurrent
layer's state arenas split (``models/xlstm.py``, ``models/zamba.py``
take the rank's heads or value columns and gather the recurrence's
output).  The step is plain tensors and explicit collectives: the
hand-written kernels have no DTensor rules.

Training differentiates through three collectives, each a
``torch.autograd.Function``: ``gather_blocks`` (a leaf's blocks all-gathered
whole; its backward reduce-scatters the gradient over the data shards),
``all_to_all`` (dim 0 in equal parts; its backward is the same exchange,
its own inverse) and ``all_sum`` (its backward sums the cotangents).  The
serving ``ModelAxis.gather`` stays a plain collective: nothing
differentiates through serving.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from .sharding import local_shard


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis and its process group."""
    group: Any
    size: int
    rank: int

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` summed, in place."""
        dist.all_reduce(t, group=self.group)
        return t


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's block of rows of a weight split on its first dim: a
    dense [out / size, in] tensor (or [vocab / size, d] table) or a
    ``SparseWeight`` whose buffers are co-sliced on the out dim."""
    local: Any
    axis: ModelAxis

    @property
    def device(self) -> torch.device:
        if isinstance(self.local, torch.Tensor):
            return self.local.device
        return self.local.nm_values.device


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """The attention heads of this rank when the KV heads split over the
    model axis: query heads [rank * H/size, (rank + 1) * H/size) and KV
    heads [rank * KV/size, ...).  GQA groups are contiguous (query head h
    reads KV head h // (H/KV)), so the rank's query heads read exactly its
    KV heads."""
    axis: ModelAxis
    n_heads: int
    n_kv_heads: int

    def local(self, q, k, v):
        """The rank's heads of whole [B, S, heads, hd] q, k and v."""
        hq = self.n_heads // self.axis.size
        hk = self.n_kv_heads // self.axis.size
        r = self.axis.rank
        return (q[:, :, r * hq:(r + 1) * hq].contiguous(),
                k[:, :, r * hk:(r + 1) * hk].contiguous(),
                v[:, :, r * hk:(r + 1) * hk].contiguous())

    def local_q(self, q):
        """The rank's query heads of a whole [B, S, H, hd] ``q`` (the
        enc-dec family's cross-attention, whose K/V are context rows)."""
        hq = self.n_heads // self.axis.size
        r = self.axis.rank
        return q[:, :, r * hq:(r + 1) * hq].contiguous()

    def local_kv(self, t, dim: int = 2):
        """The rank's KV heads of a whole tensor along ``dim``."""
        hk = self.n_kv_heads // self.axis.size
        return t.narrow(dim, self.axis.rank * hk, hk)

    def gather(self, attn: torch.Tensor) -> torch.Tensor:
        """[B, S, H/size, hd] on every rank -> [B, S, H, hd]."""
        return self.axis.gather(attn, dim=2)


@dataclasses.dataclass(frozen=True)
class ColShard:
    """This rank's block of a leaf split on its last dim: [E, in,
    out / size] of an [E, in, out] expert stack.  Its outputs are the
    rank's columns of every row, gathered whole by the caller."""
    local: torch.Tensor
    axis: ModelAxis

    @property
    def device(self) -> torch.device:
        return self.local.device


@dataclasses.dataclass(frozen=True)
class StateShard:
    """How one recurrent layer's state arenas split over the model axis,
    read from ``ServingPlacement.state_spec`` on the whole leaf's shape:

      * ``"heads"``: dim 1 of every leaf [slots, H, ...]; the rank runs its
        H / size heads of the recurrence and gathers the output over heads;
      * ``"dv"``: the last (value) dim of the matrix state [slots, H, dk,
        dv]; the rank runs every head on its dv / size columns of ``v``,
        the normalizer (which reads only q, k and the gates) whole, and
        gathers the output along its last dim;
      * ``"whole"``: nothing split.

    Either way every output element is computed whole by one rank: no
    partial sum crosses ranks."""
    mode: str
    axis: ModelAxis

    def _part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim] // self.axis.size
        return t.narrow(dim, self.axis.rank * n, n)

    def heads(self, t: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The rank's heads (along ``dim``) of a whole tensor in heads
        mode; ``t`` itself otherwise."""
        return self._part(t, dim) if self.mode == "heads" else t

    def cols(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's value columns (the last dim) in dv mode; ``t``
        itself otherwise."""
        return self._part(t, -1) if self.mode == "dv" else t

    def n_heads(self, n: int) -> int:
        return n // self.axis.size if self.mode == "heads" else n

    def n_cols(self, n: int) -> int:
        return n // self.axis.size if self.mode == "dv" else n

    def gather(self, y: torch.Tensor, head_dim: int = 2) -> torch.Tensor:
        """The whole output from every rank's block: over heads
        (``head_dim``) in heads mode, along the last dim in dv mode."""
        if self.mode == "heads":
            return self.axis.gather(y, dim=head_dim)
        if self.mode == "dv":
            return self.axis.gather(y, dim=-1)
        return y


# --------------------------------------------------------------------------
# differentiable collectives (training)
# --------------------------------------------------------------------------

class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks; the backward sums the
    cotangents over the same ranks (the sum's adjoint)."""
    return _AllSum.apply(t, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Part j of ``t``'s dim 0 (in equal parts, one a rank) sent to rank
    j of ``group``; part i of the result came from rank i.  Its own
    inverse, so the backward is the same exchange."""
    return _AllToAll.apply(t, group)


def all_gather_leaf(block: torch.Tensor, tm, spec: tuple,
                    shape) -> torch.Tensor:
    """The whole leaf of global ``shape`` from every rank's ``block`` under
    ``spec`` on the training mesh ``tm``; ``block`` itself when the spec
    splits nothing.  Not differentiable."""
    group, members = tm.group_for(spec)
    if group is None:
        return block
    parts = [torch.empty_like(block) for _ in members]
    dist.all_gather(parts, block.contiguous(), group=group)
    full = block.new_empty(shape)
    for coords, part in zip(members, parts):
        local_shard(full, spec, tm.sizes, coords).copy_(part)
    return full


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, tm, spec, shape):
        ctx.tm, ctx.spec = tm, spec
        full = all_gather_leaf(block, tm, spec, shape)
        return full.clone() if full is block else full

    @staticmethod
    def backward(ctx, g):
        tm, spec = ctx.tm, ctx.spec
        if tm.n_fsdp == 1:
            return (local_shard(g, spec, tm.sizes, tm.coords).contiguous(),
                    None, None, None)
        if tm.splits_fsdp(spec):
            pieces = [local_shard(g, spec, tm.sizes, c).contiguous()
                      for c in tm.fsdp_members]
            out = torch.empty_like(pieces[0])
            dist.reduce_scatter(out, pieces, group=tm.fsdp_group)
        else:
            out = local_shard(g, spec, tm.sizes, tm.coords).clone()
            dist.all_reduce(out, group=tm.fsdp_group)
        return out.div_(tm.n_fsdp), None, None, None


def gather_blocks(block: torch.Tensor, tm, spec: tuple,
                  shape) -> torch.Tensor:
    """The whole leaf of global ``shape`` from every rank's ``block``
    under ``spec`` on the training mesh ``tm`` (``fsdp.TrainMesh``).

    The ranks of one data row compute the same rows with the whole leaf,
    so the backward keeps the rank's block of the gradient summed over the
    data shards (a reduce-scatter over them when the spec splits a dim
    over fsdp, else an all-reduce) and divided by their number: the
    gradient of the global loss, which every data shard takes whole
    (``policy.global_sum``).  Nothing is summed over ``model``."""
    return _GatherBlocks.apply(block, tm, spec, tuple(shape))
