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
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


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
