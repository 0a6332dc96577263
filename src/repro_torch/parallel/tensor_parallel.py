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
over heads.  The step is plain tensors and explicit collectives: the
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

    def gather(self, attn: torch.Tensor) -> torch.Tensor:
        """[B, S, H/size, hd] on every rank -> [B, S, H, hd]."""
        return self.axis.gather(attn, dim=2)
