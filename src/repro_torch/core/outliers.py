"""Salient-weight ("outlier") extraction, structured and unstructured (port
of ``repro/core/outliers.py``), plus the 8-bit outlier metadata packing the
JAX package keeps in ``repro/kernels/outlier_spmm.py``.

The most important weights of each 256-wide input block of a row are kept
exactly, in an N:256 pattern (4, 8 or 16 per block).  The unstructured
baseline (a global top-k at the same budget) is the paper's Table 7
comparison.
"""
from __future__ import annotations

import dataclasses

import torch

from .packing import pack_fields, scatter_blocks, unpack_fields
from .patterns import block_topn_indices, parse_pattern, topn_block_mask

OUTLIER_M = 256


@dataclasses.dataclass
class StructuredOutliers:
    """values : [out, n_blocks, n] exact salient values
    indices: [out, n_blocks, n] int32 position inside the 256-wide block
    (ascending); block b of row o covers input columns [b*m, (b+1)*m)."""

    values: torch.Tensor
    indices: torch.Tensor
    n: int
    m: int

    @property
    def out_dim(self) -> int:
        return self.values.shape[0]

    @property
    def in_dim(self) -> int:
        return self.values.shape[1] * self.m

    def to_dense(self) -> torch.Tensor:
        """Scatter back to a dense [out, in] matrix (zeros elsewhere)."""
        return scatter_blocks(self.values, self.indices, self.m)

    def mask(self) -> torch.Tensor:
        """Boolean [out, in] mask of salient positions."""
        out, nb, _ = self.indices.shape
        mask = torch.zeros((out, nb, self.m), dtype=torch.bool,
                           device=self.indices.device)
        mask.scatter_(-1, self.indices.long(), True)
        return mask.reshape(out, nb * self.m)


def extract_structured_outliers(w: torch.Tensor, scores: torch.Tensor,
                                pattern) -> StructuredOutliers:
    """Keep the top-N scores per 256-block of each row as exact values."""
    p = parse_pattern(pattern)
    idx = block_topn_indices(scores, p.n, p.m)               # [out, nb, n]
    out, nb, _ = idx.shape
    values = torch.gather(w.reshape(out, nb, p.m), -1, idx.long())
    return StructuredOutliers(values=values, indices=idx, n=p.n, m=p.m)


def unstructured_outlier_mask(scores: torch.Tensor,
                              budget_fraction: float) -> torch.Tensor:
    """Global top-k mask at a matched budget (the Table 7 baseline): every
    score at least the k-th largest, ties at the threshold included, as in
    the JAX package."""
    k = max(1, int(round(budget_fraction * scores.numel())))
    flat = scores.reshape(-1)
    thresh = torch.topk(flat, k, sorted=False).values.min()
    return scores >= thresh


def structured_outlier_mask(scores: torch.Tensor, pattern) -> torch.Tensor:
    p = parse_pattern(pattern)
    return topn_block_mask(scores, p.n, p.m)


def pack_outlier_meta(indices: torch.Tensor) -> torch.Tensor:
    """[out, nb, n] int32 (0..255) -> [out, nb, n//4] int32, 8 bits each."""
    out, nb, n = indices.shape
    if n % 4:
        raise ValueError(f"outlier count {n} is not a multiple of 4")
    return pack_fields(indices.reshape(out, nb, n // 4, 4), 8)


def unpack_outlier_meta(meta: torch.Tensor, n: int) -> torch.Tensor:
    """[out, nb, n//4] int32 -> [out, nb, n] int32."""
    return unpack_fields(meta, 4, 8).reshape(*meta.shape[:-1], n)
