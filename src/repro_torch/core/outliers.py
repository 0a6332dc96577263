"""Structured salient-weight ("outlier") extraction (port of
``repro/core/outliers.py``), plus the 8-bit outlier metadata packing the JAX
package keeps in ``repro/kernels/outlier_spmm.py``.

The most important weights of each 256-wide input block of a row are kept
exactly, in an N:256 pattern (4, 8 or 16 per block).
"""
from __future__ import annotations

import dataclasses

import torch

from .packing import pack_fields, unpack_fields
from .patterns import block_topn_indices, parse_pattern

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


def pack_outlier_meta(indices: torch.Tensor) -> torch.Tensor:
    """[out, nb, n] int32 (0..255) -> [out, nb, n//4] int32, 8 bits each."""
    out, nb, n = indices.shape
    if n % 4:
        raise ValueError(f"outlier count {n} is not a multiple of 4")
    return pack_fields(indices.reshape(out, nb, n // 4, 4), 8)


def unpack_outlier_meta(meta: torch.Tensor, n: int) -> torch.Tensor:
    """[out, nb, n//4] int32 -> [out, nb, n] int32."""
    return unpack_fields(meta, 4, 8).reshape(*meta.shape[:-1], n)
