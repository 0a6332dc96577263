"""N:M semi-structured sparsity patterns (port of ``repro/core/patterns.py``).

An (N, M) pattern keeps the N highest-importance elements out of every
contiguous block of M elements along the input (last) dimension of a weight
``W[out, in]``.

Selection breaks ties toward the lower index, as ``jax.lax.top_k`` and the
JAX package's stable argsort do.  ``torch.topk`` promises no order among
equal scores, and bf16 magnitudes tie often inside a 16-block, so both
functions here rank with a stable descending sort instead.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Pattern:
    n: int
    m: int

    def __post_init__(self):
        if not (0 < self.n <= self.m):
            raise ValueError(f"invalid pattern {self.n}:{self.m}")



def parse_pattern(spec) -> Pattern:
    """Accept 'N:M' strings, (N, M) tuples, or Pattern instances."""
    if isinstance(spec, Pattern):
        return spec
    if isinstance(spec, str):
        n, m = spec.split(":")
        return Pattern(int(n), int(m))
    n, m = spec
    return Pattern(int(n), int(m))


def _check_blockable(width: int, m: int) -> None:
    if width % m:
        raise ValueError(f"last dim {width} not divisible by block size {m}")


def _descending_order(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Per-block positions in descending score order, ties to lower index."""
    _check_blockable(scores.shape[-1], m)
    blocks = scores.reshape(*scores.shape[:-1], scores.shape[-1] // m, m)
    return torch.sort(blocks, dim=-1, descending=True, stable=True).indices


def topn_block_mask(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Boolean mask keeping the top-``n`` scores in every block of ``m``."""
    order = _descending_order(scores, m)
    mask = torch.zeros(order.shape, dtype=torch.bool, device=scores.device)
    mask.scatter_(-1, order[..., :n], True)
    return mask.reshape(scores.shape)


def nm_mask(scores: torch.Tensor, pattern) -> torch.Tensor:
    p = parse_pattern(pattern)
    return topn_block_mask(scores, p.n, p.m)


def block_topn_indices(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Per-block indices (ascending) of the kept elements: int32
    ``[..., in_dim//m, n]`` with values in [0, m) — the compressed metadata
    layout the kernels and the packing utilities use."""
    order = _descending_order(scores, m)
    return torch.sort(order[..., :n], dim=-1).values.to(torch.int32)
