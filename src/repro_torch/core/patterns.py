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
import math

import torch

# Patterns the paper evaluates for the main weights and for salient weights.
WEIGHT_PATTERNS = ((2, 4), (4, 8), (8, 16), (16, 32))
OUTLIER_PATTERNS = ((4, 256), (8, 256), (16, 256))


@dataclasses.dataclass(frozen=True)
class Pattern:
    """An N:M sparsity pattern with its metadata accounting."""

    n: int
    m: int

    def __post_init__(self):
        if not (0 < self.n <= self.m):
            raise ValueError(f"invalid pattern {self.n}:{self.m}")

    @property
    def density(self) -> float:
        return self.n / self.m

    @property
    def configurations(self) -> int:
        """Number of distinct block layouts, C(M, N) (paper Table 1)."""
        return math.comb(self.m, self.n)

    def bits_per_element(self, pack_blocks: int = 1,
                         word_align: bool = False) -> float:
        """Metadata bits per element by enumerative coding of the block
        layout: ``ceil(log2 C(M,N) * pack_blocks) / (M * pack_blocks)``,
        rounded up to a 32-bit word with ``word_align``."""
        bits = math.ceil(math.log2(self.configurations) * pack_blocks)
        if word_align:
            bits = 32 * math.ceil(bits / 32)
        return bits / (self.m * pack_blocks)

    def paper_bits_per_element(self) -> float:
        """The Table 1 accounting: two blocks share a code at 4:8, a
        word-aligned bitmap at 16:32."""
        if (self.n, self.m) == (4, 8):
            return self.bits_per_element(pack_blocks=2)
        if (self.n, self.m) == (16, 32):
            return self.bits_per_element(word_align=True)
        return self.bits_per_element()

    def __str__(self) -> str:
        return f"{self.n}:{self.m}"



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


def mask_sparsity(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of zeros."""
    return 1.0 - mask.to(torch.float32).mean()


def validate_nm_mask(mask: torch.Tensor, pattern) -> bool:
    """True iff every M-block holds exactly N kept entries."""
    p = parse_pattern(pattern)
    _check_blockable(mask.shape[-1], p.m)
    blocks = mask.reshape(*mask.shape[:-1], -1, p.m)
    return bool((blocks.sum(-1) == p.n).all())


def block_topn_indices(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Per-block indices (ascending) of the kept elements: int32
    ``[..., in_dim//m, n]`` with values in [0, m) — the compressed metadata
    layout the kernels and the packing utilities use."""
    order = _descending_order(scores, m)
    return torch.sort(order[..., :n], dim=-1).values.to(torch.int32)
