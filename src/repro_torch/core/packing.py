"""Compressed storage for N:M-sparse weights (port of ``repro/core/packing.py``).

The deployable layout, consumed by the kernels:

  values   : [out, in * N/M]       kept weight values, row-major by block
  indices  : [out, in/M, N] int32  position of each value inside its block
  packed   : [out, in/M]    int32  the same indices packed 4 bits each
                                   (valid for M <= 16, N <= 8 -> one word)
"""
from __future__ import annotations

import dataclasses

import torch

from .patterns import block_topn_indices, parse_pattern


def pack_fields(fields: torch.Tensor, bits: int) -> torch.Tensor:
    """OR ``fields[..., k] << (bits * k)`` into one int32 word per row.

    The JAX package sums the shifted fields in int32, where a top field of
    ``2**(31 - bits*k)`` or more wraps the word negative.  ``torch.sum`` of
    int32 promotes to int64, so the words are built in int64 with bitwise
    OR and wrapped to int32 explicitly: the bits are identical."""
    k = fields.shape[-1]
    shifts = bits * torch.arange(k, dtype=torch.int64, device=fields.device)
    shifted = fields.to(torch.int64) << shifts
    word = shifted[..., 0]
    for i in range(1, k):
        word = word | shifted[..., i]
    word = torch.where(word >= 2**31, word - 2**32, word)
    return word.to(torch.int32)


def unpack_fields(words: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """Inverse of ``pack_fields``: int32 ``[...]`` -> ``[..., k]`` fields."""
    shifts = bits * torch.arange(k, dtype=torch.int32, device=words.device)
    return (words[..., None] >> shifts) & ((1 << bits) - 1)


@dataclasses.dataclass
class PackedNM:
    """N:M compressed weight matrix (one linear layer, W[out, in])."""

    values: torch.Tensor     # [out, in//m * n]
    indices: torch.Tensor    # [out, in//m, n] int32 in [0, m)
    n: int
    m: int
    in_dim: int

    def packed_metadata(self) -> torch.Tensor:
        """4-bit-packed indices, one int32 word per block (m<=16, n<=8)."""
        if self.m > 16 or self.n > 8:
            raise ValueError(
                f"word packing supports m<=16,n<=8; got {self.n}:{self.m}")
        return pack_fields(self.indices, 4)


def unpack_metadata(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of PackedNM.packed_metadata: int32 word -> [.., n] indices."""
    return unpack_fields(packed, n, 4)


def pack_nm(w_pruned: torch.Tensor, mask: torch.Tensor, pattern) -> PackedNM:
    """Compress an already-pruned dense matrix given its N:M mask.  The
    mask, not the values, locates kept positions, so exact zeros among kept
    weights survive."""
    p = parse_pattern(pattern)
    out, in_dim = w_pruned.shape
    idx = block_topn_indices(mask.to(torch.float32), p.n, p.m)
    blocks = w_pruned.reshape(out, in_dim // p.m, p.m)
    values = torch.gather(blocks, -1, idx.long())
    return PackedNM(values=values.reshape(out, -1), indices=idx,
                    n=p.n, m=p.m, in_dim=in_dim)
