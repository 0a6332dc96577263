"""Per-request block tables: the logical-to-physical page map (copy of
``repro/serving/paged/block_table.py``, pure host code).

A request's KV sequence position ``p`` lives in physical block
``blocks[p // block_size]`` at in-block offset ``p % block_size`` — the
paged-attention gather reconstructs the contiguous view from exactly this
mapping, so the table is the single source of truth for where a request's
tokens are.
"""
from __future__ import annotations

import dataclasses


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """Physical blocks required to hold ``n_tokens`` KV entries."""
    return -(-n_tokens // block_size) if n_tokens > 0 else 0


@dataclasses.dataclass
class BlockTable:
    block_size: int
    blocks: list[int] = dataclasses.field(default_factory=list)
    # how many leading tokens were satisfied from the prefix cache (the
    # request's prefill skipped computing them)
    n_cached_tokens: int = 0

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def capacity(self) -> int:
        """Token positions the mapped blocks can hold."""
        return len(self.blocks) * self.block_size

    def append_block(self, block: int) -> None:
        self.blocks.append(block)

    def replace_block(self, index: int, block: int) -> None:
        self.blocks[index] = block
