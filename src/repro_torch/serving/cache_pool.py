"""The slot KV layout and the view the unified attention primitive consumes
(port of ``repro/serving/cache_pool.py``).

``SlotKVPool`` allocates k/v arenas [L, n_slots, max_len, KV, hd] once at
engine start; a request holds one slot for its lifetime.  With
``kv_dtype="int8"`` the arenas are int8 and two f32 scale arenas
[L, n_slots, max_len, KV] (one scale per position and KV head, initialised
to 1) ride beside them: every write quantizes the fresh KV per position
(``quantize_kv``) and scatters values and scales with the same indices.

Every KV write happens inside ``models/transformer.unified_step``: the
engine hands it a ``SlotPoolView`` (arena + lane->slot rows + cursors) and
each layer scatters its fresh KV at the cursor and attends in place, with
the cursor as a length mask.

Freed slots are reusable at once, and rows mid-prefill share the fused
decode step with decoding rows: every position a request's attention can
see ([0, pos)) is written by its own prefill chunk or decode before it
becomes visible, and any position >= pos is overwritten (by the next
chunk's scatter, or decode's write-before-attend) before any query reads
it.  So neither zeroing on release nor masking the batch-wide decode write
is needed.

The port updates the arenas in place (PyTorch has no donation to stand in
for): ``unified_step`` returns the same tensors it was given.  Positions
live on the host (numpy).  A chunk's view (``build``) works out its scatter
indices on the host once per step, so no layer waits on the device to learn
which (lane, position) pairs are real.  The fused decode's view
(``decode``) computes them on the device at a fixed shape from [B] cursor
and ``n_new`` tensors, as the reference's ``_flat_write_idx`` does, so the
decode call can be captured once and replayed
(``serving/families.CapturedStep``).  The reference drops an invalid
pair's write past the arena; the port's arena has no row past it, so an
invalid pair writes back what the arena holds inside its own lane's row.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

# quantize_kv(fresh [..., KV, hd]) -> (int8 values, f32 scales [..., KV]):
# symmetric per position and KV head, the bytes of the JAX package's
# quantize_kv (an all-zero row gets scale 1)
from ..kernels.ref import quantize_int8 as quantize_kv


class CachePoolError(RuntimeError):
    """Cache-pool invariant violation (an engine bug, not workload
    pressure)."""


class DoubleFree(CachePoolError):
    """A slot was released twice."""


class CapacityError(CachePoolError):
    """A write or admission exceeded what the pool can physically hold."""


KV_DTYPES = ("bf16", "int8")


def arena_nbytes(*arrays) -> int:
    return sum(a.numel() * a.element_size() for a in arrays if a is not None)


def _scatter_rows(arena: torch.Tensor, dst: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """``arena`` viewed as [n_positions, ...] gets ``rows`` at the flat
    positions ``dst``, in place; works for value arenas [.., KV, hd] and
    scale arenas [.., KV] alike."""
    flat = arena.view(-1, *arena.shape[2:])
    flat.index_copy_(0, dst, rows.to(arena.dtype))


class ArenaWrites:
    """The KV writes of a pool view with ``write_src``/``write_dst``: the
    flat indices of the step's written (lane, i) pairs in its [B*S] fresh
    KV (None: every pair, in order) and in one layer's arena viewed as
    [n_positions, ...] (slot rows or paged blocks alike).  A host-built
    view lists only the real (lane, i < n_new) pairs.  A fixed-shape view
    writes every pair, and marks the real ones in ``write_keep`` [B*S]:
    every other pair writes back what the arena holds at its
    ``write_dst`` (inside its lane's own slot row, or in the paged trash
    block), so it changes no byte."""
    write_keep = None

    def _real_pairs(self, fresh):
        rows = fresh.reshape(-1, *fresh.shape[2:])
        if self.write_src is None:
            return rows
        return rows.index_select(0, self.write_src)

    def _scatter(self, arena, rows):
        if self.write_keep is not None:
            flat = arena.view(-1, *arena.shape[2:])
            keep = self.write_keep.view(-1, *([1] * (rows.dim() - 1)))
            rows = torch.where(keep, rows.to(arena.dtype),
                               flat.index_select(0, self.write_dst))
        _scatter_rows(arena, self.write_dst, rows)

    def write_layer(self, k_l, v_l, fresh_k, fresh_v):
        """Scatter fresh [B, S, KV, hd] KV into one layer's arena slice at
        each lane's cursor, in place."""
        for arena, fresh in ((k_l, fresh_k), (v_l, fresh_v)):
            self._scatter(arena, self._real_pairs(fresh))
        return k_l, v_l

    def write_layer_quantized(self, k_l, v_l, ks_l, vs_l, fresh_k, fresh_v):
        """Quantize-on-scatter: the real pairs are quantized per position
        (``quantize_kv``) and their int8 values and f32 scales written at
        the same positions, in place.  Quantization is per position, so
        every written position holds the bytes the JAX package's
        ``write_layer_quantized`` writes there."""
        for arena, scales, fresh in ((k_l, ks_l, fresh_k),
                                     (v_l, vs_l, fresh_v)):
            q, s = quantize_kv(self._real_pairs(fresh))
            self._scatter(arena, q)
            self._scatter(scales, s)
        return k_l, v_l, ks_l, vs_l


@runtime_checkable
class KVCachePool(Protocol):
    """What the engine requires of a KV layout: ``SlotKVPool`` here, and
    ``paged.PagedKVPool`` (serving/paged/pool.py)."""
    n_slots: int

    @property
    def n_free(self) -> int: ...

    @property
    def max_request_tokens(self) -> int: ...

    def release(self, slot: int) -> None: ...

    def advance_prefill(self, rows: list[int], ends: list[int]) -> None: ...

    def advance_decode(self, active_mask) -> None: ...


@dataclasses.dataclass(frozen=True)
class SlotPoolView(ArenaWrites):
    """What ``transformer.attend_over_pool`` sees of a slot pool.

    ``k``/``v`` are the [L, n_slots, max_len, KV, hd] arenas; inside the
    layer loop the transformer passes one layer's slice.  ``rows`` [B] maps
    each batch lane to its slot (padding lanes point at n_slots; None means
    lane i == slot i, the fused decode); ``cursor`` [B] counts tokens
    already written per lane.  ``write_src``/``write_dst`` are the flat
    indices of the real (lane, i < n_new) pairs in the step's [B*S] fresh
    KV and in the [n_slots*max_len] arena: what the JAX package's
    ``_flat_write_idx`` routes, minus the pairs its scatter drops
    (padding, past the arena).  ``k_scale``/``v_scale``
    ([L, n_slots, max_len, KV] f32, or None for bf16 arenas) are an int8
    arena's scales, sliced per layer like ``k``/``v`` and written with the
    same indices.  ``decode``'s view writes every lane (``write_src``
    None) and keeps an invalid lane's bytes (``write_keep``)."""
    k: Any
    v: Any
    rows: torch.Tensor | None
    cursor: torch.Tensor
    write_src: torch.Tensor | None
    write_dst: torch.Tensor
    k_scale: Any | None = None
    v_scale: Any | None = None
    write_keep: torch.Tensor | None = None

    @classmethod
    def build(cls, k, v, rows, cursor, n_new, S: int, *, k_scale=None,
              v_scale=None) -> "SlotPoolView":
        """A view for S fresh positions per lane from host arrays ``rows``
        (or None), ``cursor`` and ``n_new``."""
        ns, ml = k.shape[1], k.shape[2]
        cursor = np.asarray(cursor, np.int64)
        n_new = np.asarray(n_new, np.int64)
        lane_rows = (np.arange(len(cursor)) if rows is None
                     else np.asarray(rows, np.int64))
        p = cursor[:, None] + np.arange(S)[None]                  # [B,S]
        valid = ((np.arange(S)[None] < n_new[:, None]) & (p < ml)
                 & (lane_rows[:, None] < ns))
        src = np.flatnonzero(valid)
        dst = (lane_rows[:, None] * ml + p).reshape(-1)[src]
        dev = k.device

        def up(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)
        return cls(k=k, v=v, rows=None if rows is None else up(lane_rows),
                   cursor=up(cursor), write_src=up(src),
                   write_dst=up(dst), k_scale=k_scale, v_scale=v_scale)

    @classmethod
    def decode(cls, k, v, cursor: torch.Tensor, n_new: torch.Tensor, *,
               k_scale=None, v_scale=None) -> "SlotPoolView":
        """The fused decode's view (lane i == slot i, one fresh position a
        lane) from device tensors ``cursor`` and ``n_new`` [B], its write
        indices computed on the device at a fixed shape by the reference's
        ``_flat_write_idx`` rule: valid = 0 < n_new and cursor < max_len.
        An invalid lane's index is clamped inside its own row and writes
        back what is there, so the arena ends as ``build``'s view leaves
        it."""
        ml = k.shape[2]
        lanes = torch.arange(cursor.shape[0], device=cursor.device)
        dst = lanes * ml + cursor.clamp(0, ml - 1)
        return cls(k=k, v=v, rows=None, cursor=cursor, write_src=None,
                   write_dst=dst, k_scale=k_scale, v_scale=v_scale,
                   write_keep=(n_new > 0) & (cursor < ml))

    @property
    def block_tables(self):
        return None                       # duck-type marker: slot layout

    def lane_kv(self, k_l, v_l):
        """Per-lane [B, max_len, KV, hd] arena rows for attention.  Padding
        lanes' rows are clamped into the arena, as the JAX gather clamps;
        their outputs are never read."""
        if self.rows is None:
            return k_l, v_l
        rows = self.rows.clamp(max=k_l.shape[0] - 1)
        return k_l[rows], v_l[rows]


def kv_arenas(shape: tuple, kv_dtype: str, dtype: torch.dtype, device,
              placement=None):
    """Zeroed k/v arenas of ``shape`` and, for int8, their f32 scale arenas
    (``shape`` without the head dim, initialised to 1, so an unwritten
    position dequantizes to finite zeros); (k, v, k_scale, v_scale).  A
    mesh ``placement`` keeps this rank's KV heads of each
    (``place_kv``/``place_kv_scale``)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"not {kv_dtype!r}")
    arena_dtype = torch.int8 if kv_dtype == "int8" else dtype
    k = torch.zeros(shape, dtype=arena_dtype, device=device)
    v = torch.zeros(shape, dtype=arena_dtype, device=device)
    if placement is not None:
        k, v = placement.place_kv(k), placement.place_kv(v)
    if kv_dtype != "int8":
        return k, v, None, None
    ks = torch.ones(shape[:-1], dtype=torch.float32, device=device)
    vs = torch.ones(shape[:-1], dtype=torch.float32, device=device)
    if placement is not None:
        ks, vs = placement.place_kv_scale(ks), placement.place_kv_scale(vs)
    return k, v, ks, vs


class SlotKVPool:
    """One slot a request.  On a mesh (``placement``) the arenas hold this
    rank's KV heads; ``stats`` reports the whole arena's bytes, as the JAX
    package's global arrays do."""

    def __init__(self, cfg, n_slots: int, max_len: int, device,
                 kv_dtype: str = "bf16", placement=None):
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        self.k, self.v, self.k_scale, self.v_scale = kv_arenas(
            (L, n_slots, max_len, KV, hd), kv_dtype, cfg.dtype, device,
            placement)
        self.kv_shards = 1 if placement is None else placement.kv_shards
        self.kv_dtype = kv_dtype
        self.pos = np.zeros((n_slots,), np.int64)
        self.n_slots = n_slots
        self.max_len = max_len
        self._free = list(range(n_slots - 1, -1, -1))   # pop() -> ascending

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def max_request_tokens(self) -> int:
        return self.max_len

    def alloc(self) -> int | None:
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise DoubleFree(f"release of free slot {slot}")
        self._free.append(slot)

    def stats(self) -> dict:
        """Occupancy and the arena's whole device bill: int8 values and
        their f32 scales (``scale_bytes``), as the JAX pool reports it."""
        scale_bytes = arena_nbytes(self.k_scale, self.v_scale) \
            * self.kv_shards
        return {"layout": "slot", "n_slots": self.n_slots,
                "n_free": self.n_free, "max_len": self.max_len,
                "kv_dtype": self.kv_dtype,
                "arena_bytes": arena_nbytes(self.k, self.v) * self.kv_shards
                + scale_bytes,
                "scale_bytes": scale_bytes}

    def lane_rows(self, rows: list[int], n_rows_padded: int) -> np.ndarray:
        """Host lane->slot map for a chunk group; padding lanes point past
        the arena (their writes are skipped, their gathers clamp)."""
        out = np.full((n_rows_padded,), self.n_slots, np.int64)
        out[:len(rows)] = rows
        return out

    def chunk_end_check(self, cursor: int, lengths: list[int]) -> None:
        if cursor + max(lengths) > self.max_len:
            raise CapacityError(
                f"prefill of {max(lengths)} tokens at offset {cursor} "
                f"exceeds slot capacity {self.max_len}")

    def advance_prefill(self, rows: list[int], ends: list[int]) -> None:
        self.pos[np.asarray(rows, np.int64)] = ends

    def advance_decode(self, active_mask) -> None:
        """Only rows in ``active_mask`` advance; free slots and rows
        mid-prefill keep their position (the batch-wide decode write landed
        a garbage token there, which the next chunk or occupant overwrites
        before any query reads it)."""
        self.pos = np.where(np.asarray(active_mask), self.pos + 1, self.pos)
