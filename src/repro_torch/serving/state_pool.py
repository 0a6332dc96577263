"""Per-request state beyond KV: recurrent state slots and encoder context
rows (port of ``repro/serving/state_pool.py``).

``RecurrentStatePool``
    Fixed-size state slots behind the engine's pool protocol: each slot
    holds one request's recurrent carries (mLSTM matrix memory and
    normalizer, sLSTM scalar carries, Mamba2 SSM state) as a list of
    per-layer tuples of tensors with leading dim ``n_slots`` (a None entry
    stands for a carry the family does not keep, as Mamba2's normalizer).
    ``alloc``/``release`` manage the free list, ``adopt`` takes the state
    a step returns, ``advance_prefill``/``advance_decode`` track each
    slot's position on the host.  On a mesh (``placement``) each leaf is
    the rank's block by ``ServingPlacement.state_spec`` and ``shards``
    says, a layer, how the family's step splits its recurrence.
    ``save_slot``/``restore_slot`` serve swap preemption: a recurrent
    state recomputed under other chunk boundaries differs in float
    summation order, so the engine swaps it out and back instead of
    recomputing, and a preempted-and-resumed stream stays exactly the
    uninterrupted one.

``RecurrentStateView``
    What a family's ``unified_step`` sees of the pool: per-layer gather
    (lane -> slot) and scatter (slot <- lane, lanes past the arena
    dropped), as ``SlotPoolView`` addresses KV.  Fresh-state
    initialisation happens inside the step: at lanes whose cursor is 0 the
    family selects its init state (zeros, or the -1e30 stabilizer fill)
    instead of the slot's stale content, so a reused slot needs no reset
    and a swap-restored slot (cursor > 0) resumes untouched.

``HybridPoolView``
    The hybrid family's step view: a KV view (slot or paged) for the
    shared-attention applications and a ``RecurrentStateView`` for the
    mamba layers, each with its own ``n_new``.

``EncoderContextPool``
    The enc-dec family's read-only cross-attention context: per decoder
    layer the projected encoder K/V of each slot's request,
    [L, n_slots, max_ctx, KV, hd], and its true length on the host.  Rows
    are written once at admission and only read afterwards.  On a mesh the
    arenas hold the rank's KV heads, as a KV pool's.

``EncDecPoolView``
    A ``SlotPoolView`` of the decoder's self-attention arenas with the
    context arenas and each lane's context length beside it.

The port updates the arenas in place where a view has lane rows (a chunk
step); the fused decode (``rows`` None) returns fresh state tensors, which
the pool adopts.  Positions live on the host (numpy), as the KV pools'.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .cache_pool import CapacityError, DoubleFree, SlotPoolView


def map_state(fn, *trees):
    """``fn`` over the tensors of state trees of one structure (lists and
    tuples of tensors); a None entry stays None."""
    first = trees[0]
    if isinstance(first, (list, tuple)):
        return type(first)(map_state(fn, *parts) for parts in zip(*trees))
    if first is None:
        return None
    return fn(*trees)


def state_leaves(tree) -> list:
    """The tensors of a state tree, in order."""
    out = []
    map_state(out.append, tree)
    return out


def _lane_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class RecurrentStateView:
    """Lane addressing over a ``RecurrentStatePool``'s state arenas.

    ``states`` is the pool's list of per-layer state tuples (leading dim
    n_slots).  ``rows`` [B] maps lanes to slots, clamped into the arena
    (padding lanes gather slot n_slots - 1 harmlessly); None means the
    batch is the arena (the fused decode).  ``cursor`` [B] counts tokens
    already absorbed into each lane's state (0: a fresh lane, whose init
    state is selected in the step); ``n_new`` [B] is how many of the step's
    S positions are real per lane (families mask their gates past it).
    ``write_src``/``write_dst`` are the lanes whose slot lies inside the
    arena and those slots: the pairs ``scatter_layer`` writes.  ``shards``
    are the pool's per-layer ``StateShard``s on a mesh (None: every layer
    whole)."""
    states: Any
    rows: torch.Tensor | None
    cursor: torch.Tensor
    n_new: torch.Tensor
    write_src: torch.Tensor | None = None
    write_dst: torch.Tensor | None = None
    shards: Any = None

    @classmethod
    def build(cls, states, rows, cursor, n_new,
              shards=None) -> "RecurrentStateView":
        """A view from host arrays ``rows`` (or None), ``cursor`` and
        ``n_new``, on the arenas' device."""
        first = state_leaves(states)[0]

        def up(a):
            return torch.as_tensor(np.asarray(a, np.int64),
                                   device=first.device)
        if rows is None:
            return cls(states, None, up(cursor), up(n_new), shards=shards)
        rows = np.asarray(rows, np.int64)
        n_slots = first.shape[0]
        src = np.flatnonzero(rows < n_slots)
        return cls(states, up(np.minimum(rows, n_slots - 1)), up(cursor),
                   up(n_new), up(src), up(rows[src]), shards)

    def shard(self, i: int):
        """Layer ``i``'s ``StateShard`` (None off a mesh)."""
        return None if self.shards is None else self.shards[i]

    def gather_layer(self, i: int):
        """Per-lane state tuple of layer ``i`` ([B, ...] tensors)."""
        st = self.states[i]
        if self.rows is None:
            return st
        return map_state(lambda a: a[self.rows], st)

    def scatter_layer(self, i: int, new_state):
        """Layer ``i``'s arena with each lane's new state written at its
        slot, in place (padding lanes dropped); with ``rows`` None the new
        state is the arena."""
        if self.rows is None:
            return new_state

        def put(arena, fresh):
            return arena.index_copy_(
                0, self.write_dst,
                fresh.index_select(0, self.write_src).to(arena.dtype))
        return map_state(put, self.states[i], new_state)

    def select_fresh(self, lane_state, init_state):
        """Where a lane's cursor is 0, the family's init state in place of
        its slot's stale content (a previous occupant's); a no-op for
        resumed lanes."""
        fresh = self.cursor == 0
        return map_state(
            lambda init, cur: torch.where(_lane_mask(fresh, cur.ndim),
                                          init.to(cur.dtype), cur),
            init_state, lane_state)

    def keep_inactive(self, new_state, lane_state):
        """Lanes with no real position this step (``n_new`` 0) get their
        slot's original bits back (masking already makes their update a
        numeric no-op; this also keeps signed zeros)."""
        took = self.n_new > 0
        return map_state(
            lambda new, old: torch.where(_lane_mask(took, new.ndim), new,
                                         old),
            new_state, lane_state)


class RecurrentStatePool:
    """Recurrent-state slots behind the engine's pool protocol.

    ``init_states(cfg, n_slots)`` (the family's ``init_state``-style hook)
    allocates the arenas on their device.  State is O(1) per request, so
    positions bound nothing physical, but ``max_len`` still caps a
    request's prompt plus generation, so the engine's capacity checks stay
    uniform across families.  A mesh ``placement`` cuts every leaf of the
    whole arenas to the rank's block (``place_states``) and reads each
    layer's split from its first leaf (``state_shard``)."""

    def __init__(self, cfg, n_slots: int, max_len: int, init_states,
                 placement=None):
        states = init_states(cfg, n_slots)
        self.shards = None
        if placement is not None and placement.active:
            self.shards = [placement.state_shard(state_leaves(st)[0].shape)
                           for st in states]
            states = placement.place_states(states)
        self.states = states
        self.pos = np.zeros((n_slots,), np.int64)
        self.n_slots = n_slots
        self.max_len = max_len
        self._free = list(range(n_slots - 1, -1, -1))   # pop() -> ascending

    # ---------------------------------------------------------------- slots
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
        if not 0 <= slot < self.n_slots:
            raise CapacityError(f"slot {slot} outside pool of {self.n_slots}")
        self._free.append(slot)

    free = release

    def stats(self) -> dict:
        """Occupancy snapshot, with the reference's keys."""
        return {"layout": "state", "n_slots": self.n_slots,
                "n_free": self.n_free, "max_len": self.max_len}

    # ---------------------------------------------------------------- views
    def lane_rows(self, rows: list[int], n_rows_padded: int) -> np.ndarray:
        out = np.full((n_rows_padded,), self.n_slots, np.int64)
        out[:len(rows)] = rows
        return out

    def chunk_end_check(self, cursor: int, lengths: list[int]) -> None:
        if cursor + max(lengths) > self.max_len:
            raise CapacityError(
                f"prefill of {max(lengths)} tokens at offset {cursor} "
                f"exceeds request capacity {self.max_len}")

    # ------------------------------------------------------------ lifecycle
    def adopt(self, states) -> None:
        """Take the state arenas a step returned (the same tensors, updated
        in place, for a chunk step; fresh ones for the fused decode)."""
        self.states = states

    def advance_prefill(self, rows: list[int], ends: list[int]) -> None:
        self.pos[np.asarray(rows, np.int64)] = ends

    def advance_decode(self, active_mask) -> None:
        self.pos = np.where(np.asarray(active_mask), self.pos + 1, self.pos)

    # ----------------------------------------------------- swap preemption
    def save_slot(self, slot: int):
        """One slot's state tensors (copies) for swap-out."""
        return map_state(lambda a: a[slot].clone(), self.states)

    def restore_slot(self, slot: int, saved) -> None:
        def put(arena, leaf):
            arena[slot] = leaf.to(arena.dtype)
            return arena
        self.states = map_state(put, self.states, saved)


@dataclasses.dataclass(frozen=True)
class HybridPoolView:
    """One step's view for the hybrid family: a KV pool view
    (``SlotPoolView`` or ``PagedPoolView``) for the shared-attention
    applications and a ``RecurrentStateView`` for the mamba layers.  The
    two carry their own ``n_new``: a decode step may write KV for lanes
    whose recurrence must stay untouched."""
    kv: Any
    state: RecurrentStateView

    @property
    def cursor(self):
        return self.state.cursor


class EncoderContextPool:
    """Read-only cross-attention context rows for the enc-dec family.

    ``ck``/``cv`` hold each decoder layer's projected encoder K/V,
    [L, n_slots, max_ctx, KV, hd] in the model's dtype (the shape grammar
    of a KV arena); ``lens`` [n_slots] is each slot's true context length,
    on the host.  A slot's rows are written once, at admission, and only
    read afterwards, so the pool has no advance/adopt lifecycle."""

    def __init__(self, cfg, n_slots: int, max_ctx: int, device,
                 placement=None):
        shape = (cfg.n_layers, n_slots, max_ctx, cfg.n_kv_heads, cfg.hd)
        self.ck = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.cv = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.placement = placement
        if placement is not None:
            self.ck = placement.place_kv(self.ck)
            self.cv = placement.place_kv(self.cv)
        self.lens = np.zeros((n_slots,), np.int64)
        self.n_slots = n_slots
        self.max_ctx = max_ctx

    def write(self, slot: int, ck, cv) -> None:
        """Install one request's projected context ([L, S_enc, KV, hd],
        every KV head) at its true encoder length; on a mesh only the
        rank's heads are kept."""
        n = ck.shape[1]
        if n > self.max_ctx:
            raise CapacityError(
                f"encoder context of {n} exceeds max_ctx {self.max_ctx}")
        if self.placement is not None:
            ck = self.placement.kv_heads_of(ck, 2)
            cv = self.placement.kv_heads_of(cv, 2)
        self.ck[:, slot, :n] = ck.to(self.ck.dtype)
        self.cv[:, slot, :n] = cv.to(self.cv.dtype)
        self.lens[slot] = n

    def save_slot(self, slot: int):
        """(ck, cv, length) of one slot, copies, for swap-out."""
        return (self.ck[:, slot].clone(), self.cv[:, slot].clone(),
                int(self.lens[slot]))

    def restore_slot(self, slot: int, saved) -> None:
        ck, cv, n = saved
        self.ck[:, slot] = ck.to(self.ck.dtype)
        self.cv[:, slot] = cv.to(self.cv.dtype)
        self.lens[slot] = n

    def lane_lens(self, rows: list[int], n_rows_padded: int) -> np.ndarray:
        """Per-lane context lengths of a chunk group; padding lanes get 0
        (their cross-attention output is never read)."""
        out = np.zeros((n_rows_padded,), np.int64)
        out[:len(rows)] = self.lens[np.asarray(rows, np.int64)]
        return out


@dataclasses.dataclass(frozen=True)
class EncDecPoolView(SlotPoolView):
    """A ``SlotPoolView`` of the decoder's self-attention arenas (and its
    lane addressing) with the read-only encoder context: the per-layer
    ``ck``/``cv`` arenas [L, n_slots, max_ctx, KV, hd] and each lane's true
    context length ``ctx_len`` [B]."""
    ck: Any = None
    cv: Any = None
    ctx_len: Any = None

    @classmethod
    def build(cls, k, v, rows, cursor, n_new, S: int, *, ck, cv,
              ctx_len) -> "EncDecPoolView":
        """``SlotPoolView.build``'s view with the context arenas and the
        host array ``ctx_len`` beside it."""
        view = super().build(k, v, rows, cursor, n_new, S)
        return dataclasses.replace(
            view, ck=ck, cv=cv,
            ctx_len=torch.as_tensor(np.asarray(ctx_len, np.int64),
                                    device=k.device))

    @classmethod
    def decode(cls, k, v, cursor: torch.Tensor, n_new: torch.Tensor, *,
               ck, cv, ctx_len: torch.Tensor) -> "EncDecPoolView":
        """The fused decode's view from device tensors ``cursor``,
        ``n_new`` and ``ctx_len`` [B] (lane i == slot i): the write indices
        of ``SlotPoolView.decode``, the context arenas and lengths beside
        them; no host array, so a decode step over it can be captured."""
        view = super().decode(k, v, cursor, n_new)
        return dataclasses.replace(view, ck=ck, cv=cv, ctx_len=ctx_len)

    def lane_ctx(self, ck_l, cv_l):
        """Per-lane [B, max_ctx, KV, hd] context rows of one layer; padding
        lanes' rows are clamped into the arena, as ``lane_kv`` clamps."""
        if self.rows is None:
            return ck_l, cv_l
        rows = self.rows.clamp(max=ck_l.shape[0] - 1)
        return ck_l[rows], cv_l[rows]
