"""Family adapters: one per-request state substrate per model family behind
one engine-facing surface (port of ``repro/serving/families.py``).

The engine schedules requests; it does not know what a family keeps per
request.  Each adapter owns that answer: the pool the scheduler allocates
slots from, any further arenas, and the two model calls over the family's
``unified_step``:

  ``step_chunk(lanes, cur, n_new, tokens, rows=None)``
      run one (cursor, bucket) prefill-chunk group, return logits
      [B, S, V]; ``lanes`` are the lanes' slots (slot layout) or block
      tables (paged), ``rows`` the lanes' pool rows (the hybrid family's
      state arena is indexed by row on the paged layout);
  ``step_decode(tokens, active)``
      run the fused S=1 decode over every lane, return logits
      [n_slots, 1, V];
  ``on_admit(req, slot) -> n_restored``
      per-request admission work: restore a swap-preempted request's state
      verbatim and return how many tokens of its sequence it has absorbed,
      so the engine resumes its cursor there;
  ``save_for_preempt(req, slot, n_written) -> blob | None``
      what preemption must save to keep the resumed stream exactly the
      uninterrupted one: None means recompute is exact (softmax attention:
      KV recomputed from tokens is the same numbers); the stateful slot
      families return a swap blob, because a recurrent state recomputed
      under other chunk boundaries differs in float summation order;
  ``validate_submit(prompt, sampling, embeds)``
      family-specific admission checks (the enc-dec family needs the
      encoder's ``embeds``, every other family takes token prompts only).

Per family:

  dense, moe
          ``TransformerAdapter``: slot or paged KV pool, bf16 or int8 KV
          (a moe model's routed experts are part of its ``unified_step``).
  ssm     ``RecurrentAdapter``: a ``RecurrentStatePool`` only, O(1) state a
          request and no KV; the layout is coerced to "slot" (there is
          nothing to page).  Swap preemption.
  hybrid  ``HybridAdapter``: a slot or paged KV pool sized to the shared
          attention's applications plus a ``RecurrentStatePool`` for the
          mamba layers, one slot identity across both
          (``HybridStatePool``), mixed in one step through
          ``HybridPoolView``.  The slot layout swaps state and KV on
          preemption (exact); the paged layout recomputes from scratch with
          the prefix cache off (cached KV blocks cannot reconstruct the
          SSM state), which may differ from the uninterrupted stream in the
          last ulp, as in the reference.
  encdec  ``EncDecAdapter``: decoder KV in a slot pool and the read-only
          encoder context rows in an ``EncoderContextPool``, one slot
          identity across both.  Admission runs the encoder once at the
          request's true length (an "encode" call); steps attend over
          both through ``EncDecPoolView``.  Swap preemption (context rows,
          KV and position); no paged layout.

On a mesh (``placement``, its params already the rank's) every adapter
allocates its pools through the placement (KV heads, recurrent-state
blocks, context rows) and hands its steps the head split (``heads``);
the recurrent steps read each layer's split from the state view.

Host arrays (lanes, cursors, tokens) go to the device here, once per step.
The S=1 decode call of the dense, moe and enc-dec families has the
reference's ``_jit`` (``repro/serving/families.py:91``) for a counterpart,
``CapturedStep``: on the card, an unplaced adapter's decode runs one
fixed-shape step from one [3, B] (enc-dec: [4, B]) int64 tensor, captured
once per key as a CUDA graph and replayed (``eager()`` turns capture and
replay off, as ``jax.disable_jit()`` does).  A moe model's decode is
captured when its expert stacks take the grouped product on the card
(``models/moe.experts_grouped``: bf16), so no layer reads its group sizes
to the host.  The key is the inputs' shape and each operand's address,
dtype, shape and strides (``storage_key``), walked once per (params,
arenas) objects (``FamilyAdapter.storage``).  By scope every other call
runs eagerly: prefill chunks, verify calls and encoder calls, a placed
adapter's (its collectives), and the ssm and hybrid adapters' (their
decode returns new state tensors, which the pool adopts).

``n_model_calls`` counts ``unified_step`` calls (and the enc-dec
adapter's ``n_encode_calls`` its encoder calls).  Each call runs through
``_traced``: a direct call under the default ``NULL_TRACER``, else the
engine's ``ServingTracer.jit_call`` with kinds "step" (chunk groups),
"decode" and "encode", keyed by the host arrays' shapes and costed by
``step_cost`` (an encoder call by ``encode_cost``), and under
``policy.suspended()``: a training policy left active in the process must
never put serving onto the capacity path of ``models/moe.py``, where pad
tokens would evict real ones.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import tree
from ..kernels.common import (add_launch_counts, holding_scratch,
                              launch_counts, set_launch_counts)
from ..launch import step_cost as cost
from ..models import moe as moe_lib
from ..models import transformer as tfm
from ..models import whisper as whi
from ..models import xlstm as xls
from ..models import zamba as zam
from ..models.sparse_serving import SparseWeight
from ..parallel import policy
from .cache_pool import CachePoolError, SlotKVPool, SlotPoolView
from .observe import NULL_TRACER
from .paged import PagedKVPool, PagedPoolView
from .state_pool import (EncDecPoolView, EncoderContextPool, HybridPoolView,
                         RecurrentStatePool, RecurrentStateView)


# how many ``eager()`` blocks are open: process-wide, as the reference's
# ``jax.disable_jit()`` is
_eager_depth = 0


@contextlib.contextmanager
def eager():
    """The counterpart of ``jax.disable_jit()``: inside the block every
    ``CapturedStep`` runs its step eagerly, neither capturing nor
    replaying.  Graphs captured before stay, and replay after the block."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


@dataclasses.dataclass
class CapturedGraph:
    """One key's graph: its static input buffer and output, the launches
    each replay makes (by counter), the scratch tensors its kernels use,
    the seconds its capture took and the bytes of its memory pool."""
    graph: torch.cuda.CUDAGraph
    inputs: torch.Tensor
    out: torch.Tensor
    launches: dict
    scratch: list
    capture_s: float
    pool_bytes: int


class CapturedStep:
    """The counterpart of ``jax.jit`` (the reference's ``_jit``) for one
    fixed-shape model call ``fn(inputs)`` (``fn`` given at each call, so
    the step holds no reference to its adapter): ``inputs`` an int64
    tensor on the device, the call's every other operand (params, arenas,
    tables) a tensor that keeps its address.  One CUDA graph per key, as
    ``jax.jit`` keeps one executable per input signature; the caller's
    key names the inputs' shape and every operand's storage, so new params
    or arenas get a new capture, never a stale replay.

    A call with key None, or inside ``eager()``, runs ``fn`` eagerly.  A
    key's first call runs ``fn`` eagerly on a side stream (which builds
    every kernel at first use: a capture never holds a kernel's first
    launch) and returns that call's result, then captures ``fn`` on the
    same stream.  The wrappers' launch counters move during the capture,
    though nothing runs: the change is taken back and added again at
    every replay, so they count what the card launched.  A later call
    copies its host array into the graph's input buffer, replays, and
    returns the graph's output, which the next replay overwrites: a caller
    copies what it keeps.  A failed capture raises."""

    def __init__(self):
        self.graphs: dict[tuple, CapturedGraph] = {}
        self.n_replays = 0

    def captures(self, key) -> bool | None:
        """Whether a call with ``key`` captures its graph (True) or replays
        it (False); None when it runs eagerly."""
        if key is None or _eager_depth:
            return None
        return key not in self.graphs

    def __call__(self, fn, key, host: np.ndarray, device) -> torch.Tensor:
        if key is None or _eager_depth:
            return fn(torch.as_tensor(host, device=device))
        g = self.graphs.get(key)
        if g is None:
            return self._capture(fn, key, host, device)
        g.inputs.copy_(torch.from_numpy(host))
        g.graph.replay()
        add_launch_counts(g.launches)
        self.n_replays += 1
        return g.out

    def _capture(self, fn, key, host, device) -> torch.Tensor:
        inputs = torch.as_tensor(host, device=device)
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(inputs)
        out.record_stream(main)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        counts = launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with holding_scratch() as scratch:
            with torch.cuda.graph(graph, stream=side):
                static = fn(inputs)
        capture_s = time.perf_counter() - t0
        launched = {k: n - counts[k] for k, n in launch_counts().items()
                    if n != counts[k]}
        set_launch_counts(counts)
        main.wait_stream(side)
        self.graphs[key] = CapturedGraph(
            graph, inputs, static, launched, scratch, capture_s,
            torch.cuda.memory_reserved(device) - reserved)
        return out

    def stats(self) -> dict:
        """Captures and replays; each graph's capture seconds, pool bytes
        and kernel launches a replay makes."""
        gs = list(self.graphs.values())
        return {"captures": len(gs), "replays": self.n_replays,
                "capture_s": [g.capture_s for g in gs],
                "pool_bytes": [g.pool_bytes for g in gs],
                "launches_per_replay": [
                    sum(n for (_, attr), n in g.launches.items()
                        if attr in ("launches", "launches_int8"))
                    for g in gs]}


def _operand(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def storage_key(*trees) -> tuple:
    """Each tensor of ``trees`` (a ``SparseWeight``'s buffers included), in
    order, as its address, dtype, shape and strides: the storage part of
    a captured call's key.  A graph reads its operands at their addresses
    with the layout it was captured with, so a tensor of another dtype or
    shape at a freed tensor's address gets a key, and a capture, of its
    own."""
    out = []
    for leaf in tree.flatten(list(trees)):
        if isinstance(leaf, torch.Tensor):
            out.append(_operand(leaf))
        elif isinstance(leaf, SparseWeight):
            out += [_operand(b) for b in leaf.buffers()]
    return tuple(out)


class FamilyAdapter:
    """Shared hooks; subclasses override what their family needs."""
    cfg = None
    params = None
    pool = None
    device = None
    kv_layout = "slot"
    kv_dtype = "bf16"
    # observability: the engine installs its ServingTracer here when
    # tracing is on; NULL_TRACER keeps ``_traced`` a direct call
    tracer = NULL_TRACER
    # distinguishes co-resident adapters sharing one tracer (the
    # speculative draft model attributes as "draft_step"/"draft_decode")
    trace_kind_prefix = ""

    def _setup(self, cfg, params, device) -> None:
        self.cfg, self.params, self.device = cfg, params, device
        self.n_model_calls = 0
        self._weights = None                   # step_cost's weight totals
        self.captured_decode = CapturedStep()
        self.graphed = False
        # (the params and arena objects of the last walk, their key)
        self._storage = None

    def storage(self, arenas: list) -> tuple:
        """``storage_key`` of ``arenas`` and the params, walked again only
        when ``self.params`` or an arena is another object than at the last
        walk: served params and arenas are replaced, never edited in place
        (a pool refreshes its device tables in place, which keeps their
        key)."""
        objs = (self.params, *arenas)
        got = self._storage
        if got is None or len(got[0]) != len(objs) \
                or any(a is not b for a, b in zip(got[0], objs)):
            got = self._storage = (objs, storage_key(arenas, self.params))
        return got[1]

    def _traced(self, kind: str, fn, args: tuple, cost=None,
                captures: bool | None = None):
        """Run a model call, attributed when tracing is on: wall and issue
        time, new-variant detection and its work per shape variant
        (``ServingTracer.jit_call``, costed by ``cost``, ``step_cost`` by
        default); ``captures`` says whether a captured call captures its
        graph now (None: the call is not captured)."""
        with policy.suspended():
            if not self.tracer.enabled:
                return fn(*args)
            return self.tracer.jit_call(self.trace_kind_prefix + kind, fn,
                                        args, cost=cost or self.step_cost,
                                        captures=captures)

    def step_cost(self, lanes, cur, n_new, tokens) -> dict:
        """The call's FLOPs and bytes (``launch/step_cost.py``), from the
        same host arrays the call takes."""
        if self._weights is None:
            self._weights = cost.weight_totals(self.params, self.cfg)
        return cost.step_cost(self.cfg, self._weights, cur, n_new,
                              tokens.size, self.kv_dtype)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.int64, device=self.device)

    def on_admit(self, req, slot: int) -> int:
        return 0

    def save_for_preempt(self, req, slot: int, n_written: int):
        return None

    def validate_submit(self, prompt, sampling, embeds) -> None:
        if embeds is not None:
            raise ValueError(
                f"family {self.cfg.family!r} takes token prompts only; "
                f"embeds= is for the enc-dec family")


# --------------------------------------------------------------------------
# dense / moe: slot or paged KV, bf16 or int8
# --------------------------------------------------------------------------

class TransformerAdapter(FamilyAdapter):
    """The dense and moe families on the slot and paged layouts.  On the
    paged layout only the ``active`` rows of a decode write KV (the others
    are routed into the trash block and leave it as it was); the slot
    layout writes every lane (a stray write lands where the next chunk or
    occupant overwrites it before any read).  With ``kv_dtype="int8"`` the
    views carry the pool's scale arenas, so every layer quantizes its fresh
    KV as it writes it and dequantizes inside attention.

    The decode call is one fixed-shape step over every lane
    (``_decode_step``: the views' ``decode``, write indices on the device)
    through ``captured_decode``, a ``CapturedStep``: replayed as a CUDA
    graph on the card without a placement, for a moe model when its expert
    stacks take the grouped product, eager otherwise (``graphed``).  Every
    lane routes through a moe layer, padding included, as in the
    reference's fixed-shape jit."""

    def __init__(self, cfg, params, *, n_slots: int, max_len: int, device,
                 kv_layout: str = "slot", block_size: int = 16,
                 n_blocks: int | None = None, prefix_caching: bool = True,
                 kv_dtype: str = "bf16", placement=None):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"no serving adapter for family {cfg.family!r}")
        self._setup(cfg, params, device)
        self.kv_layout = kv_layout
        if kv_layout == "paged":
            self.pool = PagedKVPool(cfg, n_slots, max_len, device=device,
                                    block_size=block_size, n_blocks=n_blocks,
                                    prefix_caching=prefix_caching,
                                    kv_dtype=kv_dtype, placement=placement)
        else:
            self.pool = SlotKVPool(cfg, n_slots, max_len, device,
                                   kv_dtype=kv_dtype, placement=placement)
        self.kv_dtype = kv_dtype
        # on a mesh: the rank's attention heads when its arenas hold only
        # those (``params`` are then the rank's, ``place_params``)
        self.heads = None if placement is None else placement.heads
        self.graphed = (self.pool.k.device.type == "cuda"
                        and (placement is None or not placement.active)
                        and (cfg.moe is None
                             or moe_lib.experts_grouped(params)))

    def _scales(self) -> dict:
        return {"k_scale": self.pool.k_scale, "v_scale": self.pool.v_scale}

    def _run(self, view, tokens: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = tfm.unified_step(self.params, view,
                                         {"tokens": self._tokens(tokens)},
                                         self.cfg, heads=self.heads)
        return logits

    def _chunk(self, lanes, cur, n_new, tokens) -> torch.Tensor:
        p, S = self.pool, tokens.shape[1]
        if self.kv_layout == "paged":
            view = PagedPoolView.build(p.k, p.v, lanes, cur, n_new, S,
                                       trash=p.trash_block, **self._scales())
        else:
            view = SlotPoolView.build(p.k, p.v, lanes, cur, n_new, S,
                                      **self._scales())
        return self._run(view, tokens)

    def _decode_step(self, inputs: torch.Tensor) -> torch.Tensor:
        """The S=1 decode over every lane from ``inputs`` [3, B] int64 on
        the device (each lane's token, cursor and ``n_new``), with no host
        array and no host sync: what ``captured_decode`` captures."""
        p = self.pool
        tokens, cur, n_new = inputs[0, :, None], inputs[1], inputs[2]
        if self.kv_layout == "paged":
            view = PagedPoolView.decode(p.k, p.v, p.block_tables,
                                        cur.to(torch.int32), n_new,
                                        trash=p.trash_block,
                                        **self._scales())
        else:
            view = SlotPoolView.decode(p.k, p.v, cur, n_new,
                                       **self._scales())
        with torch.no_grad():
            logits, _ = tfm.unified_step(self.params, view,
                                         {"tokens": tokens}, self.cfg,
                                         heads=self.heads)
        return logits

    def decode_key(self, host: np.ndarray):
        """A decode call's ``CapturedStep`` key (None when the call runs
        eagerly): the inputs' shape and the ``storage`` key of the arenas,
        the device block table and every param."""
        if not self.graphed:
            return None
        p = self.pool
        tables = p.block_tables if self.kv_layout == "paged" else None
        return (host.shape,
                self.storage([p.k, p.v, p.k_scale, p.v_scale, tables]))

    def step_chunk(self, lanes, cur, n_new, tokens, rows=None
                   ) -> torch.Tensor:
        self.n_model_calls += 1
        return self._traced("step", self._chunk, (lanes, cur, n_new, tokens))

    def step_decode(self, tokens, active: list[int]) -> torch.Tensor:
        """Logits [n_slots, 1, V]; on the card a replay's are the graph's
        own output, which the next decode call overwrites."""
        p = self.pool
        self.n_model_calls += 1
        if self.kv_layout == "paged":
            n_new = np.zeros_like(p.pos)
            n_new[active] = 1
            lanes = p.host_tables
        else:
            n_new, lanes = np.ones_like(p.pos), None
        host = np.stack([np.asarray(tokens, np.int64).reshape(-1),
                         p.pos.astype(np.int64), n_new.astype(np.int64)])
        # the key reads the device table, refreshed in place first
        key = self.decode_key(host)
        step = self.captured_decode
        return self._traced(
            "decode", lambda *_: step(self._decode_step, key, host,
                                      self.device),
            (lanes, p.pos, n_new, tokens), captures=step.captures(key))


def _active_mask(n: int, active: list[int]) -> np.ndarray:
    act = np.zeros((n,), np.int64)
    act[active] = 1
    return act


# --------------------------------------------------------------------------
# ssm (xLSTM): recurrent state slots only, no KV anywhere
# --------------------------------------------------------------------------

class RecurrentAdapter(FamilyAdapter):
    def __init__(self, cfg, params, *, n_slots: int, max_len: int, device,
                 placement=None):
        self._setup(cfg, params, device)
        self.pool = RecurrentStatePool(
            cfg, n_slots, max_len, lambda c, n: xls.init_state(c, n, device),
            placement=placement)

    def _run(self, rows, cur, n_new, tokens) -> torch.Tensor:
        view = RecurrentStateView.build(self.pool.states, rows, cur, n_new,
                                        self.pool.shards)
        with torch.no_grad():
            logits, states = xls.unified_step(
                self.params, view, {"tokens": self._tokens(tokens)},
                self.cfg)
        self.pool.adopt(states)
        return logits

    def step_chunk(self, lanes, cur, n_new, tokens, rows=None
                   ) -> torch.Tensor:
        self.n_model_calls += 1
        return self._traced("step", self._run, (lanes, cur, n_new, tokens))

    def step_decode(self, tokens, active: list[int]) -> torch.Tensor:
        # inactive lanes (mid-prefill rows, free slots) decode with n_new 0:
        # their gates are fully masked and their state comes back bit for
        # bit; unlike KV there is no overwrite-before-read to rely on
        self.n_model_calls += 1
        p = self.pool
        return self._traced("decode", self._run,
                            (None, p.pos, _active_mask(p.n_slots, active),
                             tokens))

    def save_for_preempt(self, req, slot, n_written):
        return {"state": self.pool.save_slot(slot), "pos": n_written}

    def on_admit(self, req, slot):
        if req.swap is None:
            return 0
        blob, req.swap = req.swap, None
        self.pool.restore_slot(slot, blob["state"])
        return blob["pos"]


# --------------------------------------------------------------------------
# hybrid (Zamba2): shared-attention KV pool + mamba state slots
# --------------------------------------------------------------------------

class HybridStatePool:
    """One slot identity across a KV pool (sized to the shared attention's
    applications) and a recurrent-state pool (every mamba layer).

    The engine drives the usual pool protocol; allocation and release hit
    both sub-pools in lockstep on the slot layout, so one id indexes a
    request's KV rows and its state.  Everything else (lane maps, capacity
    checks, positions, the paged admission surface) goes to the KV pool,
    whose per-row position doubles as the state cursor.  On the paged
    layout rows come from ``admit`` and the state arena is indexed by row:
    a reused row's stale state is never read (the cursor-0 init select)."""

    def __init__(self, kv, state, paged: bool):
        self.kv = kv
        self.state = state
        self._paged = paged

    def __getattr__(self, name):
        return getattr(self.kv, name)

    def alloc(self):
        row = self.kv.alloc()
        if row is None:
            return None
        srow = self.state.alloc()
        if srow != row:
            raise CachePoolError(
                f"hybrid sub-pools desynchronized: kv slot {row} vs state "
                f"slot {srow}")
        return row

    def release(self, slot: int) -> None:
        self.kv.release(slot)
        if not self._paged:
            self.state.release(slot)

    free = release


class HybridAdapter(FamilyAdapter):
    def __init__(self, cfg, params, *, n_slots: int, max_len: int, device,
                 kv_layout: str = "slot", block_size: int = 16,
                 n_blocks: int | None = None, prefix_caching: bool = True,
                 placement=None):
        n_attn = zam.n_applications(cfg)
        if n_attn == 0:
            raise ValueError(
                "hybrid serving needs at least one shared-attention "
                "application (attn_every > 0); a pure-mamba stack should "
                "use the 'ssm' family path")
        self._setup(cfg, params, device)
        self.kv_layout = kv_layout
        kv_cfg = dataclasses.replace(cfg, n_layers=n_attn)
        state = RecurrentStatePool(
            cfg, n_slots, max_len,
            lambda c, n: [zam.lane_init(c, i, n, device)
                          for i in range(c.n_layers)], placement=placement)
        if kv_layout == "paged":
            # prefix caching is off whatever was asked: a cached KV block
            # cannot reconstruct the SSM state that absorbed its tokens
            kv = PagedKVPool(kv_cfg, n_slots, max_len, device=device,
                             block_size=block_size, n_blocks=n_blocks,
                             prefix_caching=False, placement=placement)
        else:
            kv = SlotKVPool(kv_cfg, n_slots, max_len, device,
                            placement=placement)
        self.pool = HybridStatePool(kv, state, paged=(kv_layout == "paged"))
        self.heads = None if placement is None else placement.heads

    def _run(self, kview, srows, cur, n_new, tokens) -> torch.Tensor:
        kv, st = self.pool.kv, self.pool.state
        sview = RecurrentStateView.build(st.states, srows, cur, n_new,
                                         st.shards)
        with torch.no_grad():
            logits, _, states = zam.unified_step(
                self.params, HybridPoolView(kview, sview),
                {"tokens": self._tokens(tokens)}, self.cfg,
                heads=self.heads)
        st.adopt(states)
        return logits

    def _chunk(self, lanes, cur, n_new, tokens, srows) -> torch.Tensor:
        kv, S = self.pool.kv, tokens.shape[1]
        if self.kv_layout == "paged":
            kview = PagedPoolView.build(kv.k, kv.v, lanes, cur, n_new, S,
                                        trash=kv.trash_block)
        else:
            kview = SlotPoolView.build(kv.k, kv.v, lanes, cur, n_new, S)
        return self._run(kview, srows, cur, n_new, tokens)

    def _decode(self, lanes, cur, act, tokens) -> torch.Tensor:
        kv = self.pool.kv
        if self.kv_layout == "paged":
            # only the active rows write KV, into blocks prepare_decode
            # made private, as the dense paged decode
            kview = PagedPoolView.build(kv.k, kv.v, lanes, cur, act, 1,
                                        trash=kv.trash_block,
                                        device_tables=kv.block_tables)
        else:
            kview = SlotPoolView.build(kv.k, kv.v, None, cur,
                                       np.ones_like(cur), 1)
        return self._run(kview, None, cur, act, tokens)

    def step_chunk(self, lanes, cur, n_new, tokens, rows=None
                   ) -> torch.Tensor:
        self.n_model_calls += 1
        srows = lanes
        if self.kv_layout == "paged":
            srows = self.pool.state.lane_rows(rows, tokens.shape[0])
        return self._traced("step", lambda *a: self._chunk(*a, srows),
                            (lanes, cur, n_new, tokens))

    def step_decode(self, tokens, active: list[int]) -> torch.Tensor:
        self.n_model_calls += 1
        kv = self.pool.kv
        lanes = kv.host_tables if self.kv_layout == "paged" else None
        return self._traced("decode", self._decode,
                            (lanes, kv.pos, _active_mask(kv.n_slots, active),
                             tokens))

    def save_for_preempt(self, req, slot, n_written):
        if self.kv_layout == "paged":
            return None                      # recompute (module docstring)
        kv, st = self.pool.kv, self.pool.state
        return {"state": st.save_slot(slot), "k": kv.k[:, slot].clone(),
                "v": kv.v[:, slot].clone(), "pos": n_written}

    def on_admit(self, req, slot):
        if req.swap is None:
            return 0
        blob, req.swap = req.swap, None
        kv, st = self.pool.kv, self.pool.state
        st.restore_slot(slot, blob["state"])
        kv.k[:, slot] = blob["k"].to(kv.k.dtype)
        kv.v[:, slot] = blob["v"].to(kv.v.dtype)
        return blob["pos"]


# --------------------------------------------------------------------------
# encdec (Whisper): decoder KV slots + read-only encoder context rows
# --------------------------------------------------------------------------

class EncDecAdapter(FamilyAdapter):
    def __init__(self, cfg, params, *, n_slots: int, max_len: int,
                 max_ctx: int, device, placement=None):
        self._setup(cfg, params, device)
        self.pool = SlotKVPool(cfg, n_slots, max_len, device,
                               placement=placement)
        self.ctx = EncoderContextPool(cfg, n_slots, max_ctx, device,
                                      placement=placement)
        self.heads = None if placement is None else placement.heads
        self.n_encode_calls = 0
        self._enc_weights = None              # encode_cost's weight totals
        self.graphed = (self.pool.k.device.type == "cuda"
                        and (placement is None or not placement.active))

    def _run(self, rows, cur, n_new, tokens, ctx_len) -> torch.Tensor:
        p, c = self.pool, self.ctx
        view = EncDecPoolView.build(p.k, p.v, rows, cur, n_new,
                                    tokens.shape[1], ck=c.ck, cv=c.cv,
                                    ctx_len=ctx_len)
        with torch.no_grad():
            logits, _ = whi.unified_step(self.params, view,
                                         {"tokens": self._tokens(tokens)},
                                         self.cfg, heads=self.heads)
        return logits

    def _decode_step(self, inputs: torch.Tensor) -> torch.Tensor:
        """The S=1 decode over every slot from ``inputs`` [4, B] int64 on
        the device (each lane's token, cursor, ``n_new`` and context
        length), with no host array and no host sync: what
        ``captured_decode`` captures."""
        p, c = self.pool, self.ctx
        view = EncDecPoolView.decode(p.k, p.v, inputs[1], inputs[2],
                                     ck=c.ck, cv=c.cv, ctx_len=inputs[3])
        with torch.no_grad():
            logits, _ = whi.unified_step(self.params, view,
                                         {"tokens": inputs[0, :, None]},
                                         self.cfg, heads=self.heads)
        return logits

    def decode_key(self, host: np.ndarray):
        """A decode call's ``CapturedStep`` key (None when the call runs
        eagerly): the inputs' shape and the ``storage`` key of the decoder
        arenas, the context rows and every param."""
        if not self.graphed:
            return None
        p, c = self.pool, self.ctx
        return (host.shape, self.storage([p.k, p.v, c.ck, c.cv]))

    def _encode(self, embeds) -> tuple:
        with torch.no_grad():
            return whi.encode_ctx(self.params, embeds, self.cfg)

    def step_cost(self, lanes, cur, n_new, tokens, ctx_len) -> dict:
        """A decoder call's FLOPs and bytes, its cross-attention over each
        lane's ``ctx_len`` context rows included."""
        if self._weights is None:
            self._weights = cost.weight_totals(self.params, self.cfg)
        return cost.step_cost(self.cfg, self._weights, cur, n_new,
                              tokens.size, ctx_len=ctx_len)

    def encode_cost(self, embeds) -> dict:
        """An encoder call's FLOPs and bytes (``step_cost.encode_cost``)."""
        if self._enc_weights is None:
            self._enc_weights = cost.weight_totals(self.params, self.cfg,
                                                   kind="encode")
        return cost.encode_cost(self.cfg, self._enc_weights,
                                embeds.shape[1])

    def step_chunk(self, lanes, cur, n_new, tokens, rows=None
                   ) -> torch.Tensor:
        self.n_model_calls += 1
        ctx_len = self.ctx.lane_lens(rows, tokens.shape[0])
        return self._traced("step", self._run,
                            (lanes, cur, n_new, tokens, ctx_len))

    def step_decode(self, tokens, active: list[int]) -> torch.Tensor:
        """Logits [n_slots, 1, V] of every slot, as the reference's decode
        writes every slot (``n_new`` 1; a slot past its arena writes back
        what it holds); on the card a replay's are the graph's own
        output, which the next decode call overwrites."""
        self.n_model_calls += 1
        p = self.pool
        n_new, ctx_len = np.ones_like(p.pos), self.ctx.lens.copy()
        host = np.stack([np.asarray(tokens, np.int64).reshape(-1),
                         p.pos.astype(np.int64), n_new.astype(np.int64),
                         ctx_len.astype(np.int64)])
        key = self.decode_key(host)
        step = self.captured_decode
        return self._traced(
            "decode", lambda *_: step(self._decode_step, key, host,
                                      self.device),
            (None, p.pos, n_new, tokens, ctx_len),
            captures=step.captures(key))

    def validate_submit(self, prompt, sampling, embeds) -> None:
        if embeds is None:
            raise ValueError(
                "the enc-dec family needs embeds= at submit: the encoder "
                "frontend's [S_enc, d] features, run once at admission")
        n = (embeds.shape if hasattr(embeds, "shape")
             else np.shape(embeds))[0]
        if n > self.ctx.max_ctx:
            raise ValueError(
                f"encoder input of {n} frames exceeds the context arena "
                f"(max_ctx={self.ctx.max_ctx})")

    def on_admit(self, req, slot):
        """Restore a swap-preempted request's context, KV and position;
        else run the encoder over its ``embeds`` at their true length and
        install the context rows."""
        if req.swap is not None:
            blob, req.swap = req.swap, None
            self.ctx.restore_slot(slot, blob["ctx"])
            p = self.pool
            p.k[:, slot] = blob["k"].to(p.k.dtype)
            p.v[:, slot] = blob["v"].to(p.v.dtype)
            return blob["pos"]
        emb = torch.as_tensor(req.embeds, device=self.device).to(
            self.cfg.dtype)[None]                          # [1, S_enc, d]
        self.n_encode_calls += 1
        ck, cv = self._traced("encode", self._encode, (emb,),
                              cost=self.encode_cost)
        self.ctx.write(slot, ck[:, 0], cv[:, 0])
        return 0

    def save_for_preempt(self, req, slot, n_written):
        p = self.pool
        return {"ctx": self.ctx.save_slot(slot), "k": p.k[:, slot].clone(),
                "v": p.v[:, slot].clone(), "pos": n_written}


# --------------------------------------------------------------------------

def build_adapter(cfg, params, *, device, kv_layout: str, n_slots: int,
                  max_len: int, block_size: int = 16,
                  n_blocks: int | None = None, prefix_caching: bool = True,
                  kv_dtype: str = "bf16", max_ctx: int | None = None,
                  placement=None):
    """The family's adapter.  ssm has no KV at all, so any requested layout
    is served as "slot" (the engine coerces it); encdec pages neither its
    decoder slots nor its read-only context rows and refuses "paged"; its
    context arena holds ``max_ctx`` encoder frames a slot (``max_len`` when
    None).  Quantized KV (``kv_dtype="int8"``) exists only for the pure
    KV-transformer families, as in the reference.  A mesh ``placement``
    (its params already placed) goes to every family's pools and steps."""
    fam = cfg.family
    if kv_dtype != "bf16" and fam not in ("dense", "moe"):
        raise ValueError(
            f"kv_dtype={kv_dtype!r} needs a KV-transformer family "
            f"(dense/moe), not {fam!r}")
    if fam in ("dense", "moe"):
        return TransformerAdapter(
            cfg, params, n_slots=n_slots, max_len=max_len, device=device,
            kv_layout=kv_layout, block_size=block_size, n_blocks=n_blocks,
            prefix_caching=prefix_caching, kv_dtype=kv_dtype,
            placement=placement)
    if fam == "ssm":
        return RecurrentAdapter(cfg, params, n_slots=n_slots,
                                max_len=max_len, device=device,
                                placement=placement)
    if fam == "hybrid":
        return HybridAdapter(
            cfg, params, n_slots=n_slots, max_len=max_len, device=device,
            kv_layout=kv_layout, block_size=block_size, n_blocks=n_blocks,
            prefix_caching=prefix_caching, placement=placement)
    if fam == "encdec":
        if kv_layout == "paged":
            raise ValueError(
                "the enc-dec family has no paged layout: decoder KV is "
                "slot-resident and the encoder context rows are read-only")
        return EncDecAdapter(cfg, params, n_slots=n_slots, max_len=max_len,
                             max_ctx=max_len if max_ctx is None else max_ctx,
                             device=device, placement=placement)
    raise ValueError(f"no serving adapter for family {fam!r}")

