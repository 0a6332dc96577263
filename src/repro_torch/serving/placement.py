"""Serving placement: the one layer that decides where every serving buffer
lives on a ``("data", "model")`` mesh (port of
``repro/serving/placement.py``).

``ServingPlacement`` maps the serving trees (model params, dense tensors
and ``SparseWeight`` containers alike, both KV layouts' arenas and their
int8 scales, the host-shipped vectors) to specs on the mesh, and places
them: each rank keeps its block.  The engine places its params through
it, the pools allocate their arenas through it, and the transformer's
step takes its ``heads``.  With no mesh (the default) every hook is the
identity and the engine is the single-device engine, bit for bit.

Policy, the reference's:

  * **Out-dim ("model") tensor parallelism only.**  Projection weights
    split their output rows; contraction (input) dims stay whole on every
    rank.  Every output element is then the same full-length dot product
    the single-device engine computes, gathered, never a partial sum
    combined across ranks, which is what keeps the sharded engine's token
    streams identical to the single-device engine's.
  * **SparseWeight containers split as one unit**: ``nm_values``,
    ``nm_meta``, ``o_values``, ``o_meta`` and ``v_scale`` together on the
    out dim (``parallel.sharding.sparse_weight_specs(serving=True)``).
    The embedding and the head split on vocab rows.
  * **KV arenas split the KV-head dim over "model"** when the KV heads
    divide it: the slot pool's [L, slots, max_len, KV, hd] and the paged
    [L, n_blocks, block_size, KV, hd] arenas alike (a hybrid model's
    shared-attention arenas, an enc-dec model's decoder arenas and its
    encoder context rows too), so attention is head-local on every rank
    and its output is gathered over heads before ``wo``.  A GQA model with
    fewer KV heads than ranks replicates the arena and attends whole on
    every rank.  Block tables, the prefix cache, free lists and refcounts
    stay on the host, identical on every rank.
  * **Expert stacks [E, in, out] split their last dim**: a rank computes
    its columns of every routed row (``ColShard``, ``models/moe.py``).
  * **Recurrent-state leaves split by ``state_spec``**: heads, else a
    matrix state's value columns, else whole (``StateShard``: the
    families' steps take the rank's heads or columns).
  * **Draft params ride the same placement** (``for_draft``): a
    speculative drafter's params split by the same rules, and its slot
    arena by the target's KV-split decision, so draft and target share
    one mesh and every rank reads the same gathered draft logits.

The torch counterpart of the reference's jit shardings is the SPMD idiom:
one process a rank, every rank running the same engine on the same
requests with explicit collectives in the layers
(``parallel/tensor_parallel.py``).  Ranks stay in lockstep because every
scheduling decision is a function of the requests and the clock, and
``shared_clock`` makes every rank read rank 0's clock.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import re

import torch
import torch.distributed as dist

from ..models.sparse_serving import SparseWeight
from ..core.pipeline import map_leaves
from ..parallel.sharding import (axis_sizes, local_shard, sparse_weight_specs,
                                 splits)
from ..parallel.tensor_parallel import (ColShard, HeadShard, ModelAxis,
                                        RowShard, StateShard)

# out-dim-split projections ([*, out, in] layout) and embeddings/head
_PROJ = re.compile(r"wq|wk|wv|wo|w_gate|w_up|w_down|ws_gate|ws_up|ws_down|"
                   r"in_proj|out_proj|w_q|w_k|w_v|c_wq|c_wk|c_wv|c_wo")
_EMBED = re.compile(r"embed|lm_head")
_EXPERT = re.compile(r"we_(gate|up|down)")       # [L, E, in, out] layout
_SPARSE_BUFFERS = ("nm_values", "nm_meta", "o_values", "o_meta", "v_scale")


class ServingPlacement:
    """Placement decisions for one engine instance.

    ``mesh`` is a ``DeviceMesh`` (``launch/mesh.make_serving_mesh``) or,
    for the specs alone, a mapping ``{axis name: size}``; placing tensors
    needs the ``DeviceMesh``.  ``mesh=None`` (default) disables placement:
    ``active`` is False, every ``place_*`` hook returns its input and every
    spec accessor returns None."""

    def __init__(self, mesh=None, cfg=None):
        sizes = {}
        if mesh is not None:
            sizes = axis_sizes(mesh)
            if "model" not in sizes:
                raise ValueError(f"serving mesh needs a 'model' axis, got "
                                 f"{tuple(sizes)}")
            extra = {a: s for a, s in sizes.items() if a != "model" and s > 1}
            if extra:
                # only model-axis TP is placed; >1 on any other axis would
                # run fully redundant replicas
                raise ValueError(
                    f"serving placement shards over 'model' only; non-model "
                    f"mesh axes must be size 1, got {extra}")
            if cfg is None:
                raise ValueError("a mesh placement needs the model cfg "
                                 "(KV-head divisibility)")
        self.mesh = mesh
        self.cfg = cfg
        self.sizes = sizes
        # whether the KV arenas split their heads over "model": decided by
        # the target's KV heads, and kept by a drafter's placement
        self.kv_sharded = (mesh is not None
                           and cfg.n_kv_heads % sizes["model"] == 0)
        self._axis = None
        self._coords = None
        self._control = None
        if self.active and hasattr(mesh, "get_group") and self.n_ranks > 1:
            # scheduling state (the clock) crosses ranks on the host: a
            # gloo group beside an NCCL one over this mesh's ranks, made by
            # those ranks alone (a fleet's other replicas build theirs); a
            # fake group (a dry run, ``launch/dryrun.py``) serves itself
            group = mesh.get_group("model")
            self._control = group if dist.get_backend(group) in (
                "gloo", "fake") \
                else dist.new_group(dist.get_process_group_ranks(group),
                                    backend="gloo",
                                    use_local_synchronization=True)

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def n_ranks(self) -> int:
        return math.prod(self.sizes.values()) if self.active else 1

    @property
    def model_size(self) -> int:
        return self.sizes.get("model", 1)

    # ------------------------------------------------------------- specs
    @property
    def replicated(self) -> tuple | None:
        """For host-shipped vectors (tokens, positions, block tables,
        sampling logits): every rank holds the whole array."""
        return () if self.active else None

    @property
    def kv(self) -> tuple | None:
        """One spec for every [L, X, tokens, KV, hd] KV buffer: the slot
        pool (X = slots) and the paged arena (X = blocks).  Heads over
        "model" when they divide; else replicated."""
        if not self.active:
            return None
        return (None, None, None, "model" if self.kv_sharded else None, None)

    @property
    def kv_scale(self) -> tuple | None:
        """One spec for every [L, X, tokens, KV] int8-arena scale tensor,
        co-split with the arena's KV-head dim."""
        if not self.active:
            return None
        return (None, None, None, "model" if self.kv_sharded else None)

    @property
    def kv_shards(self) -> int:
        """How many ranks share one arena's heads (1 when replicated)."""
        return self.model_size if self.kv_sharded else 1

    def state_spec(self, shape) -> tuple:
        """Spec for one recurrent-state arena leaf [slots, H, ...]: dim 1
        (heads) over "model" when divisible; else, for a matrix state
        [slots, H, dk, dv], its last (output) dim; else replicated.  Only
        dims that are pure outputs of the recurrence split, so no dot
        product is ever split into partial sums."""
        model_n = self.model_size
        nd = len(shape)
        axes = [None] * nd
        if nd >= 2 and shape[1] % model_n == 0:
            axes[1] = "model"
        elif nd >= 4 and shape[-1] % model_n == 0:
            axes[-1] = "model"
        return tuple(axes)

    def _dense_spec(self, name: str, shape) -> tuple:
        model_n = self.model_size
        nd = len(shape)
        leaf = name.lower().rsplit("/", 1)[-1]

        def over_model(dim_idx):
            axes = [None] * nd
            if shape[dim_idx] % model_n == 0:
                axes[dim_idx] = "model"
            return tuple(axes)

        if nd >= 2 and _EMBED.search(leaf):
            return over_model(0)                 # [vocab, d]: rows of vocab
        if _EXPERT.search(leaf):
            return over_model(nd - 1)            # [E, in, out]: out last
        if nd >= 2 and _PROJ.search(leaf):
            return over_model(nd - 2)            # [out, in]: out rows
        return (None,) * nd                      # norms / router / scalars

    def _leaf_spec(self, path: str, leaf):
        if isinstance(leaf, SparseWeight):
            return sparse_weight_specs(self.sizes, leaf, serving=True)
        return self._dense_spec(path, leaf.shape)

    def param_shardings(self, params):
        """The serving-policy spec tree mirroring ``params``, SparseWeight
        containers whole (None when no mesh)."""
        if not self.active:
            return None
        return map_leaves(params, self._leaf_spec)

    def for_draft(self, dcfg) -> "ServingPlacement":
        """A speculative drafter's placement: the target's mesh, model axis
        and clock, the draft's head counts, and the target's decision on
        the KV split (the reference drafts on the target's placement,
        whose KV spec reads the target's KV heads).  Raises, before any
        tensor is placed, when the target's split cannot be laid out for
        the draft: its KV heads divide the model axis and the draft's do
        not."""
        if not self.active:
            return self
        if self.kv_sharded and dcfg.n_kv_heads % self.model_size:
            raise ValueError(
                f"the draft's {dcfg.n_kv_heads} KV heads cannot follow the "
                f"target's split of its {self.cfg.n_kv_heads} KV heads over "
                f"{self.model_size} ranks")
        draft = copy.copy(self)
        draft.cfg = dcfg
        return draft

    # --------------------------------------------------------- placement
    def _device_mesh(self):
        if not hasattr(self.mesh, "get_group"):
            raise TypeError(
                "placing tensors needs a DeviceMesh "
                "(launch/mesh.make_serving_mesh); a mapping of axis sizes "
                "gives the specs only")
        return self.mesh

    @property
    def axis(self) -> ModelAxis:
        """This rank's place on the model axis and its group."""
        if self._axis is None:
            mesh = self._device_mesh()
            self._axis = ModelAxis(mesh.get_group("model"), self.model_size,
                                   mesh.get_local_rank("model"))
        return self._axis

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index on every mesh axis (read once)."""
        if self._coords is None:
            mesh = self._device_mesh()
            self._coords = {a: mesh.get_local_rank(a) for a in self.sizes}
        return self._coords

    def _local(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of ``t``: a copy of its own where ``spec``
        cuts it (so the whole tensor can be freed), else ``t`` itself (a
        dim split over an axis of size 1 is whole)."""
        local = local_shard(t, spec, self.sizes, self.coords)
        if local.shape == t.shape:
            return t
        return local.clone(memory_format=torch.contiguous_format)

    def place_params(self, params):
        """This rank's params: every out-dim-split leaf sliced to its rows
        and wrapped in a ``RowShard`` (a ``SparseWeight``'s five buffers
        sliced together), every last-dim-split expert stack sliced to its
        columns and wrapped in a ``ColShard``, everything else as it is."""
        if not self.active:
            return params

        def one(path, leaf):
            spec = self._leaf_spec(path, leaf)
            if isinstance(leaf, SparseWeight):
                if not splits(spec.nm_values):
                    return leaf
                return RowShard(dataclasses.replace(leaf, **{
                    f: self._local(getattr(leaf, f), getattr(spec, f))
                    for f in _SPARSE_BUFFERS if getattr(leaf, f) is not None}),
                    self.axis)
            if not splits(spec):
                return leaf
            if spec[0] is None:
                return ColShard(self._local(leaf, spec), self.axis)
            return RowShard(self._local(leaf, spec), self.axis)
        return map_leaves(params, one)

    def place_states(self, states):
        """A recurrent-state arenas list (per-layer tuples of [slots, ...]
        tensors, None for a carry the family does not keep) with every
        leaf cut to this rank's block by ``state_spec``."""
        if not self.active:
            return states
        from .state_pool import map_state
        return map_state(lambda a: self._local(a, self.state_spec(a.shape)),
                         states)

    def state_shard(self, shape) -> StateShard | None:
        """How a recurrent layer whose first state leaf is ``shape`` (the
        whole [slots, H, ...] leaf: the matrix memory, the first sLSTM
        carry, the SSM state) splits: ``state_spec``'s decision as a
        ``StateShard``; None with no mesh."""
        if not self.active:
            return None
        spec = self.state_spec(shape)
        mode = ("heads" if spec[1] is not None
                else "dv" if spec[-1] is not None else "whole")
        return StateShard(mode, self.axis)

    @property
    def heads(self) -> HeadShard | None:
        """The transformer's head split when the KV arenas are split, else
        None (attention whole on every rank)."""
        if not self.kv_sharded:
            return None
        return HeadShard(self.axis, self.cfg.n_heads, self.cfg.n_kv_heads)

    def kv_heads_of(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's KV heads (along ``dim``) of a whole tensor when the
        arenas split them (an enc-dec model's context rows as the encoder
        call returns them), else ``t``."""
        return self.heads.local_kv(t, dim) if self.kv_sharded else t

    def place_kv(self, arr: torch.Tensor) -> torch.Tensor:
        """A KV arena or pool buffer's block on this rank (its KV heads)."""
        return arr if not self.active else self._local(arr, self.kv)

    def place_kv_scale(self, arr: torch.Tensor) -> torch.Tensor:
        """An int8 arena's scale tensor, next to its arena's heads."""
        return arr if not self.active else self._local(arr, self.kv_scale)

    def place_replicated(self, arr):
        """Host-shipped vectors: every rank holds the whole array."""
        return arr

    def shared_clock(self, clock):
        """``clock`` read on rank 0 and broadcast to every rank, so every
        rank's queue timeouts, admissions and plans agree; ``clock`` itself
        on one rank."""
        if self._control is None:
            return clock
        group = self._control

        def read() -> float:
            t = torch.tensor([clock() if dist.get_rank(group) == 0 else 0.0],
                             dtype=torch.float64)
            dist.broadcast(t, src=dist.get_global_rank(group, 0),
                           group=group)
            return float(t[0])
        return read

    # ------------------------------------------------------------ metadata
    def describe(self) -> dict:
        """Benchmark/metrics-facing summary."""
        if not self.active:
            return {"devices": 1, "mesh": None}
        return {"devices": self.n_ranks, "mesh": dict(self.sizes)}

