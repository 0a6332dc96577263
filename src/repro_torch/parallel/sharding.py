"""Sharding rules: parameter, cache and batch trees -> partition specs
(port of ``repro/parallel/sharding.py``).

Every rule is a pure function of the mesh's axis sizes (``axis_sizes``: a
``DeviceMesh`` or a mapping ``{axis name: size}``), so the rules run with
no process group at all.  A spec is a tuple with one entry a dim: ``None``
(whole), an axis name, or a tuple of two or more names (the dim split over
their product, the first name major).  A one-name tuple is normalised to
the name, as JAX's ``PartitionSpec`` normalises it.

Axes: ``fsdp`` = ("pod", "data") when the pod axis exists, else
("data",), the ZeRO-3-style weight axis; ``model`` the tensor-parallel
axis (heads, FFN hidden, vocab, experts).  Every rule is
divisibility-checked against the actual dim; axes that do not divide are
dropped (replicated).  N:M blocks live along the input dim of each
projection; that dim is split over fsdp only on whole N:M blocks and
256-wide outlier groups (``sparse_weight_specs``).

The port's parameter trees keep per-layer lists where the JAX package
stacks [L, ...] leaves (``interchange.STACKED``): a port leaf's path
carries the layer index (``layers/3/wq``) and its spec is the JAX leaf's
spec with the leading (layer) entry dropped.  ``local_shard`` slices a
tensor to one rank's block of a spec.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping
from typing import Any

import torch

from ..core.pipeline import map_leaves
from ..models.sparse_serving import SparseWeight

STACKED = ("layers", "mamba", "enc", "dec")      # interchange.STACKED
_LAYER_INDEX = re.compile(r"(^|/)(" + "|".join(STACKED) + r")/\d+(?=/|$)")


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping of sizes, in
    the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return {str(a): int(s) for a, s in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _norm(axes):
    """One spec entry, normalised: a one-name tuple is the name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def fsdp_axes(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _fit(mesh, dim: int, axes):
    """Return axes if dim divides evenly, else None (replicate)."""
    if axes is None:
        return None
    return axes if dim % axis_size(mesh, axes) == 0 else None


def _spec(mesh, shape, per_dim_axes) -> tuple:
    if len(shape) != len(per_dim_axes):
        raise ValueError(f"{len(per_dim_axes)} spec entries for a "
                         f"{len(shape)}-dim shape")
    return tuple(_norm(_fit(mesh, d, a)) for d, a in zip(shape, per_dim_axes))


def _replicated(nd: int) -> tuple:
    return (None,) * nd


def jax_path(path: str) -> tuple[str, bool]:
    """(the JAX package's path of a port leaf, whether the JAX package
    stacks it [L, ...]): ``layers/3/wq`` -> (``layers/wq``, True)."""
    name, n = _LAYER_INDEX.subn(r"\1\2", path)
    return name, n > 0


def _per_layer(rule, path: str, shape) -> tuple:
    """``rule(jax path, jax shape)`` for a port leaf: a stacked leaf gets a
    stand-in layer dim of 1 in front, whose spec entry is dropped."""
    name, stacked = jax_path(path)
    if not stacked:
        return rule(name, tuple(shape))
    return rule(name, (1,) + tuple(shape))[1:]


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def _param_spec_jax(mesh, path: str, shape) -> tuple:
    """The JAX package's ``param_spec`` on a JAX path and shape."""
    fs = fsdp_axes(mesh)
    p = path.lower()
    nd = len(shape)

    def tail(*axes):
        """Pad with None for leading (stack) dims."""
        return _spec(mesh, shape, (None,) * (nd - len(axes)) + tuple(axes))

    # ---- embeddings / head -------------------------------------------------
    if re.search(r"embed|lm_head", p):
        return tail("model", fs)
    # ---- norms / scalar-ish ------------------------------------------------
    if nd <= 2 and re.search(r"norm|a_log|dt_bias|scale|\bd\b|r_gates", p):
        return _replicated(nd)
    if "r_gates" in p:
        return _replicated(nd)
    # ---- MoE ---------------------------------------------------------------
    if "router" in p:
        return _replicated(nd)                   # small; replicated for EP
    # expert weights: experts over fsdp (when divisible), ff over model
    if re.search(r"we_(gate|up)", p):            # [L, E, d, ff]
        if shape[1] % axis_size(mesh, fs) == 0:
            return _spec(mesh, shape, (None, fs, None, "model"))
        return _spec(mesh, shape, (None, None, fs, "model"))
    if "we_down" in p:                           # [L, E, ff, d]
        if shape[1] % axis_size(mesh, fs) == 0:
            return _spec(mesh, shape, (None, fs, "model", None))
        return _spec(mesh, shape, (None, None, "model", fs))
    # ---- compressed SparseWeight buffers, by name only ---------------------
    # (``param_shardings`` routes real containers through
    # ``sparse_weight_specs``, which checks block and group alignment)
    if re.search(r"nm_values|nm_meta", p):       # [L, out, X]
        if shape[-1] % axis_size(mesh, fs) == 0:
            return tail("model", fs)
        return tail(("model",) + fs, None)
    if re.search(r"o_values|o_meta", p):         # [L, out, in/256, n*]
        if shape[-2] % axis_size(mesh, fs) == 0:
            return _spec(mesh, shape, (None,) * (nd - 3) + ("model", fs, None))
        return _spec(mesh, shape,
                     (None,) * (nd - 3) + (("model",) + fs, None, None))
    if re.search(r"v_scale", p):                 # [L, out] int8 row scales
        return tail("model")
    # ---- column-parallel: out dim = heads*hd / ff / gates ------------------
    if re.search(r"wq|wk|wv|w_gate|w_up|ws_gate|ws_up|in_proj|w_q|w_k|w_v|"
                 r"w_gates|w_slstm|c_wq|c_wk|c_wv", p):
        return tail("model", fs)
    # ---- row-parallel: in dim = heads*hd / ff ------------------------------
    if re.search(r"wo|w_down|ws_down|out_proj|c_wo", p):
        return tail(fs, "model")
    return _replicated(nd)


def param_spec(mesh, path: str, shape) -> tuple:
    """The spec of one port parameter leaf (``layers/3/wq`` [out, in])."""
    return _per_layer(lambda p, s: _param_spec_jax(mesh, p, s), path, shape)


def sparse_weight_specs(mesh, sw: SparseWeight, *, serving: bool = False):
    """Co-designed specs for one ``SparseWeight`` container: the container
    with every buffer replaced by its spec (``None`` buffers stay None).

    All buffers are decided together, so values, packed metadata and row
    scales always co-shard:

      * out (row) dim: over ``model`` whenever divisible, which is always
        safe (no compressed structure crosses rows);
      * in (column) dim: over fsdp only when every shard boundary falls on
        an N:M block (``m`` wide) and, with structured outliers, on a
        256-wide outlier group; otherwise the fsdp axes fold into the out
        dim when that divides, else replicate;
      * ``serving=True`` never splits a contraction dim (partial sums would
        change the logits' last ulp and break token identity with the
        single-device engine), so in-dims replicate unconditionally.
    """
    fs = fsdp_axes(mesh)
    # serving splits out rows only: a serving mesh may name "model" alone
    F = 1 if serving else axis_size(mesh, fs)
    model_n = axis_size(mesh, ("model",))
    nd = sw.nm_values.ndim
    lead = (None,) * (nd - 2)
    out = sw.nm_values.shape[-2]
    model_ok = out % model_n == 0
    in_ok = (not serving and F > 1 and sw.in_dim % (F * sw.m) == 0
             and (sw.o_n == 0 or sw.in_dim % (F * 256) == 0))
    out_axes = "model" if model_ok else None
    in_axes = _norm(fs) if in_ok else None
    if not serving and not in_ok and out % (model_n * F) == 0:
        out_axes = ("model",) + fs
    out_axes = _norm(out_axes)
    two_d = (*lead, out_axes, in_axes)            # nm_values / nm_meta
    o_spec = (*lead, out_axes, in_axes, None)     # o_values / o_meta
    return dataclasses.replace(
        sw, nm_values=two_d, nm_meta=two_d,
        o_values=None if sw.o_values is None else o_spec,
        o_meta=None if sw.o_meta is None else o_spec,
        v_scale=None if sw.v_scale is None else (*lead, out_axes))


def tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) of every array leaf in JAX's order (sorted dict keys,
    list items in order); a ``SparseWeight``'s buffers are leaves named
    ``<path>/.nm_values`` ..., as JAX names a dataclass's fields, and its
    None buffers are skipped."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k], join(k))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree) for pl in tree_paths(v, join(i))]
    if isinstance(tree, SparseWeight):
        return [(join("." + f), getattr(tree, f))
                for f in ("nm_values", "nm_meta", "o_values", "o_meta",
                          "v_scale") if getattr(tree, f) is not None]
    if tree is None:
        return []
    return [(prefix, tree)]


def param_shardings(mesh, params):
    """The spec tree mirroring ``params``: ``SparseWeight`` containers
    whole through ``sparse_weight_specs``, plain leaves through
    ``param_spec``."""
    def one(path, leaf):
        if isinstance(leaf, SparseWeight):
            return sparse_weight_specs(mesh, leaf)
        return param_spec(mesh, path, leaf.shape)
    return map_leaves(params, one)


# --------------------------------------------------------------------------
# batches / caches
# --------------------------------------------------------------------------

def batch_spec(mesh, shape, seq_shard: bool = False) -> tuple:
    """tokens/labels [B, S] or embeds [B, S, d] / positions [3, B, S]."""
    fs = fsdp_axes(mesh)
    nd = len(shape)
    if nd == 3 and shape[0] == 3:                # M-RoPE positions [3, B, S]
        return _spec(mesh, shape, (None, fs, "model" if seq_shard else None))
    if seq_shard:                                # long-context, B=1: SP
        axes = [None] * nd
        axes[1 if nd >= 2 else 0] = fs
        return _spec(mesh, shape, tuple(axes))
    return _spec(mesh, shape, (fs,) + (None,) * (nd - 1))


def cache_spec(mesh, path: str, shape, seq_shard: bool = False) -> tuple:
    """KV caches [L,B,S,KV,hd] / [B,S,KV,hd]; SSM states [B,H,dk,dv] etc."""
    fs = fsdp_axes(mesh)
    nd = len(shape)
    if nd == 0 or "pos" in path:
        return ()
    model_n = axis_size(mesh, ("model",))
    if nd == 5:                                   # [L, B, S, KV, hd]
        if seq_shard:
            return _spec(mesh, shape, (None, None, fs, "model", None))
        if shape[3] % model_n == 0:               # enough KV heads: shard heads
            return _spec(mesh, shape, (None, fs, None, "model", None))
        # GQA with KV < mesh: shard the sequence dim instead
        return _spec(mesh, shape, (None, fs, "model", None, None))
    if nd == 4:                                   # [B, S, KV, hd] or [B,H,dk,dv]
        if "kv" in path:
            if seq_shard:
                return _spec(mesh, shape, (None, fs, "model", None))
            if shape[2] % model_n == 0:
                return _spec(mesh, shape, (fs, None, "model", None))
            return _spec(mesh, shape, (fs, "model", None, None))
        return _spec(mesh, shape, (fs, "model", None, None))
    if nd >= 2:                                   # SSM state [B, H, ...]
        return _spec(mesh, shape, (fs, "model") + (None,) * (nd - 2))
    return (None,)


# --------------------------------------------------------------------------
# one rank's block
# --------------------------------------------------------------------------

def local_shard(t: torch.Tensor, spec: tuple, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> torch.Tensor:
    """``t``'s block on the rank at ``coords`` ({axis: index}) of a mesh of
    ``sizes`` ({axis: size}): every dim split over axes is narrowed to this
    rank's part, the first axis of a tuple major.  A view of ``t``."""
    if len(spec) != t.ndim:
        raise ValueError(f"a {len(spec)}-entry spec for a {t.ndim}-dim "
                         f"tensor")
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        parts, index = 1, 0
        for a in axes:
            parts *= sizes[a]
            index = index * sizes[a] + coords[a]
        if t.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {parts} parts")
        n = t.shape[dim] // parts
        t = t.narrow(dim, index * n, n)
    return t


def block_shape(shape, spec: tuple, sizes: Mapping[str, int]) -> tuple:
    """The shape of one rank's block of a ``shape`` leaf under ``spec``
    (``local_shard``'s, whatever the rank)."""
    out = []
    for dim, axes in zip(shape, spec):
        axes = () if axes is None else (axes,) if isinstance(axes, str) \
            else axes
        out.append(dim // math.prod(sizes[a] for a in axes))
    return tuple(out)


def splits(spec) -> bool:
    """Whether a spec splits any dim."""
    return any(a is not None for a in spec)
