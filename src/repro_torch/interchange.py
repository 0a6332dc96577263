"""Carry a JAX params pytree across into the port, without importing jax.

``from_jax_params`` walks nested dicts.  A leaf with ``nm_values`` (the JAX
package's ``SparseWeight``) becomes the port's ``SparseWeight`` with its
five buffers in the same layouts and the static ``n``/``m``/``o_n``/
``in_dim`` copied; every other leaf goes through ``np.asarray``.  The JAX
package stacks layer weights [L, ...] under ``"layers"``; the port keeps a
list of per-layer dicts, so that entry is split along its first axis.

bf16 arrays come out of ``np.asarray`` as ``ml_dtypes`` bfloat16, which
``torch.from_numpy`` rejects; they cross as their 16-bit patterns and are
viewed as ``torch.bfloat16``, which is exact.

``stats_from_jax`` and ``sparsified_from_jax`` carry the pipeline's
calibration statistics and per-layer results across, so that tests compare
the two packages' containers field by field.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import (ActStats, PackedNM, SparsifiedLinear,
                   StructuredOutliers)
from .device import resolve
from .models.sparse_serving import SparseWeight


def to_torch(a, device="cpu") -> torch.Tensor:
    """One array (numpy, or anything ``np.array`` takes) as a tensor, copied
    (JAX hands out read-only buffers)."""
    arr = np.array(a, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _sparse_weight(sw, device) -> SparseWeight:
    def conv(a):
        return None if a is None else to_torch(a, device)
    return SparseWeight(
        nm_values=conv(sw.nm_values), nm_meta=conv(sw.nm_meta),
        o_values=conv(sw.o_values), o_meta=conv(sw.o_meta),
        v_scale=conv(sw.v_scale), n=int(sw.n), m=int(sw.m),
        o_n=int(sw.o_n), in_dim=int(sw.in_dim))


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if hasattr(tree, "nm_values"):
        return _sparse_weight(tree, device)
    return to_torch(tree, device)


def _split_layers(layers: dict) -> list[dict]:
    """{name: [L, ...]} -> [{name: [...]}] * L, for tensors and
    SparseWeights alike."""
    def first_dim(v):
        return (v.nm_values if isinstance(v, SparseWeight) else v).shape[0]

    def take(v, i):
        if isinstance(v, SparseWeight):
            return v.map(lambda t: t[i].contiguous())
        return v[i].contiguous()

    n_layers = {first_dim(v) for v in layers.values()}
    if len(n_layers) != 1:
        raise ValueError(f"stacked layer leaves disagree on L: {n_layers}")
    return [{k: take(v, i) for k, v in layers.items()}
            for i in range(n_layers.pop())]


def from_jax_params(params, device="cuda") -> dict:
    """The port's params on ``device`` from a JAX params pytree (a dict
    with stacked ``"layers"``)."""
    out = _convert(params, resolve(device))
    if isinstance(out.get("layers"), dict):
        out["layers"] = _split_layers(out["layers"])
    return out


def stats_from_jax(stats: dict, device="cpu") -> dict:
    """The JAX harness's ``{"layers/wq": ActStats[L, in]}`` (stacked
    layers, ``count`` [L]) as the port's ``{"layers/{i}/wq": ActStats[in]}``
    with a scalar ``count``; an entry without the leading [L] keeps its
    name."""
    out = {}
    for name, st in stats.items():
        sq, mx, cnt = (to_torch(a, device) for a in
                       (st.sq_sum, st.max_abs, st.count))
        if sq.ndim == 1:
            out[name] = ActStats(sq_sum=sq, max_abs=mx, count=cnt)
            continue
        head, leaf = name.rsplit("/", 1)
        for i in range(sq.shape[0]):
            out[f"{head}/{i}/{leaf}"] = ActStats(
                sq_sum=sq[i].contiguous(), max_abs=mx[i].contiguous(),
                count=cnt[i].contiguous())
    return out


def sparsified_from_jax(sl, device="cpu") -> SparsifiedLinear:
    """A JAX ``SparsifiedLinear`` (one layer) as the port's."""
    nm = PackedNM(values=to_torch(sl.nm.values, device),
                  indices=to_torch(sl.nm.indices, device), n=int(sl.nm.n),
                  m=int(sl.nm.m), in_dim=int(sl.nm.in_dim))
    outliers = None
    if sl.outliers is not None:
        outliers = StructuredOutliers(
            values=to_torch(sl.outliers.values, device),
            indices=to_torch(sl.outliers.indices, device),
            n=int(sl.outliers.n), m=int(sl.outliers.m))
    return SparsifiedLinear(nm=nm, outliers=outliers,
                            nm_mask=to_torch(sl.nm_mask, device),
                            salient_mask=to_torch(sl.salient_mask, device))


def paged_pool_from_jax(jpool, cfg, device="cuda"):
    """A port ``PagedKVPool`` holding a JAX ``PagedKVPool``'s state: the
    arenas and, for an int8 pool, their scale arenas (as numpy, then
    tensors on ``device``), refcounts, free list and
    cached-block marks, row tables, positions, free rows and the prefix
    cache's entries and counters.  ``cfg`` is the port's config (its dtype
    must be the arenas')."""
    from .serving.paged import BlockTable, PagedKVPool
    device = resolve(device)
    pool = PagedKVPool(cfg, jpool.n_rows, jpool.max_len, device=device,
                       block_size=jpool.block_size, n_blocks=jpool.n_blocks,
                       prefix_caching=jpool.prefix_cache is not None,
                       kv_dtype=jpool.kv_dtype)
    jb, b = jpool.blocks, pool.blocks
    b.k, b.v = to_torch(jb.k, device), to_torch(jb.v, device)
    if jb.k_scale is not None:
        b.k_scale = to_torch(jb.k_scale, device)
        b.v_scale = to_torch(jb.v_scale, device)
    b.ref = np.array(jb.ref, np.int32)
    b._free = [int(x) for x in jb._free]
    b._cached = np.array(jb._cached, bool)
    b.n_cached_idle = int(jb.n_cached_idle)
    pool._trash = int(jpool.trash_block)
    pool.tables = [None if t is None else
                   BlockTable(t.block_size, [int(x) for x in t.blocks],
                              int(t.n_cached_tokens))
                   for t in jpool.tables]
    pool._bt_np = np.array(jpool._bt_np, np.int32)
    pool._bt_dirty = True
    pool.pos = np.array(jpool._pos_np, np.int32)
    pool._free_rows = [int(x) for x in jpool._free_rows]
    pool.n_preemptions = int(jpool.n_preemptions)
    jc, c = jpool.prefix_cache, pool.prefix_cache
    if jc is not None:
        c._entries.update((key, int(blk)) for key, blk in jc._entries.items())
        c._key_of_block.update((int(blk), key)
                               for blk, key in jc._key_of_block.items())
        for name in ("lookups", "hits", "hit_tokens", "inserted_blocks",
                     "evicted_blocks", "probes"):
            setattr(c, name, int(getattr(jc, name)))
    return pool
