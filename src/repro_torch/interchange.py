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
"""
from __future__ import annotations

import numpy as np
import torch

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
