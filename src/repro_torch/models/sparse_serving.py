"""Sparse deployment: compressed N:M (+ structured outlier) containers in
place of dense projection weights (port of ``repro/models/sparse_serving.py``).

``SparseWeight`` holds exactly the deployed buffers, in the JAX package's
layouts.  ``sparse_apply`` hands them straight to the kernels, which is the
paper's deployment claim: on a CUDA tensor the fused kernel (outliers
present) or the N:M kernel (no outliers) runs; on a CPU tensor their plain
versions.  The JAX engine's own ``sparse_apply`` decompresses with a one-hot
einsum in ``x.dtype`` instead; the kernels accumulate in f32, so the two
agree at f32 up to summation order.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from ..core.outliers import OUTLIER_M, pack_outlier_meta
from ..core.patterns import parse_pattern
from ..core.pipeline import SparsifyConfig, sparsify_linear
from ..kernels.fused_sparse_linear import fused_sparse_linear
from ..kernels.nm_spmm import nm_spmm


@dataclasses.dataclass
class SparseWeight:
    """Compressed linear weight; stands in for a dense [out, in] tensor.

    ``v_scale`` (int8 N:M values with a per-row scale) belongs to the int8
    path, which is not ported yet (ROADMAP A6); it is None here."""

    nm_values: torch.Tensor               # [out, in*n/m] bf16
    nm_meta: torch.Tensor                 # [out, in/m] int32, 4-bit idx
    o_values: torch.Tensor | None         # [out, in/256, o_n]
    o_meta: torch.Tensor | None           # [out, in/256, o_n/4] int32
    v_scale: torch.Tensor | None          # [out] f32 (int8 mode)
    n: int
    m: int
    o_n: int
    in_dim: int

    def buffers(self) -> tuple:
        return tuple(v for v in (self.nm_values, self.nm_meta, self.o_values,
                                 self.o_meta, self.v_scale) if v is not None)

    def deployed_bytes(self) -> int:
        """Bytes this container ships to device memory: every buffer."""
        return sum(v.numel() * v.element_size() for v in self.buffers())

    def map(self, fn) -> "SparseWeight":
        """The same container with ``fn`` applied to every buffer."""
        def app(t):
            return None if t is None else fn(t)
        return dataclasses.replace(
            self, nm_values=app(self.nm_values), nm_meta=app(self.nm_meta),
            o_values=app(self.o_values), o_meta=app(self.o_meta),
            v_scale=app(self.v_scale))


def sparse_apply(sw: SparseWeight, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W_hat^T from the compressed buffers, through the kernels."""
    if sw.v_scale is not None:
        raise NotImplementedError(
            "int8 SparseWeight values are not ported yet (ROADMAP A6)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, sw.in_dim)
    if sw.o_values is None:
        y = nm_spmm(x2, sw.nm_values, sw.nm_meta, n=sw.n, m=sw.m)
    else:
        y = fused_sparse_linear(x2, sw.nm_values, sw.nm_meta, sw.o_values,
                                sw.o_meta, n=sw.n, m=sw.m, o_n=sw.o_n)
    return y.reshape(*lead, -1)


# --------------------------------------------------------------------------
# conversion
# --------------------------------------------------------------------------

# The dense family's projections; embed, lm_head and the norms stay dense.
# Other families' leaves join as their families are ported.
PRUNABLE = re.compile(r"wq|wk|wv|wo|w_gate|w_up|w_down")


def to_sparse_weight(w2d: torch.Tensor, scfg: SparsifyConfig,
                     stats=None) -> SparseWeight:
    sl = sparsify_linear(w2d, stats, scfg)
    nm, o = sl.nm, sl.outliers
    return SparseWeight(
        nm_values=nm.values.contiguous(), nm_meta=nm.packed_metadata(),
        o_values=None if o is None else o.values.contiguous(),
        o_meta=None if o is None else pack_outlier_meta(o.indices),
        v_scale=None, n=nm.n, m=nm.m, o_n=0 if o is None else o.n,
        in_dim=nm.in_dim)


def leaf_cfg(name: str, leaf, scfg: SparsifyConfig) -> SparsifyConfig | None:
    """Per-leaf config, or None to keep the leaf dense.  Layers too narrow
    for a 256-block lose outlier recovery but are still N:M-pruned."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim != 2:
        return None
    if not PRUNABLE.fullmatch(name.split("/")[-1]):
        return None
    wp = parse_pattern(scfg.weight_pattern)
    if leaf.shape[-1] % wp.m:
        return None
    if scfg.outlier_pattern is not None and leaf.shape[-1] % OUTLIER_M:
        return dataclasses.replace(scfg, outlier_pattern=None)
    return scfg


def _walk(tree, prefix: str, fn):
    """Apply ``fn(name, leaf)`` to every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _walk(v, f"{prefix}{k}/", fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, f"{prefix}{i}/", fn) for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def sparsify_for_serving(params, scfg: SparsifyConfig, stats_by_name=None,
                         quantize: bool = False):
    """Replace eligible projections with ``SparseWeight``; returns
    (params, report).  Leaves are named like the JAX package's pytree paths
    (``layers/3/wq`` for the port's per-layer list)."""
    if quantize:
        raise NotImplementedError(
            "int8 N:M values are not ported yet (ROADMAP A6)")
    report = {"n_layers_sparsified": 0, "dense_bytes": 0,
              "compressed_bytes": 0}

    def convert(name, leaf):
        cfg = leaf_cfg(name, leaf, scfg)
        if cfg is None:
            return leaf
        sw = to_sparse_weight(leaf, cfg, (stats_by_name or {}).get(name))
        report["n_layers_sparsified"] += 1
        report["dense_bytes"] += leaf.numel() * leaf.element_size()
        report["compressed_bytes"] += sw.deployed_bytes()
        return sw

    new_params = _walk(params, "", convert)
    report["ratio"] = report["compressed_bytes"] / max(report["dense_bytes"], 1)
    return new_params, report
