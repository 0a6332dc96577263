"""Sparse deployment: compressed N:M (+ structured outlier) containers in
place of dense projection weights (port of ``repro/models/sparse_serving.py``).

``SparseWeight`` holds exactly the deployed buffers, in the JAX package's
layouts: bf16 N:M values, or (``quantize=True``) int8 N:M values with a
per-out-row f32 absmax scale ``v_scale``, beside exact bf16 outliers.
``sparse_apply`` hands them straight to the kernels, which is the paper's
deployment claim: on a CUDA tensor the fused kernel (outliers present) or
the N:M kernel (no outliers) runs, in its int8 variant when ``v_scale`` is
set; on a CPU tensor their plain versions.  The JAX engine's own ``sparse_apply`` decompresses with a one-hot
einsum in ``x.dtype`` instead; the kernels accumulate in f32, so the two
agree at f32 up to summation order.

``densify``/``densify_params`` rebuild the dense weights a container
stands for (speculative decoding's dense target of an 8:16 draft).  The
served pytree then runs ``F.linear`` as the reference's dense path runs a
plain matmul.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from ..core.outliers import pack_outlier_meta, unpack_outlier_meta
from ..core.packing import unpack_metadata
from ..core.pipeline import (SparsifyConfig, fit_config, map_leaves,
                             sparsify_linear)
from ..kernels.fused_sparse_linear import fused_sparse_linear
from ..kernels.nm_spmm import nm_spmm
from ..kernels.ref import decompress_nm, dequantize, quantize_int8


@dataclasses.dataclass
class SparseWeight:
    """Compressed linear weight; stands in for a dense [out, in] tensor.

    ``v_scale`` is not None when ``nm_values`` are int8: value = int8 x
    ``v_scale[row]``.  The outliers stay exact bf16."""

    nm_values: torch.Tensor               # [out, in*n/m] bf16 | int8
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
    """y = x @ W_hat^T from the compressed buffers, through the kernels;
    ``v_scale`` goes with them and dequantizes int8 values."""
    lead = x.shape[:-1]
    # the kernels take a contiguous [M, in]; a slice of a wider activation
    # (xLSTM's cell input, one half of its up-projection) is copied once
    x2 = x.reshape(-1, sw.in_dim).contiguous()
    if sw.o_values is None:
        y = nm_spmm(x2, sw.nm_values, sw.nm_meta, n=sw.n, m=sw.m,
                    scale=sw.v_scale)
    else:
        y = fused_sparse_linear(x2, sw.nm_values, sw.nm_meta, sw.o_values,
                                sw.o_meta, n=sw.n, m=sw.m, o_n=sw.o_n,
                                scale=sw.v_scale)
    return y.reshape(*lead, -1)


def densify(sw: SparseWeight) -> torch.Tensor:
    """Dense [out, in] reconstruction of the deployed buffers, bit for bit
    the reference's ``densify`` (``repro/models/sparse_serving.py:117``).

    Int8 values are multiplied by ``v_scale`` in f32 and rounded once to
    bf16, as there.  The reference sums one-hot products; each N:M slot
    and each outlier slot receives one value, so a scatter gives the same
    bits.  The outliers are summed in f32 (where a group repeats an index,
    as the one-hot sum would), rounded to their dtype and added to the N:M
    part in the weight's dtype."""
    values = dequantize(sw.nm_values, sw.v_scale, torch.bfloat16)
    w = decompress_nm(values, unpack_metadata(sw.nm_meta, sw.n), sw.m)
    if sw.o_values is not None:
        idx = unpack_outlier_meta(sw.o_meta, sw.o_n).long()
        o = torch.zeros((*idx.shape[:-1], 256), dtype=torch.float32,
                        device=idx.device)
        o.scatter_add_(-1, idx, sw.o_values.to(torch.float32))
        w = w + o.to(sw.o_values.dtype).reshape(w.shape)
    return w


def densify_params(params):
    """The served pytree with every ``SparseWeight`` replaced by
    ``densify`` of it; dense leaves pass through (the same tensors)."""
    return map_leaves(params, lambda _, leaf: densify(leaf)
                      if isinstance(leaf, SparseWeight) else leaf)


# --------------------------------------------------------------------------
# conversion
# --------------------------------------------------------------------------

# The reference's projection names (every family's) and the leaves that
# stay dense whatever their name: the norms (qwen3's q_norm/k_norm
# included), embed (a tied head too), lm_head, routers and recurrent gates.
PRUNABLE = re.compile(
    r"wq|wk|wv|wo|w_gate|w_up|w_down|ws_gate|ws_up|ws_down|in_proj|out_proj|"
    r"w_q|w_k|w_v|w_slstm|c_wq|c_wk|c_wv|c_wo")
SKIP = re.compile(r"norm|embed|lm_head|router|gates|A_log|dt_bias|\bD\b")


def to_sparse_weight(w2d: torch.Tensor, scfg: SparsifyConfig,
                     stats=None, quantize: bool = False) -> SparseWeight:
    """Compress one [out, in] weight; ``quantize=True`` stores the N:M
    values as int8 with a per-row scale (``kernels/ref.quantize_int8``) and
    keeps the outliers exact."""
    sl = sparsify_linear(w2d, stats, scfg)
    nm, o = sl.nm, sl.outliers
    values, v_scale = nm.values.contiguous(), None
    if quantize:
        values, v_scale = quantize_int8(values)
    return SparseWeight(
        nm_values=values, nm_meta=nm.packed_metadata(),
        o_values=None if o is None else o.values.contiguous(),
        o_meta=None if o is None else pack_outlier_meta(o.indices),
        v_scale=v_scale, n=nm.n, m=nm.m, o_n=0 if o is None else o.n,
        in_dim=nm.in_dim)


def leaf_cfg(name: str, leaf, scfg: SparsifyConfig) -> SparsifyConfig | None:
    """Per-leaf config, or None to keep the leaf dense: the reference's rule
    (``SKIP`` searched in the path, ``PRUNABLE`` in the leaf's own name) on
    the port's per-layer leaves, which are 2-D where the reference's
    stacked ones are 3-D.  Layers too narrow for a 256-block lose outlier
    recovery but are still N:M-pruned."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim != 2:
        return None
    if SKIP.search(name) or not PRUNABLE.search(name.split("/")[-1]):
        return None
    return fit_config(leaf.shape[-1], scfg)


def sparsify_for_serving(params, scfg: SparsifyConfig, stats_by_name=None,
                         quantize: bool = False):
    """Replace eligible projections with ``SparseWeight``; returns
    (params, report).  Leaves are named like the JAX package's pytree paths
    (``layers/3/wq`` for the port's per-layer list).  ``quantize=True``
    deploys int8 N:M values with exact bf16 outliers; the report's
    ``compressed_bytes`` count the scales."""
    report = {"n_layers_sparsified": 0, "dense_bytes": 0,
              "compressed_bytes": 0}

    def convert(name, leaf):
        cfg = leaf_cfg(name, leaf, scfg)
        if cfg is None:
            return leaf
        sw = to_sparse_weight(leaf, cfg, (stats_by_name or {}).get(name),
                              quantize=quantize)
        report["n_layers_sparsified"] += 1
        report["dense_bytes"] += leaf.numel() * leaf.element_size()
        report["compressed_bytes"] += sw.deployed_bytes()
        return sw

    new_params = map_leaves(params, convert)
    report["ratio"] = report["compressed_bytes"] / max(report["dense_bytes"], 1)
    return new_params, report
