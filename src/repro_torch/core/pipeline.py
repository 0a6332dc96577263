"""The paper's sparsification pipeline, stages 1-3 (§4; port of
``repro/core/pipeline.py``).

Per linear layer W [out, in] with calibration activation statistics:

  1. Weights equalization: a SmoothQuant-style W_ec used ONLY for scoring.
  2. Importance-aware pruning: RIA (or Wanda, magnitude) on W_ec; salient
     weights kept exactly in a structured [4|8|16]:256 pattern (or, for the
     Table 7 baseline, an unstructured global top-k at the same budget);
     the rest pruned to N:M.
  3. Variance correction: the kept non-salient weights rescaled to restore
     Var(W_dense), per matrix or per output row.

Stage 4 (EBFT, blockwise fine-tuning) is ``core/ebft.py``.  The
single-layer entry point is ``sparsify_linear``; ``sparsify_tree`` walks a
model's parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import scoring
from .equalize import equalized_view_for_scoring
from .outliers import (StructuredOutliers, extract_structured_outliers,
                       unstructured_outlier_mask)
from .packing import PackedNM, pack_nm
from .patterns import nm_mask, parse_pattern
from .variance import apply_variance_correction


@dataclasses.dataclass(frozen=True)
class SparsifyConfig:
    weight_pattern: Any = "8:16"        # N:M for non-salient weights
    outlier_pattern: Any | None = "16:256"  # None => no outlier recovery
    scorer: str = "ria"                 # magnitude | wanda | ria
    ria_alpha: float = 0.5
    use_smoothquant: bool = True        # stage 1 on/off
    sq_alpha: float | None = None       # None => paper Eq. 1; else interp.
    use_variance_correction: bool = True
    vc_per_row: bool = False            # beyond-paper knob
    unstructured_outliers: bool = False  # Table 7 baseline, matched budget


@dataclasses.dataclass
class SparsifiedLinear:
    """Deployable result for one linear layer, with the masks kept for
    fine-tuning and analysis."""

    nm: PackedNM                         # VC-corrected non-salient weights
    outliers: StructuredOutliers | None  # exact salient weights (or None)
    nm_mask: torch.Tensor                # N:M kept positions
    salient_mask: torch.Tensor           # salient positions

    def to_dense(self) -> torch.Tensor:
        w = self.nm.to_dense()
        if self.outliers is not None:
            w = torch.where(self.outliers.mask(), torch.zeros_like(w), w) \
                + self.outliers.to_dense()
        return w

    @property
    def effective_mask(self) -> torch.Tensor:
        if self.outliers is None:
            return self.nm_mask
        return self.nm_mask | self.salient_mask

    @property
    def nonsalient_kept_mask(self) -> torch.Tensor:
        """The positions fine-tuning may train: kept by N:M, not salient."""
        if self.outliers is None:
            return self.nm_mask
        return self.nm_mask & ~self.salient_mask


def sparsify_linear(w: torch.Tensor, stats: scoring.ActStats | None,
                    cfg: SparsifyConfig) -> SparsifiedLinear:
    """Run stages 1-3 on one weight matrix W [out, in]."""
    wp = parse_pattern(cfg.weight_pattern)
    if w.shape[-1] % wp.m:
        raise ValueError(
            f"in_dim {w.shape[-1]} not divisible by N:M block {wp.m}")

    # stage 1: the equalized view, for scoring only
    w_view = w
    if cfg.use_smoothquant and stats is not None:
        w_view = equalized_view_for_scoring(w, stats.max_abs, cfg.sq_alpha)

    # stage 2: importance, salient isolation, N:M pruning
    s = scoring.score(cfg.scorer, w_view, stats, cfg.ria_alpha)
    outliers = None
    salient_mask = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    if cfg.outlier_pattern is not None:
        op = parse_pattern(cfg.outlier_pattern)
        if cfg.unstructured_outliers:
            # kept exactly in the dense weight (dense_effective_weight), not
            # in a container
            salient_mask = unstructured_outlier_mask(s, op.density)
        else:
            if w.shape[-1] % op.m:
                raise ValueError(f"in_dim {w.shape[-1]} not divisible by "
                                 f"outlier block {op.m}")
            outliers = extract_structured_outliers(w, s, op)
            salient_mask = outliers.mask()
    keep = nm_mask(s, wp)
    del s

    # stage 3: variance correction of the kept non-salient weights
    nonsalient_kept = keep & ~salient_mask
    if cfg.use_variance_correction:
        w_corr = apply_variance_correction(w, nonsalient_kept, cfg.vc_per_row)
    else:
        w_corr = torch.where(nonsalient_kept, w, torch.zeros_like(w))

    # Salient positions inside N:M slots carry 0, so nm + outliers never
    # double-count; the slot stays allocated (the N:M invariant holds).
    nm = pack_nm(w_corr, keep, wp)
    return SparsifiedLinear(nm=nm, outliers=outliers, nm_mask=keep,
                            salient_mask=salient_mask)


def dense_effective_weight(w_dense: torch.Tensor, sl: SparsifiedLinear,
                           cfg: SparsifyConfig) -> torch.Tensor:
    """Dense materialization of the deployed weight, in ``w_dense``'s
    dtype; unstructured outliers are the dense weight's own values."""
    w = sl.nm.to_dense()
    if sl.outliers is not None:
        w = torch.where(sl.outliers.mask(), torch.zeros_like(w), w) \
            + sl.outliers.to_dense()
    elif cfg.unstructured_outliers and cfg.outlier_pattern is not None:
        w = torch.where(sl.salient_mask, w_dense, w)
    return w.to(w_dense.dtype)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

def default_prunable(path: str, leaf) -> bool:
    """Prune 2-D projection matrices; skip embeddings, norms, router, head."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    skip = ("embed", "norm", "router", "lm_head", "scale", "bias", "pos")
    return not any(s in path.lower() for s in skip)


def map_leaves(tree, fn, prefix: str = ""):
    """Apply ``fn(path, leaf)`` to every leaf of nested dicts and lists,
    with paths named like the JAX package's pytree paths (``layers/3/wq``
    for the port's per-layer list)."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def fit_config(in_dim: int, cfg: SparsifyConfig) -> SparsifyConfig | None:
    """``cfg`` for a weight of this in-dim, or None to leave it dense: no
    N:M where in_dim is not a multiple of M, no outliers where it is not a
    multiple of the outlier block."""
    if in_dim % parse_pattern(cfg.weight_pattern).m:
        return None
    if cfg.outlier_pattern is not None and \
            in_dim % parse_pattern(cfg.outlier_pattern).m:
        return dataclasses.replace(cfg, outlier_pattern=None)
    return cfg


def sparsify_tree(params, stats_by_name: dict, cfg: SparsifyConfig,
                  prunable: Callable[[str, Any], bool] = default_prunable):
    """Stages 1-3 across a parameter tree, one 2-D leaf at a time.

    ``stats_by_name`` maps a leaf path (``layers/{i}/wq``) to its
    ``ActStats``; a missing entry falls back to activation-free scoring.
    The JAX package stacks layers [L, out, in] and vmaps; the port's layer
    list gives each layer its own leaf and its own statistics.  Returns
    (params with dense-effective weights, {path: SparsifiedLinear})."""
    records = {}

    def convert(name, leaf):
        if not prunable(name, leaf) or leaf.ndim != 2:
            return leaf
        st = stats_by_name.get(name)
        layer_cfg = cfg
        if st is None and cfg.scorer != "magnitude":
            # no statistics: the uniform-activation limit of Wanda and RIA
            layer_cfg = dataclasses.replace(cfg, scorer="magnitude",
                                            use_smoothquant=False)
        layer_cfg = fit_config(leaf.shape[-1], layer_cfg)
        if layer_cfg is None:
            return leaf
        sl = sparsify_linear(leaf, st, layer_cfg)
        records[name] = sl
        return dense_effective_weight(leaf, sl, layer_cfg)

    return map_leaves(params, convert), records
