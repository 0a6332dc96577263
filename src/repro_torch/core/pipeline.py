"""Stages 2-3 of the paper's sparsification pipeline for one linear layer
(port of ``repro/core/pipeline.py``), on the path ``launch/serve.py --sparse``
takes: magnitude scoring, no SmoothQuant equalization, structured outliers,
variance correction.  The other scorers, SmoothQuant, unstructured outliers
and EBFT raise ``NotImplementedError`` (ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import scoring
from .outliers import StructuredOutliers, extract_structured_outliers
from .packing import PackedNM, pack_nm
from .patterns import nm_mask, parse_pattern
from .variance import apply_variance_correction


@dataclasses.dataclass(frozen=True)
class SparsifyConfig:
    """Variance correction is always on.  ``scorer``, ``use_smoothquant`` and
    ``unstructured_outliers`` exist only so that the unported modes raise."""

    weight_pattern: Any = "8:16"        # N:M for non-salient weights
    outlier_pattern: Any | None = "16:256"  # None => no outlier recovery
    scorer: str = "magnitude"
    use_smoothquant: bool = False
    unstructured_outliers: bool = False


@dataclasses.dataclass
class SparsifiedLinear:
    nm: PackedNM                         # VC-corrected non-salient weights
    outliers: StructuredOutliers | None  # exact salient weights (or None)
    nm_mask: torch.Tensor                # N:M kept positions
    salient_mask: torch.Tensor           # structured salient positions


def _check_ported(cfg: SparsifyConfig) -> None:
    if cfg.use_smoothquant:
        raise NotImplementedError(
            "SmoothQuant equalization is not ported yet (ROADMAP A7)")
    if cfg.unstructured_outliers:
        raise NotImplementedError(
            "unstructured outliers are not ported yet (ROADMAP A7)")


def sparsify_linear(w: torch.Tensor, stats, cfg: SparsifyConfig
                    ) -> SparsifiedLinear:
    """Run the pipeline's stages 2-3 on one weight matrix W [out, in]."""
    wp = parse_pattern(cfg.weight_pattern)
    if w.shape[-1] % wp.m:
        raise ValueError(
            f"in_dim {w.shape[-1]} not divisible by N:M block {wp.m}")
    _check_ported(cfg)
    s = scoring.score(cfg.scorer, w, stats)

    outliers = None
    salient_mask = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    if cfg.outlier_pattern is not None:
        op = parse_pattern(cfg.outlier_pattern)
        if w.shape[-1] % op.m:
            raise ValueError(
                f"in_dim {w.shape[-1]} not divisible by outlier block {op.m}")
        outliers = extract_structured_outliers(w, s, op)
        salient_mask = outliers.mask()

    keep = nm_mask(s, wp)

    nonsalient_kept = keep & ~salient_mask
    w_corr = apply_variance_correction(w, nonsalient_kept)

    # Salient positions inside N:M slots carry 0 so nm + outliers never
    # double-count; the slot stays allocated (the N:M invariant holds).
    nm = pack_nm(w_corr, keep, wp)
    return SparsifiedLinear(nm=nm, outliers=outliers, nm_mask=keep,
                            salient_mask=salient_mask)
