"""Variance Correction (paper §4.2, Eq. 2; port of ``repro/core/variance.py``).

    W_kept_corrected = W_kept * sqrt( Var(W_dense) / (Var(W_kept) + eps) )

Only non-salient kept weights are rescaled; salient (outlier) weights are
stored exactly.  The variance is taken over the whole weight matrix (the
paper's layer-wise granularity), or per output row with ``per_row=True``
(a knob beyond the paper).
"""
from __future__ import annotations

import torch

EPS = 1e-12


def _masked_var(w: torch.Tensor, mask: torch.Tensor, axis=None):
    """Biased variance of w over entries where mask is True, over the whole
    matrix (``axis=None``) or along ``axis`` with the dimension kept."""
    wf = w.to(torch.float32)
    m = mask.to(torch.float32)
    dims = {} if axis is None else {"dim": axis, "keepdim": True}
    n = torch.sum(m, **dims).clamp_min(1.0)
    mean = torch.sum(wf * m, **dims) / n
    return torch.sum(m * (wf - mean) ** 2, **dims) / n


def variance_correction_factor(w_dense: torch.Tensor, kept_mask: torch.Tensor,
                               per_row: bool = False) -> torch.Tensor:
    """sqrt(Var(W_dense) / (Var(W_kept) + eps)), per matrix or per output
    row ([out, 1]); 1 where it is not finite."""
    wf = w_dense.to(torch.float32)
    if per_row:
        var_dense = torch.var(wf, dim=1, correction=0, keepdim=True)
        var_kept = _masked_var(w_dense, kept_mask, axis=1)
    else:
        var_dense = torch.var(wf, correction=0)
        var_kept = _masked_var(w_dense, kept_mask)
    factor = torch.sqrt(var_dense / (var_kept + EPS))
    return torch.where(torch.isfinite(factor), factor,
                       torch.ones_like(factor))


def apply_variance_correction(w_dense: torch.Tensor, kept_mask: torch.Tensor,
                              per_row: bool = False) -> torch.Tensor:
    """Pruned-and-corrected weights: zeros off-mask, rescaled on-mask."""
    factor = variance_correction_factor(w_dense, kept_mask, per_row)
    w_kept = torch.where(kept_mask, w_dense.to(torch.float32),
                         torch.zeros((), device=w_dense.device))
    return (w_kept * factor).to(w_dense.dtype)
