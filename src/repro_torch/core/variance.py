"""Variance Correction (paper §4.2, Eq. 2; port of ``repro/core/variance.py``).

    W_kept_corrected = W_kept * sqrt( Var(W_dense) / (Var(W_kept) + eps) )

Only non-salient kept weights are rescaled; salient (outlier) weights are
stored exactly.  The variance is taken over the whole weight matrix.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def _masked_var(w: torch.Tensor, mask: torch.Tensor):
    """Biased variance of w over entries where mask is True."""
    wf = w.to(torch.float32)
    m = mask.to(torch.float32)
    n = torch.sum(m).clamp_min(1.0)
    mean = torch.sum(wf * m) / n
    return torch.sum(m * (wf - mean) ** 2) / n


def variance_correction_factor(w_dense: torch.Tensor,
                               kept_mask: torch.Tensor) -> torch.Tensor:
    """sqrt(Var(W_dense) / (Var(W_kept) + eps)); 1 where not finite."""
    var_dense = torch.var(w_dense.to(torch.float32), correction=0)
    var_kept = _masked_var(w_dense, kept_mask)
    factor = torch.sqrt(var_dense / (var_kept + EPS))
    return torch.where(torch.isfinite(factor), factor,
                       torch.ones_like(factor))


def apply_variance_correction(w_dense: torch.Tensor,
                              kept_mask: torch.Tensor) -> torch.Tensor:
    """Pruned-and-corrected weights: zeros off-mask, rescaled on-mask."""
    factor = variance_correction_factor(w_dense, kept_mask)
    w_kept = torch.where(kept_mask, w_dense.to(torch.float32),
                         torch.zeros((), device=w_dense.device))
    return (w_kept * factor).to(w_dense.dtype)
