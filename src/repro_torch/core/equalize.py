"""SmoothQuant-inspired weight equalization (paper §4.1; port of
``repro/core/equalize.py``).

Channel-wise scales  s_j = max|x_j| / max|W_:,j|  redistribute importance
between activations and weights:

    W_ec = W @ diag(s)^-1 ,   x_scaled = x * s        (Eq. 1)

W_ec is used ONLY to compute the pruning score (the paper's
"Implementation Note"): the stored weights and the activations are never
changed.
"""
from __future__ import annotations

import torch

EPS = 1e-8


def smoothquant_scales(w: torch.Tensor, act_max_abs: torch.Tensor,
                       alpha: float | None = None) -> torch.Tensor:
    """Per-input-channel scales s_j in f32: Eq. 1's
    ``max|x_j| / max|W_:,j|`` by default, SmoothQuant's
    ``max|x_j|^alpha / max|W_:,j|^(1-alpha)`` with ``alpha``.  A dead
    channel (max|x_j| <= eps) gets scale 1."""
    w_max = torch.abs(w.to(torch.float32)).amax(dim=0)          # [in]
    x_max = act_max_abs.to(torch.float32)
    if alpha is None:
        s = x_max / (w_max + EPS)
    else:
        s = (x_max + EPS) ** alpha / (w_max + EPS) ** (1.0 - alpha)
    return torch.where(x_max <= EPS, torch.ones_like(s), s.clamp_min(EPS))


def equalize_weights(w: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """W_ec = W * s_j per input channel, in ``w``'s dtype (the scales are
    rounded to it first, as the JAX package does).  With x / s_j the
    product is unchanged; channels with large activations get their
    weights inflated in the score."""
    return w * scales[None, :].to(w.dtype)


def equalized_view_for_scoring(w: torch.Tensor, act_max_abs: torch.Tensor,
                               alpha: float | None = None) -> torch.Tensor:
    """The W_ec the pipeline scores (weights unchanged)."""
    return equalize_weights(w, smoothquant_scales(w, act_max_abs, alpha))


def check_equivalence(w: torch.Tensor, x: torch.Tensor,
                      scales: torch.Tensor):
    """(W*s)(x/s) and W x: the Eq. 1 invariant, for tests."""
    lhs = (x / scales) @ equalize_weights(w, scales).T
    rhs = x @ w.T
    return lhs, rhs
