"""Weight-importance metrics for pruning (port of ``repro/core/scoring.py``).

Each returns a score shaped like ``W [out, in]``; higher is more important:

- ``magnitude``: |W|
- ``wanda``:     |W| * ||x_j||_2                       (Sun et al., 2023)
- ``ria``:       (|W_ij|/sum_j|W_ij| + |W_ij|/sum_i|W_ij|) * ||x_j||_2^a
                                                       (Zhang et al., 2024)

``ActStats`` accumulates the per-input-channel statistics a calibration pass
gives (sum of squares and max-abs), which RIA, Wanda and SmoothQuant read.
"""
from __future__ import annotations

import dataclasses

import torch

EPS = 1e-8


@dataclasses.dataclass
class ActStats:
    """Streaming per-channel activation statistics of one linear's input."""

    sq_sum: torch.Tensor   # [in]  sum of x_j^2 over the calibration tokens
    max_abs: torch.Tensor  # [in]  max |x_j|
    count: torch.Tensor    # []    number of tokens seen (f32)

    @staticmethod
    def init(in_dim: int, dtype=torch.float32, device="cpu") -> "ActStats":
        return ActStats(sq_sum=torch.zeros((in_dim,), dtype=dtype,
                                           device=device),
                        max_abs=torch.zeros((in_dim,), dtype=dtype,
                                            device=device),
                        count=torch.zeros((), dtype=dtype, device=device))

    def update(self, x: torch.Tensor) -> "ActStats":
        """x: [..., in], the activations feeding this linear layer."""
        xf = x.reshape(-1, x.shape[-1]).to(self.sq_sum.dtype)
        return ActStats(
            sq_sum=self.sq_sum + torch.sum(xf * xf, dim=0),
            max_abs=torch.maximum(self.max_abs, xf.abs().amax(dim=0)),
            count=self.count + xf.shape[0])

    @property
    def l2(self) -> torch.Tensor:
        """||x_j||_2 over the calibration set."""
        return torch.sqrt(self.sq_sum + EPS)


def magnitude_score(w: torch.Tensor) -> torch.Tensor:
    return torch.abs(w)


def wanda_score(w: torch.Tensor, stats: ActStats) -> torch.Tensor:
    """|W_ij| * ||x_j||_2 (f32 where ``w`` is narrower, as JAX promotes)."""
    return torch.abs(w) * stats.l2[None, :]


def ria_score(w: torch.Tensor, act_l2: torch.Tensor,
              alpha: float = 0.5) -> torch.Tensor:
    """Relative Importance and Activations, in f32 whatever ``w``'s dtype:
    sums of |W| along each row (over inputs) and each column (over
    outputs)."""
    a = torch.abs(w.to(torch.float32))
    row_sum = a.sum(dim=1, keepdim=True)     # [out, 1]
    col_sum = a.sum(dim=0, keepdim=True)     # [1, in]
    rel = a / (row_sum + EPS) + a / (col_sum + EPS)
    return rel * (act_l2[None, :] + EPS) ** alpha


SCORERS = ("magnitude", "wanda", "ria")


def score(method: str, w: torch.Tensor, stats: ActStats | None = None,
          alpha: float = 0.5) -> torch.Tensor:
    """Dispatch; ``stats`` is required for wanda and ria."""
    if method == "magnitude":
        return magnitude_score(w)
    if method in ("wanda", "ria") and stats is None:
        raise ValueError(f"{method} requires activation stats")
    if method == "wanda":
        return wanda_score(w, stats)
    if method == "ria":
        return ria_score(w, stats.l2, alpha)
    raise ValueError(f"unknown scorer {method!r}; options: {SCORERS}")
