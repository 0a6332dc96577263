"""Weight-importance metrics (port of ``repro/core/scoring.py``).

Only ``magnitude`` (|W|) is ported: it is the scorer of the serving path
(``launch/serve.py --sparse``).  Wanda and RIA need calibration statistics
and come with the rest of the offline pipeline (ROADMAP A7).
"""
from __future__ import annotations

import torch

SCORERS = ("magnitude", "wanda", "ria")


def magnitude_score(w: torch.Tensor) -> torch.Tensor:
    return torch.abs(w)


def score(method: str, w: torch.Tensor, stats=None) -> torch.Tensor:
    if method == "magnitude":
        return magnitude_score(w)
    if method in SCORERS:
        raise NotImplementedError(
            f"scorer {method!r} is not ported yet (ROADMAP A7: the paper's "
            f"offline pipeline)")
    raise ValueError(f"unknown scorer {method!r}; options: {SCORERS}")
