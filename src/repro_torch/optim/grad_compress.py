"""Int8 gradient compression with error feedback (port of
``repro/optim/grad_compress.py``).

Each leaf is scaled by its own absmax to int8 (``round`` is half to even,
as ``jnp.round``), and what the rounding lost is carried to the next call
(error feedback, Seide et al. 2014).  ``launch/steps.make_train_step``
compresses each microbatch's gradients this way before summing them.
"""
from __future__ import annotations

import torch

from ..tree import flatten, unflatten


def _quantize(g: torch.Tensor):
    a = torch.max(torch.abs(g))
    scale = torch.where(a > 0, a / 127.0, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def init_error(params):
    """A zero f32 error per leaf."""
    return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                              for p in flatten(params)])


def compress_with_feedback(grads, error):
    """Returns ((q int8, scale f32) per leaf, new_error)."""
    outs = []
    for g, e in zip(flatten(grads), flatten(error)):
        gf = g.to(torch.float32) + e
        q, s = _quantize(gf)
        outs.append(((q, s), gf - _dequantize(q, s, torch.float32)))
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def decompress(qs, like):
    """Each leaf's (q, scale) back in the dtype of ``like``'s leaf."""
    return unflatten(like, [_dequantize(q, s, leaf.dtype) for (q, s), leaf
                            in zip(flatten(qs), flatten(like))])
