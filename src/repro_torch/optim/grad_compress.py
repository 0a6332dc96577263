"""Int8 gradient compression with error feedback (port of
``repro/optim/grad_compress.py``).

Each leaf is scaled by its own absmax to int8 (``round`` is half to even,
as ``jnp.round``), and what the rounding lost is carried to the next call
(error feedback, Seide et al. 2014).  ``launch/steps.make_train_step``
compresses each microbatch's gradients this way before summing them; on a
mesh it compresses the rank's blocks of the global gradient, each leaf
with its whole absmax (``all_max``), as the reference compresses the
global gradient.
"""
from __future__ import annotations

import torch

from ..tree import flatten, unflatten


def _quantize(g: torch.Tensor, all_max=None):
    """(int8 values, f32 scale) of ``g`` by its absmax; ``all_max`` turns
    a block's absmax into its whole leaf's (a max over the leaf's
    blocks), so every rank uses one scale."""
    a = torch.max(torch.abs(g))
    if all_max is not None:
        a = all_max(a)
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


def compress_with_feedback(grads, error, all_max=None):
    """Returns ((q int8, scale f32) per leaf, new_error).  ``all_max``
    (for blocks of a sharded tree) is one callable a leaf, in
    ``flatten``'s order, each giving the leaf's absmax from a block's."""
    outs = []
    maxes = all_max if all_max is not None else [None] * len(flatten(grads))
    for g, e, am in zip(flatten(grads), flatten(error), maxes):
        gf = g.to(torch.float32) + e
        q, s = _quantize(gf, am)
        outs.append(((q, s), gf - _dequantize(q, s, torch.float32)))
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def decompress(qs, like):
    """Each leaf's (q, scale) back in the dtype of ``like``'s leaf."""
    return unflatten(like, [_dequantize(q, s, leaf.dtype) for (q, s), leaf
                            in zip(flatten(qs), flatten(like))])
