"""EBFT, Efficient Blockwise Fine-Tuning (Guo et al., 2024; the paper's
stage 4; port of ``repro/core/ebft.py``).

The model is tuned one block at a time (one transformer block is one EBFT
unit).  For each block, with a frozen sparsity mask M, the block-output
reconstruction error against the *dense* block's outputs on calibration
data is minimised over the non-salient kept weights only:

    min_{W ⊙ M}  || f_block(X; W ⊙ M) - f_block(X; W_dense) ||_F^2

The gradient is projected through the mask and the new weights multiplied
by it after every step, so W stays exactly N:M structured.  Adam runs on
the masked weights; the RMSNorm scales are trainable too (the paper tunes
"only W_nonsalient and BatchNorm parameters"), everything else is frozen.

The mask is the pipeline's ``SparsifiedLinear.nonsalient_kept_mask``.
With structured outliers that mask is False at the salient positions, so
``p_new * mask`` zeroes the salient weights of the dense-effective matrix
after the first step, in the reference as here (a property of the
reference, kept as it is).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..tree import flatten, unflatten, value_and_grad
from .pipeline import map_leaves


@dataclasses.dataclass(frozen=True)
class EBFTConfig:
    steps: int = 100
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    batch_size: int = 8
    train_norms: bool = True


def _is_norm_path(name: str) -> bool:
    return "norm" in name.lower() or "scale" in name.lower()


def masked_adam_init(params) -> dict:
    def zeros():
        return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                                  for p in flatten(params)])
    device = flatten(params)[0].device
    return dict(m=zeros(), v=zeros(),
                step=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def masked_adam_step(params, grads, state, masks, cfg: EBFTConfig):
    """One Adam step; the gradient (and so the update) is zeroed off-mask.

    ``masks`` mirrors params: a bool tensor for a masked leaf, ``None`` or
    ``True`` for a fully trainable one, ``False`` for a frozen one (its
    value and moments are returned as they were)."""
    step = state["step"] + 1

    def upd(p, g, m, v, mask):
        if mask is False:
            return p, m, v
        g = g.to(torch.float32)
        projected = mask is not None and mask is not True
        if projected:
            g = g * mask.to(torch.float32)
        m_new = cfg.beta1 * m + (1 - cfg.beta1) * g
        v_new = cfg.beta2 * v + (1 - cfg.beta2) * g * g
        mhat = m_new / (1 - cfg.beta1 ** step)
        vhat = v_new / (1 - cfg.beta2 ** step)
        delta = cfg.lr * mhat / (torch.sqrt(vhat) + cfg.eps)
        p_new = p.to(torch.float32) - delta
        if projected:
            p_new = p_new * mask.to(torch.float32)   # keep exact sparsity
        return p_new.to(p.dtype), m_new, v_new

    out = [upd(*args) for args in zip(
        flatten(params), flatten(grads), flatten(state["m"]),
        flatten(state["v"]), flatten(masks))]
    return (unflatten(params, [o[0] for o in out]),
            dict(m=unflatten(params, [o[1] for o in out]),
                 v=unflatten(params, [o[2] for o in out]), step=step))


def ebft_block(block_fn: Callable, sparse_params, dense_params, masks,
               calib_inputs: torch.Tensor, cfg: EBFTConfig,
               extra_inputs: tuple = ()) -> tuple:
    """Fine-tune one block to match its dense teacher.

    ``block_fn(params, x, *extra) -> y``.  ``masks`` mirrors
    ``sparse_params`` (``make_block_masks``).  ``calib_inputs``
    [n_calib, ...] are the block's inputs; the targets are the dense
    block's outputs on them.  Step i trains on the ``batch_size`` rows from
    ``(i * batch_size) % max(n - batch_size + 1, 1)``.

    Returns (tuned_params, losses[steps]): each loss is the f32 mean squared
    error of the step's batch before its update."""
    with torch.no_grad():
        targets = block_fn(dense_params, calib_inputs, *extra_inputs)

    def loss_fn(p, x, y):
        pred = block_fn(p, x, *extra_inputs)
        return torch.mean((pred.to(torch.float32) - y.to(torch.float32)) ** 2)

    opt = masked_adam_init(sparse_params)
    n = calib_inputs.shape[0]
    bs = min(cfg.batch_size, n)
    params = sparse_params
    losses = []
    for i in range(cfg.steps):
        s = (i * bs) % max(n - bs + 1, 1)
        loss, grads = value_and_grad(loss_fn, params, calib_inputs[s:s + bs],
                                     targets[s:s + bs])
        params, opt = masked_adam_step(params, grads, opt, masks, cfg)
        losses.append(float(loss))
    return params, losses


def make_block_masks(sparse_params, mask_by_path: dict,
                     train_norms: bool = True):
    """The mask tree of one block's params: ``mask_by_path`` {leaf path:
    bool tensor} for the pruned weights (paths named as
    ``map_leaves`` names them: ``wq``, ``layers/3/wq``), True on norm
    scales (trainable) when ``train_norms``, False elsewhere (frozen)."""
    def mask(name, leaf):
        if name in mask_by_path:
            return mask_by_path[name]
        return bool(train_norms and _is_norm_path(name))
    return map_leaves(sparse_params, mask)
