"""AdamW over the port's parameter trees (port of ``repro/optim/adamw.py``).

Written by hand rather than ``torch.optim.AdamW``, which has none of the
reference's global-norm clip, mask projection or bf16 moments:

- the gradients are clipped together to ``grad_clip`` of their global norm;
- the bias corrections are ``1 - beta ** t`` in f32;
- weight decay is decoupled, added to the update before the learning rate;
- the update is computed in f32 and cast back to each parameter's dtype;
- the moments are kept in ``state_dtype`` (bf16 halves their bytes);
- ``mask`` mirrors the params with ``None``/``True`` (train the leaf) or a
  bool tensor: the gradient is projected through it and positions off the
  mask keep their value (frozen-structure training).

``step`` is functional, as the reference's: it returns new params and a
new state and leaves its arguments untouched.
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32


def init(params, cfg: AdamWConfig) -> dict:
    def zeros():
        return unflatten(params, [torch.zeros(p.shape, dtype=cfg.state_dtype,
                                              device=p.device)
                                  for p in flatten(params)])
    device = flatten(params)[0].device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, sharding=None) -> torch.Tensor:
    """The norm of every leaf together.  With ``sharding``
    (``parallel.fsdp.StateSharding``) ``tree`` holds this rank's blocks:
    each distinct block's sum of squares is counted once (by one rank of
    those holding it, ``fsdp.owns``) and the sum is all-reduced over the
    mesh, so a leaf or axis that is replicated is not counted twice."""
    leaves = [torch.sum(torch.square(leaf.to(torch.float32)))
              for leaf in flatten(tree)]
    if sharding is not None:
        from ..parallel.fsdp import owns
        tm = sharding.tm
        leaves = [sq if owns(tm, spec) else torch.zeros_like(sq)
                  for sq, spec in zip(leaves, flatten(sharding.specs))]
        total = torch.sum(torch.stack(leaves))
        if tm.world_group is not None:
            torch.distributed.all_reduce(total, group=tm.world_group)
        return torch.sqrt(total)
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _is_projection(mk) -> bool:
    return mk is not None and mk is not True


@torch.no_grad()
def step(params, grads, state, cfg: AdamWConfig, lr_scale=1.0, mask=None,
         sharding=None):
    """Returns (new_params, new_state, {"grad_norm"}).  With ``sharding``
    the params, grads and moments are this rank's blocks: the clip reads
    the whole gradient's norm, and every other operation is elementwise,
    so each block is updated where it lies."""
    gnorm = global_norm(grads, sharding)
    clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            if cfg.grad_clip else 1.0)
    t = state["step"] + 1
    tf = t.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.beta1, dtype=torch.float32,
                                     device=tf.device), tf)
    b2c = 1 - torch.pow(torch.tensor(cfg.beta2, dtype=torch.float32,
                                     device=tf.device), tf)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v, mk):
        g = g.to(torch.float32) * clip
        if _is_projection(mk):
            g = g * mk.to(torch.float32)
        m_new = cfg.beta1 * m.to(torch.float32) + (1 - cfg.beta1) * g
        v_new = cfg.beta2 * v.to(torch.float32) + (1 - cfg.beta2) * g * g
        update = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        update = update + cfg.weight_decay * p.to(torch.float32)
        p_new = p.to(torch.float32) - lr * update
        if _is_projection(mk):
            p_new = torch.where(mk, p_new, p.to(torch.float32))
        return (p_new.to(p.dtype), m_new.to(cfg.state_dtype),
                v_new.to(cfg.state_dtype))

    flat_mask = flatten(mask) if mask is not None \
        else [None] * len(flatten(params))
    out = [upd(*args) for args in zip(
        flatten(params), flatten(grads), flatten(state["m"]),
        flatten(state["v"]), flat_mask)]
    new_state = {"m": unflatten(params, [o[1] for o in out]),
                 "v": unflatten(params, [o[2] for o in out]),
                 "step": t}
    return (unflatten(params, [o[0] for o in out]), new_state,
            {"grad_norm": gnorm})
