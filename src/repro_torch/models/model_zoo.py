"""Uniform model API over the ported families (port of
``repro/models/model_zoo.py``).

  zoo = get_model(cfg)
  params = zoo.init(generator)
  loss, aux = zoo.loss(params, batch)
  logits, caches = zoo.prefill(params, batch)
  logits, caches = zoo.decode(params, caches, batch)

The dense family and the vlm backbone run ``models/transformer.py``; the
moe, ssm, hybrid and encdec families raise NotImplementedError naming
their ROADMAP item (``configs.FAMILY_ITEMS``).  ``input_specs`` and
``cache_specs`` give the (shape, dtype) of every input of a step and of
the decode cache, as the reference's ``ShapeDtypeStruct`` stand-ins do,
without allocating.  The reference's ``param_specs`` waits for the dry-run
tools (ROADMAP A14b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..configs import family_not_ported
from . import transformer as tfm

TRANSFORMER_FAMILIES = ("dense", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelZoo:
    cfg: Any
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable | None = None


def _check_family(cfg) -> None:
    err = family_not_ported(cfg)
    if err is not None:
        raise err
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def get_model(cfg, device="cuda") -> ModelZoo:
    """The zoo entry of ``cfg``'s family; parameters and caches on
    ``device``."""
    _check_family(cfg)
    return ModelZoo(
        cfg=cfg,
        init=lambda generator: tfm.init_params(cfg, generator, device),
        loss=lambda p, b: tfm.loss_fn(p, b, cfg),
        prefill=lambda p, b: tfm.prefill(p, b, cfg),
        decode=lambda p, c, b: tfm.decode_lockstep(p, c, b, cfg),
        init_cache=lambda bs, ml: tfm.init_cache(cfg, bs, ml, device),
    )


# --------------------------------------------------------------------------
# input and cache specs: (shape, dtype) stand-ins, no allocation
# --------------------------------------------------------------------------

def input_specs(cfg, shape) -> dict:
    """(shape, dtype) of each input of the step ``shape.kind`` names.

    train:   {"tokens"/"embeds", "labels", ...}
    prefill: the prompt batch
    decode:  {"tokens": [B, 1]} (the cache: ``cache_specs``)."""
    _check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "vlm":
        base = {"embeds": ((B, S, cfg.d_model), cfg.dtype),
                "positions": ((3, B, S), i32)}
    else:
        base = {"tokens": ((B, S), i32)}
    if shape.kind == "train":
        return {**base, "labels": ((B, S), i32)}
    if shape.kind == "prefill":
        return base
    return {"tokens": ((B, 1), i32)}


def cache_specs(cfg, shape) -> dict:
    """(shape, dtype) of each leaf of the decode cache."""
    _check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    kv = ((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd), cfg.dtype)
    return {"k": kv, "v": kv, "pos": ((), torch.int32)}


def grow_caches(caches: dict, new_len: int) -> dict:
    """Pad the dense layout's decode caches with zeros so the sequence axis
    of ``k``/``v`` [L, B, S, KV, hd] holds ``new_len`` positions; a no-op
    for buffers already at >= new_len.  (The reference also grows the
    hybrid family's per-application ``kv`` pairs, which wait for A11d.)"""
    out = dict(caches)
    for key in ("k", "v"):
        if key in out and isinstance(out[key], torch.Tensor):
            cur = out[key].shape[2]
            if cur < new_len:
                out[key] = F.pad(out[key], (0, 0, 0, 0, 0, new_len - cur))
    return out
