"""Uniform model API over the ported families (port of
``repro/models/model_zoo.py``).

  zoo = get_model(cfg)
  params = zoo.init(generator)
  loss, aux = zoo.loss(params, batch)
  logits, caches = zoo.prefill(params, batch)
  logits, caches = zoo.decode(params, caches, batch)

The dense and moe families and the vlm backbone run
``models/transformer.py``, ssm ``models/xlstm.py``, hybrid
``models/zamba.py`` and encdec ``models/whisper.py`` (whose batches carry
the encoder's ``embeds`` beside the decoder's ``tokens``).
``input_specs`` and ``cache_specs`` give the
(shape, dtype) of every input of a step and of the decode cache, as the
reference's ``ShapeDtypeStruct`` stand-ins do, without allocating.  The
reference's ``param_specs`` waits for the dry-run tools (ROADMAP A14b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..device import resolve
from . import transformer as tfm
from . import whisper as whi
from . import xlstm as xls
from . import zamba as zam

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
FAMILIES = TRANSFORMER_FAMILIES + ("ssm", "hybrid", "encdec")


@dataclasses.dataclass(frozen=True)
class ModelZoo:
    cfg: Any
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable | None = None


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def get_model(cfg, device="cuda") -> ModelZoo:
    """The zoo entry of ``cfg``'s family; parameters and caches on
    ``device``."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return ModelZoo(
            cfg=cfg,
            init=lambda generator: xls.init_params(cfg, generator, device),
            loss=lambda p, b: xls.loss_fn(p, b, cfg),
            prefill=lambda p, b: xls.prefill(p, b, cfg),
            decode=lambda p, c, b: xls.decode_lockstep(p, c, b, cfg),
            init_cache=lambda bs, ml: {
                "states": xls.init_state(cfg, bs, device),
                "pos": torch.zeros((), dtype=torch.int32,
                                   device=resolve(device))})
    if cfg.family == "hybrid":
        return ModelZoo(
            cfg=cfg,
            init=lambda generator: zam.init_params(cfg, generator, device),
            loss=lambda p, b: zam.loss_fn(p, b, cfg),
            prefill=lambda p, b: zam.prefill(p, b, cfg),
            decode=lambda p, c, b: zam.decode_lockstep(p, c, b, cfg),
            init_cache=lambda bs, ml: zam.init_cache(cfg, bs, ml, device))
    if cfg.family == "encdec":
        return ModelZoo(
            cfg=cfg,
            init=lambda generator: whi.init_params(cfg, generator, device),
            loss=lambda p, b: whi.loss_fn(p, b, cfg),
            prefill=lambda p, b: whi.prefill(p, b, cfg),
            decode=lambda p, c, b: whi.decode_lockstep(p, c, b, cfg))
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
    elif cfg.family == "encdec":
        base = {"embeds": ((B, S, cfg.d_model), cfg.dtype),
                "tokens": ((B, S), i32)}
    else:
        base = {"tokens": ((B, S), i32)}
    if shape.kind == "train":
        return {**base, "labels": ((B, S), i32)}
    if shape.kind == "prefill":
        return base
    return {"tokens": ((B, 1), i32)}


def cache_specs(cfg, shape) -> dict:
    """(shape, dtype) of each leaf of the decode cache: the dense layout's
    k/v (encdec's with the cross-attention's ck/cv beside them), ssm's
    per-layer states (mLSTM (C, n), sLSTM (c, n, h, m)), or hybrid's
    per-layer (S, None) states and per-application (k, v)."""
    _check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    f32, pos = torch.float32, ((), torch.int32)
    if cfg.family == "ssm":
        di = 2 * cfg.d_model
        H = cfg.n_heads
        dh = di // H
        states = []
        for i in range(cfg.n_layers):
            if xls._is_slstm(cfg, i):
                states.append((((B, H, dh), f32),) * 4)
            else:
                states.append((((B, H, dh, dh), f32), ((B, H, dh), f32)))
        return {"states": states, "pos": pos}
    if cfg.family == "hybrid":
        di = 2 * cfg.d_model
        H = di // cfg.ssm_head_dim
        states = [(((B, H, cfg.ssm_state, cfg.ssm_head_dim), f32), None)
                  for _ in range(cfg.n_layers)]
        kv = ((B, S, cfg.n_kv_heads, cfg.hd), cfg.dtype)
        return {"states": states,
                "kv": [(kv, kv) for _ in range(zam.n_applications(cfg))],
                "pos": pos}
    kv = ((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd), cfg.dtype)
    if cfg.family == "encdec":
        return {"k": kv, "v": kv, "ck": kv, "cv": kv, "pos": pos}
    return {"k": kv, "v": kv, "pos": pos}


def grow_caches(caches: dict, new_len: int) -> dict:
    """Pad decode caches with zeros so the sequence axis holds ``new_len``
    positions: the self-attention ``k``/``v`` [L, B, S, KV, hd] of the
    dense, moe, vlm and encdec layouts (encdec's cross-attention ``ck``/
    ``cv`` stay at the encoder's length), the hybrid family's
    per-application ``kv`` pairs [B, S, KV, hd]; recurrent ``states`` need
    no growth.  A no-op for buffers already at >= new_len."""
    out = dict(caches)
    for key in ("k", "v"):
        if key in out and isinstance(out[key], torch.Tensor):
            cur = out[key].shape[2]
            if cur < new_len:
                out[key] = F.pad(out[key], (0, 0, 0, 0, 0, new_len - cur))
    if "kv" in out:
        out["kv"] = [tuple(t if t.shape[1] >= new_len else
                           F.pad(t, (0, 0, 0, 0, 0, new_len - t.shape[1]))
                           for t in kv) for kv in out["kv"]]
    return out
