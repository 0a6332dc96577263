"""Calibration statistics, model-level sparsification and perplexity (port
of ``repro/eval/harness.py``; ``train_small_lm`` comes with training).

``collect_activation_stats`` runs an instrumented full-sequence forward of
the dense family that accumulates each projection's input statistics (sum
of squares and max-abs per channel), which RIA, Wanda and SmoothQuant
read.  Statistics are keyed by the port's leaf names, ``layers/{i}/wq``:
one ``ActStats`` over ``[in]`` per layer and projection, where the JAX
harness keeps one ``ActStats`` over ``[L, in]`` per projection
(``interchange.stats_from_jax`` converts).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import ActStats, SparsifyConfig, sparsify_tree
from ..models import transformer as tfm
from ..models.layers import activation, linear, rms_norm, sdpa


def _batch(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device).long()
            for k, v in batch.items()}


def _stats_forward(params, tokens, stats, cfg) -> None:
    """One instrumented forward; updates ``stats`` in place (by key)."""
    def upd(i, key, x):
        name = f"layers/{i}/{key}"
        if name not in stats:
            stats[name] = ActStats.init(x.shape[-1], device=x.device)
        stats[name] = stats[name].update(x)

    x, positions = tfm._embed_inputs(params, {"tokens": tokens})
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        for key in ("wq", "wk", "wv"):
            upd(i, key, h)
        q, k, v = tfm._project_qkv(lp, h, cfg, positions)
        attn = sdpa(q, k, v, causal=True, window=cfg.window)
        attn2 = attn.reshape(*attn.shape[:2], -1)
        upd(i, "wo", attn2)
        x = x + linear(lp["wo"], attn2)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        upd(i, "w_up", h)
        if cfg.glu:
            upd(i, "w_gate", h)
            hidden = activation(cfg.act, linear(lp["w_gate"], h)) \
                * linear(lp["w_up"], h)
        else:
            hidden = activation(cfg.act, linear(lp["w_up"], h))
        upd(i, "w_down", hidden)
        x = x + linear(lp["w_down"], hidden)


@torch.no_grad()
def collect_activation_stats(cfg, params, calib_batches) -> dict:
    """{``layers/{i}/<projection>``: ActStats} over the calibration batches
    (dicts with numpy or tensor ``tokens`` [B, S]), on the params' device."""
    device = params["embed"].device
    stats: dict = {}
    for batch in calib_batches:
        _stats_forward(params, _batch(batch, device)["tokens"], stats, cfg)
    return stats


@torch.no_grad()
def sparsify_model(cfg, params, stats, scfg: SparsifyConfig):
    """The pipeline on every projection; returns dense-effective params."""
    new_params, _records = sparsify_tree(params, stats or {}, scfg)
    return new_params


@torch.no_grad()
def eval_ppl(cfg, params, data, n_batches: int = 8,
             start_step: int = 50_000) -> float:
    """exp of the mean per-batch loss over ``n_batches`` batches of
    ``data`` from ``start_step``."""
    device = params["embed"].device
    total = 0.0
    for i in range(n_batches):
        loss, _ = tfm.loss_fn(params, _batch(data.batch_at(start_step + i),
                                             device), cfg)
        total += float(loss)
    return math.exp(total / n_batches)
