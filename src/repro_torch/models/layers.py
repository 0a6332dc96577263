"""Shared neural building blocks (port of ``repro/models/layers.py``).

Conventions kept from the JAX package: linear weights are ``[out, in]`` and
apply as ``y = x @ W^T``; blocks are bias-free with RMSNorm scaled by
``(1 + scale)``; RoPE rotates split halves; masks use a finite ``-1e30``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .sparse_serving import SparseWeight, sparse_apply


def linear(w, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T.  ``SparseWeight`` goes to the sparse kernels; a dense
    weight to a plain dense product, as XLA took it in the JAX package."""
    if isinstance(w, SparseWeight):
        return sparse_apply(w, x)
    return F.linear(x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
            ).to(x.dtype)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":                 # jax.nn.gelu's default tanh form
        return F.gelu(x, approximate="tanh")
    if name == "sq_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name}")


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x [..., S, H, hd]`` by ``positions [..., S]``: the halves
    [:hd/2] and [hd/2:] form the rotated pairs, not interleaved ones."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs      # [...,S,hd/2]
    cos = torch.cos(angles)[..., None, :]                        # [...,S,1,hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """[B,S,KV,hd] -> [B,S,H,hd] by repeating each KV head H//KV times."""
    KV = k.shape[2]
    if KV == H:
        return k
    return torch.repeat_interleave(k, H // KV, dim=2)


def attend_length_masked(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, q_offset: torch.Tensor, *,
                         window: int | None = None,
                         k_scale: torch.Tensor | None = None,
                         v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Length-masked attention over full-size caches (the slot layout).

    ``q`` [B,S,H,hd]: query i of row b sits at position ``q_offset[b] + i``
    and attends to cache positions ``j <= q_offset[b] + i`` (window-limited
    when ``window`` is set) of ``k_cache``/``v_cache`` [B,T,KV,hd].  Masked
    scores are the finite ``-1e30``, whose exp underflows to exactly 0, so
    stale tokens and padding contribute nothing.  Plain einsum + softmax in
    f32, as in the JAX package: the f32 scores [B,H,S,T] are materialised.

    ``k_scale``/``v_scale`` [B,T,KV] dequantize int8 caches: each position's
    values are upcast to f32 and multiplied by its scale, as the JAX
    package's ``attend_length_masked`` does.
    """
    B, S, H, hd = q.shape
    if k_scale is not None:
        k_cache = k_cache.to(torch.float32) * k_scale[..., None]
        v_cache = v_cache.to(torch.float32) * v_scale[..., None]
    k = _repeat_kv(k_cache, H)
    v = _repeat_kv(v_cache, H)
    qf = q.to(torch.float32) / math.sqrt(hd)
    scores = torch.einsum("bqhd,bshd->bhqs", qf, k.to(torch.float32))
    qpos = q_offset[:, None] + torch.arange(S, device=q.device)[None]  # [B,S]
    kpos = torch.arange(k_cache.shape[1], device=q.device)             # [T]
    valid = kpos[None, None, :] <= qpos[:, :, None]                    # [B,S,T]
    if window is not None:
        valid &= kpos[None, None, :] > qpos[:, :, None] - window
    scores = torch.where(valid[:, None], scores,
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)
