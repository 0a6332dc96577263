"""Shared neural building blocks (port of ``repro/models/layers.py``).

Conventions kept from the JAX package: linear weights are ``[out, in]`` and
apply as ``y = x @ W^T``; blocks are bias-free with RMSNorm scaled by
``(1 + scale)``; RoPE rotates split halves; masks use a finite ``-1e30``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.tensor_parallel import RowShard
from .sparse_serving import SparseWeight, sparse_apply


def linear(w, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T.  ``SparseWeight`` goes to the sparse kernels; a dense
    weight to a plain dense product, as XLA took it in the JAX package.  A
    ``RowShard`` (a mesh placement's out-dim split) computes this rank's
    rows the same way and all-gathers them along the last dim."""
    if isinstance(w, RowShard):
        return w.axis.gather(linear(w.local, x), dim=-1)
    if isinstance(w, SparseWeight):
        return sparse_apply(w, x)
    return F.linear(x, w)


def embed(table, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` [vocab, d] at ``tokens``.  A ``RowShard``
    table (vocab rows split over the model axis) looks up the tokens this
    rank holds, zeroes the others and sums over ranks: exact, since one
    rank contributes each row."""
    if not isinstance(table, RowShard):
        return table[tokens]
    local = table.local
    n = local.shape[0]
    idx = tokens - table.axis.rank * n
    mine = (idx >= 0) & (idx < n)
    rows = local[idx.clamp(0, n - 1)]
    return table.axis.sum(torch.where(mine[..., None], rows,
                                      torch.zeros((), dtype=rows.dtype,
                                                  device=rows.device)))


def dense_init(out_dim: int, in_dim: int, dtype, generator, device):
    """A [out, in] weight drawn N(0, 1/in) in f32 from ``generator``, then
    rounded to ``dtype``."""
    w = torch.randn((out_dim, in_dim), generator=generator, device=device,
                    dtype=torch.float32)
    return w.div_(math.sqrt(in_dim)).to(dtype)       # in place: one f32 copy


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
               theta: float = 10000.0,
               mrope_sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """Rotate ``x [..., S, H, hd]`` by ``positions [..., S]``: the halves
    [:hd/2] and [hd/2:] form the rotated pairs, not interleaved ones.

    With ``mrope_sections`` (Qwen2-VL's M-RoPE), ``positions`` is [3, ..., S]
    (t/h/w) and the sections, which sum to hd/2, count the frequency pairs
    each of the three position ids drives, in order."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # [hd/2]
    if mrope_sections is None:
        angles = positions[..., None].to(torch.float32) * freqs  # [...,S,hd/2]
    else:
        if positions.shape[0] != 3 or sum(mrope_sections) != hd // 2:
            raise ValueError(f"M-RoPE needs positions [3, ..., S] and "
                             f"sections summing to hd/2 = {hd // 2}; got "
                             f"{tuple(positions.shape)} and {mrope_sections}")
        parts, start = [], 0
        for sec_i, sec in enumerate(mrope_sections):
            parts.append(positions[sec_i][..., None].to(torch.float32)
                         * freqs[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)                        # [...,S,hd/2]
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


def _sdpa_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int | None,
               q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd]; repeats KV groups; returns
    [B,Sq,H,hd].  f32 scores, the finite -1e30 mask and softmax, as the JAX
    package computes them."""
    B, Sq, H, hd = q.shape
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    qf = q.to(torch.float32) / math.sqrt(hd)
    scores = torch.einsum("bqhd,bshd->bhqs", qf, k.to(torch.float32))
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None], scores,
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: int | None = None, q_chunks: int = 1,
         q_offset: int = 0) -> torch.Tensor:
    """Scaled dot-product attention over a full sequence, with optional
    query chunking: ``q_chunks > 1`` attends one chunk of queries at a time
    against all keys, which bounds the f32 scores' memory and changes no
    result."""
    if q_chunks <= 1 or q.shape[1] % q_chunks:
        return _sdpa_full(q, k, v, causal, window, q_offset)
    cs = q.shape[1] // q_chunks
    return torch.cat([_sdpa_full(q[:, i * cs:(i + 1) * cs], k, v, causal,
                                 window, q_offset + i * cs)
                      for i in range(q_chunks)], dim=1)


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


def attend_kv_length(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over a length-masked KV buffer: the enc-dec
    family's cross-attention while serving.  ``q`` [B,S,H,hd] attends to
    positions ``j < kv_len[b]`` of ``k_cache``/``v_cache`` [B,T,KV,hd]:
    every query of a row sees the same keys whatever its own position (the
    encoder context is fully visible), and padding past each row's true
    length is masked at ``-1e30``.  The einsum and softmax structure of
    ``attend_length_masked``, in f32."""
    B, S, H, hd = q.shape
    k = _repeat_kv(k_cache, H)
    v = _repeat_kv(v_cache, H)
    qf = q.to(torch.float32) / math.sqrt(hd)
    scores = torch.einsum("bqhd,bshd->bhqs", qf, k.to(torch.float32))
    kpos = torch.arange(k_cache.shape[1], device=q.device)             # [T]
    valid = kpos[None, :] < kv_len[:, None]                            # [B,T]
    scores = torch.where(valid[:, None, None], scores,
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)
