"""Plain PyTorch versions of the sparse kernels (port of
``repro/kernels/ref.py``): the ground truth the CUDA kernels are held
against, and the path a CPU tensor takes.

Decompression scatters each kept value to its slot.  That is the one-hot
sum of the JAX oracle without its [out, nb, n, m] one-hot tensor, which at
llama3-8b widths would take gigabytes: every block holds distinct indices,
so each slot receives at most one value and the result is identical.
"""
from __future__ import annotations

import torch


def decompress_nm(values: torch.Tensor, indices: torch.Tensor, m: int,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """[out, nb*n], [out, nb, n] int32 -> dense [out, nb*m].

    ``indices[o, b, k]`` is the column offset inside block ``b`` of value
    ``values[o, b*n + k]``."""
    out, nb, n = indices.shape
    vals = values.reshape(out, nb, n).to(dtype or values.dtype)
    dense = torch.zeros((out, nb, m), dtype=vals.dtype, device=vals.device)
    dense.scatter_(-1, indices.long(), vals)
    return dense.reshape(out, nb * m)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last dim, the rule of both the
    JAX package's int8 weights (``_to_sparse_weight(quantize=True)``, per
    out row) and int8 KV (``quantize_kv``, per position and KV head):
    absmax over the last dim, scale = absmax / 127 (1 where the absmax is
    0), values round(x / scale) (half to even, as ``jnp.round``) clipped to
    +-127.  Returns (int8 values, f32 scales of x's shape without its last
    dim), bit for bit what the JAX package stores."""
    f = x.to(torch.float32)
    absmax = f.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(f / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize(values: torch.Tensor, scale: torch.Tensor | None,
               dtype: torch.dtype) -> torch.Tensor:
    """int8 N:M values times their row's f32 scale, rounded once to
    ``dtype``, as the JAX package's ``sparse_apply`` dequantizes
    (``repro/models/sparse_serving.py:82-84``); bf16 values (``scale`` None) pass
    through."""
    if scale is None:
        return values
    return (values.to(torch.float32) * scale[:, None]).to(dtype)


def nm_spmm_ref(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                m: int, scale: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ W^T with W the N:M-compressed matrix; f32 accumulation.
    ``scale`` [out] f32 dequantizes int8 ``values``."""
    w = decompress_nm(dequantize(values, scale, x.dtype), indices, m,
                      dtype=torch.float32)
    return (x.to(torch.float32) @ w.T).to(x.dtype)


def fused_sparse_linear_ref(x: torch.Tensor,
                            nm_values: torch.Tensor, nm_indices: torch.Tensor,
                            nm_m: int, o_values: torch.Tensor | None,
                            o_indices: torch.Tensor | None,
                            o_m: int = 256,
                            scale: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ (W_nm + O)^T, the production path.  W_nm holds exact zeros
    at salient positions (core/pipeline.py), so the sum never
    double-counts.  ``scale`` [out] f32 dequantizes int8 ``nm_values``; the
    outliers are exact and added unscaled."""
    w = decompress_nm(dequantize(nm_values, scale, x.dtype), nm_indices,
                      nm_m, dtype=torch.float32)
    if o_values is not None:
        out, nb, n = o_values.shape
        w = w + decompress_nm(o_values.reshape(out, nb * n), o_indices, o_m,
                              dtype=torch.float32)
    return (x.to(torch.float32) @ w.T).to(x.dtype)
