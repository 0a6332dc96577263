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


def nm_spmm_ref(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                m: int) -> torch.Tensor:
    """y = x @ W^T with W the N:M-compressed matrix; f32 accumulation."""
    w = decompress_nm(values, indices, m, dtype=torch.float32)
    return (x.to(torch.float32) @ w.T).to(x.dtype)


def fused_sparse_linear_ref(x: torch.Tensor,
                            nm_values: torch.Tensor, nm_indices: torch.Tensor,
                            nm_m: int, o_values: torch.Tensor | None,
                            o_indices: torch.Tensor | None,
                            o_m: int = 256) -> torch.Tensor:
    """y = x @ (W_nm + O)^T, the production path.  W_nm holds exact zeros
    at salient positions (core/pipeline.py), so the sum never
    double-counts."""
    w = decompress_nm(nm_values, nm_indices, nm_m, dtype=torch.float32)
    if o_values is not None:
        out, nb, n = o_values.shape
        w = w + decompress_nm(o_values.reshape(out, nb * n), o_indices, o_m,
                              dtype=torch.float32)
    return (x.to(torch.float32) @ w.T).to(x.dtype)
