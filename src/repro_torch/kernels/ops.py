"""Public entry points for the sparse products on the pipeline's output
(port of ``repro/kernels/ops.py``): a ``PackedNM`` and, where present,
``StructuredOutliers`` of a ``SparsifiedLinear``.

Each routes by the tensor's device through the kernel wrappers: on a CUDA
tensor the hand-written kernels run (``nm_spmm``, ``outlier_spmm``, and
``fused_sparse_linear`` for ``sparse_linear_apply`` with outliers) and a
wrong dtype or layout raises; on a CPU tensor their plain versions run.
The JAX package's ``REPRO_KERNEL_BACKEND`` switch has no counterpart: its
"reference" backend is the CPU path here.
"""
from __future__ import annotations

import torch

from ..core.outliers import StructuredOutliers, pack_outlier_meta
from ..core.packing import PackedNM
from .fused_sparse_linear import fused_sparse_linear
from .nm_spmm import nm_spmm
from .outlier_spmm import outlier_spmm


def nm_matmul(x: torch.Tensor, packed: PackedNM) -> torch.Tensor:
    """y = x @ W_nm^T for a PackedNM weight; x [M, in]."""
    return nm_spmm(x, packed.values, packed.packed_metadata(), n=packed.n,
                   m=packed.m)


def outlier_matmul(x: torch.Tensor,
                   outliers: StructuredOutliers) -> torch.Tensor:
    """y = x @ O^T for structured N:256 outliers; x [M, in]."""
    return outlier_spmm(x, outliers.values,
                        pack_outlier_meta(outliers.indices), n=outliers.n)


def sparse_linear_apply(x: torch.Tensor, packed: PackedNM,
                        outliers: StructuredOutliers | None) -> torch.Tensor:
    """The production path, y = x @ (W_nm + O)^T over any leading dims of
    x: one fused kernel when outliers are present."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if outliers is None:
        y = nm_matmul(x2, packed)
    else:
        y = fused_sparse_linear(x2, packed.values, packed.packed_metadata(),
                                outliers.values,
                                pack_outlier_meta(outliers.indices),
                                n=packed.n, m=packed.m, o_n=outliers.n)
    return y.reshape(*lead, y.shape[-1])
