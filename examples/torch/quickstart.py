"""Quickstart: the paper's pipeline on one weight matrix, deployed through
the hand-written fused kernel (port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py            # the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

The pipeline (stages 1-3) runs in f32 on ``--device``; the deployment line
rounds the compressed values and outliers to bf16 and runs
``kernels/ops.sparse_linear_apply``: on the card the fused N:M + outlier
kernel, on the CPU its plain version.  Its error is against the plain
version on the same bf16 operands, beside the bound phase 2 of
``chip_smoke.py`` holds the kernel to (2**-7 of the largest output: the
two differ only in summation order and the final rounding to bf16).  The
inputs come from numpy's generator with seed 0.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import (ActStats, Pattern, SparsifyConfig,
                              dense_effective_weight, pack_outlier_meta,
                              sparsify_linear)
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels.fused_sparse_linear import plain

KERNEL_TOL_REL = 2.0 ** -7
"""The fused kernel's bound against its plain version, relative to the
largest output (``chip_smoke.KERNEL_TOL_REL``)."""


def inputs(seed: int = 0) -> dict:
    """W [1024, 2048] (std 0.02), 512 calibration rows whose first 16
    input channels are 20x louder (the setting the paper targets), and 8
    rows to deploy on, as numpy f32."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((1024, 2048)) * 0.02).astype(np.float32)
    x_calib = rng.standard_normal((512, 2048)).astype(np.float32)
    x_calib[:, :16] *= 20.0
    x = rng.standard_normal((8, 2048)).astype(np.float32)
    return {"W": W, "x_calib": x_calib, "x": x}


def deployed_bytes(sl) -> int:
    """bf16 N:M values, int32 packed metadata, bf16 outliers and one byte
    an outlier index, as the reference counts them."""
    return (sl.nm.values.numel() * 2 + sl.nm.packed_metadata().numel() * 4
            + sl.outliers.values.numel() * 2 + sl.outliers.indices.numel())


def run(device="cuda", seed: int = 0) -> dict:
    device = resolve(device)
    data = {k: torch.as_tensor(v, device=device)
            for k, v in inputs(seed).items()}
    W = data["W"]
    stats = ActStats.init(2048, device=device).update(data["x_calib"])

    # --- the 4-stage pipeline (stages 1-3; EBFT is stage 4, see
    # sparsify_e2e) ---
    cfg = SparsifyConfig(
        weight_pattern="8:16",      # the paper's headline pattern
        outlier_pattern="16:256",   # SSP-for-SW: structured salient weights
        scorer="ria",               # importance metric
        use_smoothquant=True,       # stage 1: equalized scoring view
        use_variance_correction=True)  # stage 3
    sl = sparsify_linear(W, stats, cfg)
    out = {
        "nm_invariant": bool((sl.nm_mask.reshape(-1, 16).sum(-1) == 8).all()),
        "salient_fraction": float(sl.salient_mask.float().mean()),
        "dense_bytes": W.numel() * 2,                       # bf16 deploy
        "deployed_bytes": deployed_bytes(sl),
    }
    print(f"pattern           : {cfg.weight_pattern} "
          f"({Pattern(8, 16).configurations} configurations/block, "
          f"{Pattern(8, 16).paper_bits_per_element()} bits/elem metadata)")
    print(f"N:M invariant     : every 16-block keeps exactly 8 -> "
          f"{out['nm_invariant']}")
    print(f"salient fraction  : {out['salient_fraction']:.4f} "
          f"(16/256 = {16 / 256:.4f})")

    # --- deployment: y = x @ (W_nm + outliers)^T via the fused kernel ---
    nm = dataclasses.replace(sl.nm, values=sl.nm.values.to(torch.bfloat16))
    o = dataclasses.replace(sl.outliers,
                            values=sl.outliers.values.to(torch.bfloat16))
    x = data["x"].to(torch.bfloat16)
    y_kernel = ops.sparse_linear_apply(x, nm, o)
    y_plain = plain(x, nm.values, nm.packed_metadata(), o.values,
                    pack_outlier_meta(o.indices), n=nm.n, m=nm.m,
                    o_n=o.n)
    err = float((y_kernel.float() - y_plain.float()).abs().max())
    scale = float(y_plain.float().abs().max())
    out.update(kernel_err=err, kernel_scale=scale,
               kernel_tol=KERNEL_TOL_REL * scale)
    print(f"fused kernel error: {err:.3e} of max|y| {scale:.6e} (bound "
          f"{out['kernel_tol']:.2e}, {y_kernel.device})")

    # --- what did compression buy? ---
    print(f"deployed bytes    : {out['dense_bytes'] / 2**20:.2f} MiB -> "
          f"{out['deployed_bytes'] / 2**20:.2f} MiB "
          f"({out['dense_bytes'] / out['deployed_bytes']:.2f}x)")

    # --- quality: relative output error vs the dense layer ---
    xf = data["x"]
    y_dense = xf @ dense_effective_weight(W, sl, cfg).T
    ref = xf @ W.T
    out["rel_output_error"] = float(torch.linalg.norm(y_dense - ref)
                                    / torch.linalg.norm(ref))
    print(f"rel. output error : {out['rel_output_error']:.4f} (50% of "
          f"weights removed)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return run(args.device, args.seed)


if __name__ == "__main__":
    main()
