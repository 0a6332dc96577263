#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero and prints no result):

  1. device and build: the card's name and power limit; the CUDA kernels
     built from ``src/repro_torch/csrc/`` into ``build/kernels/``; the
     library's resource usage (``cuobjdump --dump-resource-usage``), gated
     at no local memory (no spill) for the decode and prefill bodies'
     constant-shape 8:16 instantiations, with 16:256 outliers (the fused
     kernel) and without (``nm_spmm``), for ``outlier_spmm``'s two bodies
     and for ``paged_attention``'s decode and prefill-chunk bodies;
  2. kernels against their plain PyTorch versions at the llama3-8b
     projection shapes ([4096->4096], [4096->1024], [4096->14336],
     [14336->4096]) and M in {1, 8, 37, 512}, both kernels (the fused one on
     8:16+16:256 weights, ``nm_spmm`` on plain 8:16) in both variants (bf16
     N:M values, and int8 values quantized from the same draws), timed with
     CUDA events beside the plain version, one ``F.linear`` on the
     densified weight (the library yardstick, never called by the port) and
     the card's bound.  Each wrapper takes its decode kernel
     (``csrc/fused_sparse_linear.cu``) at M <= T and its prefill kernel
     (``csrc/fused_sparse_linear_prefill.cu``) above, ``nm_spmm`` their
     instances without an outlier stream; two calls must give the same
     bits, and the old tile kernel (``csrc/sparse_linear.cu``) is timed
     beside either (``tile_ms``, reported).  Then the sweep that sets T:
     each wrapper's decode and prefill kernels and the old tile, both
     variants, at w_gate and w_down for M in ``SWEEP_MS``, each case gated
     against the plain version, the times reported; and the same for
     ``outlier_spmm``'s two bodies and its old kernel at 16:256 and 4:256
     for M in ``OUTLIER_SWEEP_MS``;
  3. a small-model reference check: the llama-paper smoke model served one
     step on the card (bf16, kernels), on the slot layout and on shuffled
     paged blocks, against the same weights in f32 on the CPU (plain
     versions, slot layout); and again with int8 weights on int8 KV
     arenas, against the same int8 weights and int8 KV in f32 on the CPU;
  4. the main path: llama3-8b at full width and depth with every projection
     deployed as 8:16+16:256, served through ``ServingEngine`` (8 slots,
     max_len 1024, 8 greedy requests with prompts of 64..768 tokens, token
     budget 512, 32 new tokens each); the fused kernel must launch exactly
     7 x 32 times per model call;
  5. plain 8:16 (no outliers) at 4 layers, full width, which puts
     ``nm_spmm`` on the engine path; then the same with int8 values, which
     puts ``nm_spmm``'s int8 variant there; each gated as the fused serves
     are (decode + prefill launches == the wrapper's, both > 0), with a
     decode and a prefill profile;
  2b. ``paged_attention`` against its plain version at llama3-8b's attention
     shapes (H 32, KV 8, hd 128, block size 16): decode (S=1, B=8, cursors
     up to 1000), chunks (S=512 at cursor 256; S=64 over 4 lanes, with and
     without a 128-token window), shuffled trash-padded block tables, on
     bf16 arenas and on int8 arenas quantized from the same K/V; the plan
     takes the split-KV decode body (``csrc/paged_attention_decode.cu``,
     held row by row at 2^-7 of each row's largest output) at S * n_rep
     <= T and the prefill-chunk body (``csrc/paged_attention_prefill.cu``)
     above; two calls must give the same bits; timed beside the plain
     version, the old kernel
     (``csrc/paged_attention.cu``, forced by ``Plan("tile")``, gated too)
     on the same inputs (``old_ms``), one ``scaled_dot_product_attention``
     on the pre-gathered (dequantized) K/V (the library yardstick, never
     called by the port) and the card's bound.  Then the sweep that sets
     T: the decode body, the prefill-chunk body and the old kernel forced
     at the decode case's lanes and at 8 short lanes through serve-wide
     tables (``ATTN_SWEEP_SHORT``) for S in ``ATTN_SWEEP_S``, bf16 and
     int8, each gated; T from the decode body against the prefill-chunk
     body at the decode case's lanes, the short lanes' count beside it;
  6. the paged layout: the phase-4 model served by
     ``ServingEngine(kv_layout="paged", block_size=16)``, with the paged
     kernel launching once per layer per model call (decode steps on its
     decode body, prefill chunks on its prefill-chunk body, both > 0):
       (a) phase 4's traffic, with decode profile, prefill profile (one
           512-token chunk: device ms and launches by kernel class, busy
           share) and greedy agreement with phase 4's slot streams
           (reported, not gated);
       (b) prefix sharing: 8 requests on one 512-token prefix in two waves of
           4, the second after the first wave's prefills; gates prefix-cache
           hits, hit tokens >= 4 x 512 and a copy-on-write;
       (c) block pressure: (a)'s traffic with half the blocks it needs at
           once; gates preemptions;
  7. int8: llama3-8b at full width and depth with int8 8:16 values and
     bf16 16:256 outliers, served by ``ServingEngine(kv_layout="paged",
     kv_dtype="int8", block_size=16)``, with the int8 weight kernel
     launching 7 x 32 times and the int8 paged kernel 32 times per model
     call:
       (a) phase 4's traffic in 512 blocks, with decode profile and greedy
           agreement with 6(a)'s streams (reported, not gated);
       (b) the same traffic in the device memory of 6(c)'s bf16 arena
           (109 x 2 x 128 / 132 = 211 blocks); gates its arena bytes, scales
           included, at most 6(c)'s; reports peak concurrency and
           preemptions beside 6(c)'s.

  8. the paper's pipeline on llama3-8b, full width and depth, from seed 0
     (the same dense weights phase 4 compressed by magnitude):
       (a) calibrate: the dense bf16 model's own forward over 4
           ``SyntheticLM`` batches of 4 x 512 tokens (8,192 tokens) collects
           each projection's input statistics; gates 7 x 32 leaves, finite
           values and counts of 8,192;
       (b) compress with the reference's defaults, RIA + SmoothQuant +
           variance correction, to 8:16 + 16:256, one layer at a time on the
           card; gates the containers (bf16 values, 16 distinct outlier
           indices per group, the N:M invariant, W_nm zero at every salient
           slot), layer 0's indices against the same pipeline on the CPU from
           the same bf16 weights and statistics (agreement >= 0.999: only
           reduction orders differ, so only near-ties may flip) and layer 0
           in the unstructured mode (salient density 16/256 within one
           entry);
       (c) serve phase 6(a)'s traffic from the compressed params on the
           paged layout in 512 blocks, with the fused and paged kernels'
           launches gated per model call as in phase 6;
       (d) the ``kernels/ops`` path on layer 0's four projection shapes with
           16:256, 8:256 and 4:256 outliers, M in {1, 8, 37, 512}: each
           ``ops.outlier_matmul`` launches ``outlier_spmm`` (kernel B4:
           its decode body at M <= T, its prefill body above, each
           counted), gated at one bf16 ulp against its plain version, the
           same bits on two calls, and timed beside it, the old kernel
           (``csrc/outlier_spmm_gather8.cu``, ``old_ms``), ``F.linear`` on
           the densified outlier matrix and the bound (the gather ceiling,
           worked out, in the log and the ops section of the JSON);
           at 16:256 the unfused ``ops.nm_matmul + ops.outlier_matmul``
           against the fused ``ops.sparse_linear_apply``, both timed;
       (e) perplexity (reported, not gated: the weights are random) of the
           dense model, of ``sparsify_model``'s dense-effective weights and
           of the compressed params, over 2 batches of 2 x 512 tokens; gates
           the compressed params' forward (fused kernel) against the
           dense-effective params' (``torch.matmul``) on one batch.

  9. trace replay with observability (run after phase 6, on phase 4's
     params): a fixed-seed Poisson trace (16 requests at 4/s, prompts of
     64..768 tokens, 32 new tokens each, greedy) written with
     ``save_trace`` under ``chiprun_out/``, read back with ``load_trace``
     and replayed through the CLI's ``launch/serve.run_trace`` on phase
     6(a)'s paged engine (512 blocks of 16, 8 slots, max_len 1024, token
     budget 512), every run's launches gated per model call as in phase 6:
       (a) at time scale 0, untraced and then traced (``ServingTracer``):
           gates identical greedy streams request by request, 16 finished,
           0 rejected;
       (b) the traced run's Perfetto file (``chiprun_out/phase9_trace.json``
           and its ``.counters.txt``): gates the port's
           ``validate_trace_events``, every ``request_summary`` against its
           request's ``RequestMetrics``, the span names, 512 decoded
           tokens and the prefilled-token counter against the engine's
           count, and the attribution's calls against the model calls;
       (c) at time scale 1.0, traced (reported, not gated): the
           ``format_summary`` line, each model-call variant's calls,
           steady mean wall and issue time (host time until the call
           returned), FLOPs and bytes from ``launch/step_cost.py``, the
           engine spans' host ms per step, the p50 of decode-only steps
           and of steps with a chunk, and (a)'s untraced and traced
           tok/s.

Every serve with a decode profile (4, 5, 6(a), 7(a), 8(c)) also profiles
one 512-token prefill chunk.  Prints the kernels line ``{"kernels": [...]}``
(seven entries: the three serving kernels' bf16 and int8 variants, and
``outlier_spmm``; each entry names its sources and splits its cases and
launches by path, decode and prefill),
the serve numbers, the
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.  Run alone (without the checkout) or
without CUDA it fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak
PROJECTIONS = [("wq/wo", 4096, 4096), ("wk/wv", 1024, 4096),
               ("w_gate/w_up", 14336, 4096), ("w_down", 4096, 14336)]
MS = [1, 8, 37, 512]
# the sweep that sets the fused kernel's threshold T (w_gate, w_down)
SWEEP_PROJ = [("w_gate/w_up", 14336, 4096), ("w_down", 4096, 14336)]
SWEEP_MS = [1, 2, 4, 8, 12, 16, 24, 32, 37, 48, 64]
# Kernel vs plain: both multiply exact bf16 products and accumulate in f32;
# only the summation order and the final rounding to bf16 differ, so they
# may differ by one bf16 ulp of an output, at most 2**-7 of the largest
# output magnitude.
KERNEL_TOL_REL = 2.0 ** -7
# paged_attention's decode body is held row by row: each output row (a
# lane's query and q head, hd columns) within 2**-7 of that row's largest
# output, so that a long lane, whose outputs average ~1,000 keys and are
# small, is not held at the scale of a short lane's
# Small-model check: bf16 activations through 4 layers against an f32
# reference; a wrong kernel gives errors of the order of the logits.
MODEL_TOL_REL = 5e-2
SERVE_PROMPT_LENS = [64, 160, 256, 352, 448, 544, 640, 768]
# the prefill profile: one chunk of the serves' 512-token budget
PREFILL_PROFILE_TOKENS = 512
SERVE_GEN = 32
# phase 5: the 4-layer plain 8:16 model, bf16 values and int8 values
PLAIN_PROMPT_LENS = [128, 96, 200, 64]
PLAIN_GEN = 8
# phase 2b: (name, lanes' cursors, S, window) at H 32, KV 8, hd 128, bs 16
ATTN_SHAPE = dict(H=32, KV=8, hd=128, bs=16)
ATTN_CASES = [("decode", [63, 200, 500, 700, 767, 1000, 15, 16], 1, None),
              ("chunk512", [256], 512, None),
              ("chunk64", [0, 64, 300, 700], 64, None),
              ("chunk64_window128", [0, 64, 300, 700], 64, 128)]
# the sweep that sets paged_attention's threshold T: the decode case's 8
# lanes at these S (rows S * n_rep = 4..256), and 8 short lanes at ~64
# tokens through tables as wide as the serves' (64 blocks, 8 splits of
# which one is live), as a serve's early decode steps are
ATTN_SWEEP_S = [1, 2, 4, 8, 16, 32, 64]
ATTN_SWEEP_SHORT = ([64, 60, 70, 64, 50, 64, 80, 63], 64)   # cursors, nb
# phase 6(b): a shared 512-token prefix, 8 distinct suffixes in two waves
# (the last of wave 2 repeats the start of a wave-1 suffix, so its whole
# prompt is cached and its recomputed last token forces a copy-on-write)
PREFIX_LEN = 512
PREFIX_SUFFIX_LENS = [[32, 96, 160, 256], [64, 128, 200]]
PREFIX_REPEAT = (1, 48)          # wave-1 suffix 1, its first 48 tokens
# phase 9: the replayed trace (serving/trace.poisson_trace's arguments)
TRACE = dict(n_requests=16, rate_per_s=4.0, prompt_len=(64, 768),
             max_new_tokens=32, temperature=0.0, seed=0)
TRACE_SPANS = {"step", "plan", "chunk", "decode", "emit", "queued", "prefill",
               "request_summary", "jit:step", "jit:decode"}
# phase 8: the paper's pipeline
PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
CALIB = dict(n_batches=4, batch=4, seq_len=512)          # 8,192 tokens
PPL = dict(n_batches=2, batch=2, seq_len=512)
OPS_PROJ = ("wq", "wk", "w_gate", "w_down")              # the four shapes
OPS_PATTERNS = ("16:256", "8:256", "4:256")
# the sweep that sets outlier_spmm's threshold T (w_gate, w_down; n 16, 4)
OUTLIER_SWEEP_MS = [1, 2, 4, 8, 12, 16, 24, 37, 64]
OUTLIER_SWEEP_N = (16, 4)
# The gather ceiling of an outlier product on the CUDA cores: each
# multiply-add reads 2 B of x from shared memory at 128 B a clock an SM, 64
# a clock an SM, at the SM clock of the data sheet's bf16 peak (989e12 / (132
# SMs x 4096 operations a clock) = 1.83 GHz), over 132 SMs: 15.5e12/s.
GATHER_FMA_PER_S = BF16_OPS_PER_S / 4096 * 64
# The card's pipeline against the CPU's: the same f32 arithmetic in another
# reduction order, so only indices whose scores are within an ulp or so of
# a neighbour's may differ.
PIPELINE_AGREE = 0.999
# ops.nm_matmul(x) + ops.outlier_matmul(x) against the fused
# ops.sparse_linear_apply(x): W_nm is exactly zero at the salient slots, so
# the two differ only by the rounding of each partial product to bf16 and of
# their bf16 sum (half an ulp each), besides the fused product's own
# rounding: one bf16 ulp of each of the three magnitudes bounds it.
UNFUSED_TOL_REL = 2.0 ** -7


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing
class Timer:
    """CUDA-event timing of one call at a time with L2 flushed before each
    (the serving path finds weights cold: 10 GB stream through a 50 MB L2)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def bound(M, N, K, n, m, o_n, sw):
    """Least time for y = x @ W^T on this work: every input byte read once
    and the output written once at the HBM rate, or the multiply-adds of the
    stored entries at the bf16 tensor-core peak, whichever is larger."""
    bytes_moved = M * K * 2 + sw.deployed_bytes() + M * N * 2
    stored_per_row = K * n // m + (K // 256) * o_n
    ops = 2 * M * N * stored_per_row
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def weight_case(timer, log, name, proj, x, sw, kernel_fn, plain_fn):
    """One (projection, M) case of a weight kernel: the kernel against its
    plain version on ``sw``'s buffers, gated at one bf16 ulp of the largest
    output, and timed beside the plain version, one ``F.linear`` on the
    densified (dequantized) weight and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import unpack_metadata, unpack_outlier_meta
    from repro_torch.kernels.ref import decompress_nm, dequantize

    M, K = x.shape
    N = sw.nm_values.shape[0]
    bufs = ((sw.nm_values, sw.nm_meta) if sw.o_values is None else
            (sw.nm_values, sw.nm_meta, sw.o_values, sw.o_meta))
    kw = dict(n=sw.n, m=sw.m, scale=sw.v_scale)
    if sw.o_values is not None:
        kw["o_n"] = sw.o_n

    def kern():
        return kernel_fn(x, *bufs, **kw)

    def plain():
        return plain_fn(x, *bufs, **kw)
    y, y_plain = kern(), plain()
    torch.cuda.synchronize()
    check(y.shape == (M, N) and y.dtype == torch.bfloat16,
          f"{name} {proj} M={M}: shape {tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(y).all()),
          f"{name} {proj} M={M}: non-finite output")
    err = float((y.float() - y_plain.float()).abs().max())
    tol = KERNEL_TOL_REL * float(y_plain.float().abs().max())
    check(err <= tol, f"{name} {proj} M={M}: max|kernel-plain| "
                      f"{err:.3e} > tol {tol:.3e}")
    dense = decompress_nm(dequantize(sw.nm_values, sw.v_scale, x.dtype),
                          unpack_metadata(sw.nm_meta, sw.n), sw.m,
                          dtype=torch.float32)
    if sw.o_values is not None:
        dense += decompress_nm(sw.o_values.reshape(N, -1),
                               unpack_outlier_meta(sw.o_meta, sw.o_n), 256,
                               dtype=torch.float32)
    dense = dense.to(torch.bfloat16)
    b_ms, b_by = bound(M, N, K, sw.n, sw.m, sw.o_n, sw)
    case = {"proj": proj, "N": N, "K": K, "M": M,
            "max_abs_err": err, "tol": tol,
            "ms": timer.ms(kern, 20), "plain_ms": timer.ms(plain, 5),
            "library_ms": timer.ms(lambda: F.linear(x, dense), 20),
            "bound_ms": b_ms, "bound_by": b_by}
    # the wrapper's path (decode at M <= T, prefill above; o_n = 0 is
    # nm_spmm's plan): the same inputs twice give the same bits, and the old
    # tile kernel is timed beside it on the same inputs
    from repro_torch.kernels import fused_sparse_linear as fsl
    p = fsl.plan(M, K, N, sw.n, sw.m, sw.o_n, sm_count(torch))
    case["path"] = p.path
    again = kern()
    torch.cuda.synchronize()
    check(torch.equal(y, again),
          f"{name} {proj} M={M}: two calls give different bits")
    forced = fsl.tile_plan(M, K, N)
    case.update(splits=p.splits, rows=p.rows, cols=p.cols,
                tile_ms=timer.ms(lambda: kernel_fn(
                    x, *bufs, force_plan=forced, **kw), 20))
    tile = (f"  {p.path} {p.rows}x{p.cols} S={p.splits}  tile "
            f"{case['tile_ms']:.4f}")
    log(f"  {name:25s} {proj:12s} M={M:4d}: err {err:.2e} "
        f"(tol {tol:.2e})  kernel {case['ms']:.4f} ms  plain "
        f"{case['plain_ms']:.4f}  F.linear "
        f"{case['library_ms']:.4f}  bound {b_ms:.4f} ({b_by}){tile}")
    return case


def sm_count(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def sweep_phase(torch, timer, log):
    """Each weight wrapper's decode kernel, prefill kernel and old tile
    kernel side by side, each forced by its plan, bf16 and int8 values, at
    w_gate and w_down for every M of ``SWEEP_MS``: ``fused_sparse_linear``
    on 8:16 + 16:256 weights, ``nm_spmm`` on plain 8:16 ones; every case is
    gated against the plain version.  A kernel's T is the largest M at
    which its decode kernel was no slower than its prefill kernel in all
    four (projection, variant) cases; the tile kernel is reported only."""
    from repro_torch.core import SparsifyConfig
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.models.sparse_serving import to_sparse_weight

    g = torch.Generator(device="cuda").manual_seed(4)
    out = {"T_in_module": fsl.DECODE_MAX_M}
    for kernel, outlier, mod, fn in (
            ("fused_sparse_linear", "16:256", fsl, fsl.fused_sparse_linear),
            ("nm_spmm", None, nms, nms.nm_spmm)):
        scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern=outlier,
                              scorer="magnitude", use_smoothquant=False)
        cases = []
        for proj, N, K in SWEEP_PROJ:
            w = (torch.randn((N, K), generator=g, device="cuda")
                 / math.sqrt(K)).to(torch.bfloat16)
            for variant, sw in (("bf16", to_sparse_weight(w, scfg)),
                                ("int8", to_sparse_weight(w, scfg,
                                                          quantize=True))):
                bufs = (sw.nm_values, sw.nm_meta) + (
                    () if outlier is None else (sw.o_values, sw.o_meta))
                kw = dict(n=sw.n, m=sw.m, scale=sw.v_scale)
                if outlier is not None:
                    kw["o_n"] = sw.o_n
                for M in SWEEP_MS:
                    x = torch.randn((M, K), generator=g, device="cuda").to(
                        torch.bfloat16)
                    plans = {path: fsl.plan(M, K, N, sw.n, sw.m, sw.o_n,
                                            sm_count(torch),
                                            decode_max_m=limit)
                             for path, limit in (("decode", max(SWEEP_MS)),
                                                 ("prefill", 0))}
                    plans["tile"] = fsl.tile_plan(M, K, N)
                    y_plain = mod.plain(x, *bufs, **kw)
                    tol = KERNEL_TOL_REL * float(y_plain.float().abs().max())
                    case = {"proj": proj, "variant": variant, "M": M,
                            "splits": plans["decode"].splits,
                            "rows": plans["decode"].rows,
                            "prefill_tiles": [plans["prefill"].rows,
                                              plans["prefill"].cols,
                                              plans["prefill"].splits]}
                    for path, pl in plans.items():
                        def run(pl=pl):
                            return fn(x, *bufs, force_plan=pl, **kw)
                        y = run()
                        torch.cuda.synchronize()
                        err = float((y.float() - y_plain.float()).abs().max())
                        check(bool(torch.isfinite(y).all()) and err <= tol,
                              f"sweep {kernel} {proj} {variant} M={M} {path}:"
                              f" max|kernel-plain| {err:.3e} > tol {tol:.3e}")
                        case[f"{path}_ms"] = timer.ms(run, 20)
                        case[f"{path}_err"] = err
                    cases.append(case)
                    log(f"  sweep {kernel:19s} {proj:12s} {variant} M={M:3d}:"
                        f" decode {case['decode_ms']:.4f} ms (S="
                        f"{case['splits']}, R={case['rows']})  prefill "
                        f"{case['prefill_ms']:.4f} (BMxBN,S="
                        f"{case['prefill_tiles']})  tile "
                        f"{case['tile_ms']:.4f}")
                del sw, bufs
            del w
        faster = [M for M in SWEEP_MS
                  if all(c["decode_ms"] <= c["prefill_ms"] for c in cases
                         if c["M"] == M)]
        out[kernel] = {"T_measured": max(faster) if faster else 0,
                       "decode_no_slower_at": faster, "cases": cases}
        log(f"  sweep {kernel}: decode no slower than prefill at M in "
            f"{faster}; T measured {out[kernel]['T_measured']}, module T "
            f"{fsl.DECODE_MAX_M}")
    return out


def resource_usage(lib_path, log):
    """Registers, stack, shared and local memory of every kernel of the
    built library (``cuobjdump --dump-resource-usage``); gates no local
    memory and no stack (no spill) for the constant-shape instantiations of
    the two weight kernels' bodies, with 16:256 outliers (the fused kernel)
    and without (``nm_spmm``), 8:16 each: six of each decode body (three
    row counts, bf16 and int8) and ten of each prefill body (BM x BN of
    64 x 64, 64 x 128, 128 x 64, 128 x 128 and 256 x 128, bf16 and
    int8); and ``outlier_spmm``'s two bodies: three decode instances (R =
    2, 4, 8) and six prefill instances (BM 64 and 128, n 4, 8, 16); and
    ``paged_attention``'s two bodies: eight decode instances (hd 64 and
    128, R 4 and 8 rows, bf16 and int8 arenas) and eight prefill-chunk
    instances (hd 64 and 128, BM 64 and 128, bf16 and int8 arenas)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "--dump-resource-usage", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    found = re.findall(r"Function\s+(\S+?):\s*REG:(\d+)\s+STACK:(\d+)\s+"
                       r"SHARED:(\d+)\s+LOCAL:(\d+)", out.stdout)
    kernels = {name: dict(zip(("reg", "stack", "shared", "local"),
                              map(int, vals))) for name, *vals in found}
    result = {"kernels": len(kernels)}
    for key, tag, want in (("fused_decode", "fused_decode_816_kernel", 6),
                           ("fused_prefill", "fused_prefill_816_kernel", 10),
                           ("nm_decode", "nm_decode_816_kernel", 6),
                           ("nm_prefill", "nm_prefill_816_kernel", 10),
                           ("outlier_decode", "outlier_decode_kernel", 3),
                           ("outlier_prefill", "outlier_prefill_kernel", 6),
                           ("paged_decode", "paged_decode_kernel", 8),
                           ("paged_prefill", "paged_prefill_kernel", 8)):
        main = {k: v for k, v in kernels.items() if tag in k}
        check(len(main) == want, f"cuobjdump shows {len(main)} {tag} "
                                 f"kernels, want {want}:\n"
                                 f"{out.stdout[-3000:]}")
        for name, use in main.items():
            check(use["local"] == 0 and use["stack"] == 0,
                  f"{name} uses local memory (spills): {use}")
        result[key] = {k: v for k, v in kernels.items() if key in k}
        log(f"  resource usage, {key}: " + json.dumps(result[key]))
    log(f"  resource usage of {len(kernels)} kernels")
    return result


def kernel_phase(torch, timer, log):
    """Each weight kernel, bf16 and int8, against its plain version at the
    main path's shapes; the int8 weights are quantized from the same
    draws."""
    from repro_torch.core import SparsifyConfig
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.models.sparse_serving import to_sparse_weight

    g = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for name, outlier, mod, fn in (
            ("fused_sparse_linear", "16:256", fsl, fsl.fused_sparse_linear),
            ("nm_spmm", None, nms, nms.nm_spmm)):
        scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern=outlier,
                              scorer="magnitude", use_smoothquant=False)
        cases, cases8 = [], []
        for proj, N, K in PROJECTIONS:
            w = (torch.randn((N, K), generator=g, device="cuda")
                 / math.sqrt(K)).to(torch.bfloat16)
            sw = to_sparse_weight(w, scfg)
            sw8 = to_sparse_weight(w, scfg, quantize=True)
            del w
            for M in MS:
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                cases.append(weight_case(timer, log, name, proj, x, sw, fn,
                                         mod.plain))
                cases8.append(weight_case(timer, log, f"{name}_int8", proj, x,
                                          sw8, fn, mod.plain))
            del sw, sw8
        results[name] = cases
        results[f"{name}_int8"] = cases8
    return results


# the fused wrapper's kernels: decode (M <= T) and prefill (M > T); the old
# tile kernel is timed beside them only
FUSED_SOURCES = ("src/repro_torch/csrc/fused_sparse_linear.cu (M <= T) + "
                 "src/repro_torch/csrc/fused_sparse_linear_prefill.cu "
                 "(M > T); src/repro_torch/csrc/sparse_linear.cu (old tile, "
                 "timed only)")
# nm_spmm: the same two bodies without an outlier stream
NM_SOURCES = ("src/repro_torch/csrc/fused_sparse_linear.cu (M <= T, "
              "nm_decode_*) + src/repro_torch/csrc/fused_sparse_linear_"
              "prefill.cu (M > T, nm_prefill_*); src/repro_torch/csrc/"
              "sparse_linear.cu (old tile, timed only)")
# paged attention: the decode body (rows S * n_rep <= T) and the
# prefill-chunk body (rows > T); the old kernel is timed beside them only
ATTN_SOURCES = ("src/repro_torch/csrc/paged_attention_decode.cu (rows <= T)"
                " + src/repro_torch/csrc/paged_attention_prefill.cu (rows > "
                "T); src/repro_torch/csrc/paged_attention.cu (old, timed "
                "only)")
KERNELS = {        # name: (TPU kernel it replaces, CUDA source)
    "fused_sparse_linear": ("src/repro/kernels/fused_sparse_linear.py:75",
                            FUSED_SOURCES),
    "nm_spmm": ("src/repro/kernels/nm_spmm.py:86", NM_SOURCES),
    "paged_attention": ("src/repro/serving/paged/paged_attention.py:180",
                        ATTN_SOURCES),
    "fused_sparse_linear_int8": (
        "src/repro/kernels/fused_sparse_linear.py:50", FUSED_SOURCES),
    "nm_spmm_int8": ("src/repro/kernels/nm_spmm.py:63", NM_SOURCES),
    "paged_attention_int8": (
        "src/repro/serving/paged/paged_attention.py:124",
        ATTN_SOURCES),
    "outlier_spmm": ("src/repro/kernels/outlier_spmm.py:74",
                     "src/repro_torch/csrc/outlier_spmm.cu (decode body at "
                     "M <= T, prefill body above); src/repro_torch/csrc/"
                     "outlier_spmm_gather8.cu (old kernel, timed only)")}


def outlier_bound(M, N, K, n):
    """Least time for y = x @ O^T at N:256: each outlier's 2-byte value and
    1-byte index, x and y moved once at the HBM rate, or the 2*M*N*K*n/256
    multiply-adds at the bf16 peak, whichever is larger."""
    bytes_moved = N * (K // 256) * n * 3 + M * K * 2 + M * N * 2
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * N * K * n / 256 / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def outlier_gather_ceiling(M, N, K, n):
    """Least time for the M*N*K*n/256 multiply-adds of y = x @ O^T as
    gathers of x from shared memory on the CUDA cores (``GATHER_FMA_PER_S``),
    which no body that reads x per outlier can beat; worked out, not
    measured, so it goes to the log and to phase 8's ops section, not to
    the kernels line."""
    return M * N * (K // 256) * n / GATHER_FMA_PER_S * 1e3


def random_outliers(torch, N, K, n, g):
    """Random N:256 outliers on the card: distinct ascending indices per
    group, index 255 in the last slot of every seventh row."""
    from repro_torch.core import pack_outlier_meta
    idx = torch.rand((N, K // 256, 256), generator=g, device="cuda")
    idx = torch.sort(idx.argsort(-1)[..., :n], dim=-1).values.int()
    idx[::7, :, -1] = 255
    vals = torch.randn((N, K // 256, n), generator=g, device="cuda")
    return vals.to(torch.bfloat16), pack_outlier_meta(idx)


def outlier_sweep_phase(torch, timer, log):
    """``outlier_spmm``'s decode body, prefill body and old kernel side by
    side, each forced, at w_gate and w_down with 16:256 and 4:256 outliers,
    for every M of ``OUTLIER_SWEEP_MS``; every case is gated against the
    plain version.  T is the largest M at which the decode body was no
    slower than the prefill body in all four (projection, n) rows."""
    from repro_torch.kernels import outlier_spmm as osp

    g = torch.Generator(device="cuda").manual_seed(9)
    cases = []
    for proj, N, K in SWEEP_PROJ:
        for n in OUTLIER_SWEEP_N:
            vals, meta = random_outliers(torch, N, K, n, g)
            for M in OUTLIER_SWEEP_MS:
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                plans = {path: osp.plan(M, K, N, n, sm_count(torch),
                                        decode_max_m=limit)
                         for path, limit in (("decode", max(OUTLIER_SWEEP_MS)),
                                             ("prefill", 0))}
                plans["old"] = osp.gather8_plan(M, K, N)
                y_plain = osp.plain(x, vals, meta, n=n)
                tol = KERNEL_TOL_REL * float(y_plain.float().abs().max())
                case = {"proj": proj, "n": n, "M": M}
                for path, pl in plans.items():
                    def run(pl=pl):
                        return osp.outlier_spmm(x, vals, meta, n=n,
                                                force_plan=pl)
                    y = run()
                    torch.cuda.synchronize()
                    err = float((y.float() - y_plain.float()).abs().max())
                    check(bool(torch.isfinite(y).all()) and err <= tol,
                          f"outlier sweep {proj} n={n} M={M} {path}: "
                          f"max|kernel-plain| {err:.3e} > tol {tol:.3e}")
                    case[f"{path}_ms"] = timer.ms(run, 20)
                    case[f"{path}_plan"] = [pl.rows, pl.cols, pl.splits]
                cases.append(case)
                log(f"  sweep outlier_spmm {proj:12s} {n:2d}:256 M={M:3d}: "
                    f"decode {case['decode_ms']:.4f} ms {case['decode_plan']}"
                    f"  prefill {case['prefill_ms']:.4f} "
                    f"{case['prefill_plan']}  old {case['old_ms']:.4f}")
            del vals, meta
    faster = [M for M in OUTLIER_SWEEP_MS
              if all(c["decode_ms"] <= c["prefill_ms"] for c in cases
                     if c["M"] == M)]
    out = {"T_in_module": osp.DECODE_MAX_M,
           "T_measured": max(faster) if faster else 0,
           "decode_no_slower_at": faster, "cases": cases}
    log(f"  sweep outlier_spmm: decode no slower than prefill at M in "
        f"{faster}; T measured {out['T_measured']}, module T "
        f"{osp.DECODE_MAX_M}")
    return out


def case_sums(cases):
    """Times summed over ``cases``; the bound is bytes-bound if most of its
    time is."""
    b_bytes = sum(c["bound_ms"] for c in cases if c["bound_by"] == "bytes")
    b_ops = sum(c["bound_ms"] for c in cases if c["bound_by"] != "bytes")
    out = {"ms": sum(c["ms"] for c in cases),
           "plain_ms": sum(c["plain_ms"] for c in cases),
           "bound_ms": b_bytes + b_ops,
           "bound_by": "bytes" if b_bytes >= b_ops else "operations",
           "library_ms": sum(c["library_ms"] for c in cases)}
    for key in ("tile_ms", "old_ms"):
        if cases and all(key in c for c in cases):
            out[key] = sum(c[key] for c in cases)
    return out


def paths(launches, kernel):
    """A serve's launches of a kernel with a decode and a prefill body
    (``fused_sparse_linear``, ``nm_spmm``, ``paged_attention``, with
    ``_int8`` for that variant) by path, for ``kernel_entry``."""
    name, int8, _ = kernel.partition("_int8")
    return {path: launches[f"{name}_{path}{int8}"]
            for path in ("decode", "prefill")}


def kernel_entry(name, cases, launches, by_path=None):
    """One entry of the kernels line; times are sums over the cases (16
    (projection, M) cases of a weight kernel, the 4 phase-2b cases of paged
    attention, for each variant; 48 (projection, pattern, M) cases of
    outlier_spmm in phase 8(d)).  A weight kernel's entry, outlier_spmm's
    and paged_attention's also split their cases and main-path launches by
    path (``by_path``: decode at M <= T, or rows S * n_rep <= T for paged
    attention; prefill above), each with the old kernel's time on the same
    cases (``tile_ms`` for the weight kernels; ``old_ms`` for outlier_spmm
    and for paged_attention, its old kernel forced on each case)."""
    replaces, source = KERNELS[name]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(c["max_abs_err"] for c in cases),
             **case_sums(cases), "cases": cases}
    for path, n in (by_path or {}).items():
        part = [c for c in cases if c.get("path") == path]
        entry[path] = dict(case_sums(part), launches=n, cases=len(part))
    return entry


# ------------------------------------------------------------------ model
def small_model_phase(torch, log):
    """One prefill step of a small sparse model on the card, on the slot
    layout and on shuffled paged blocks, against the same weights in f32 on
    the CPU: bf16 weights and KV, and int8 weights (quantized from the same
    draws) on int8 KV arenas."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sparse_serving import SparseWeight
    from repro_torch.serving.cache_pool import SlotPoolView, kv_arenas
    from repro_torch.serving.paged import PagedPoolView

    cfg = get_smoke("llama-paper")
    args = serve.parse_args(["--arch", "llama-paper", "--smoke-arch",
                             "--sparse"])
    g = torch.Generator(device="cuda").manual_seed(2)
    params, _ = serve.build_params(cfg, args, "cuda", g)
    params8, _ = serve.build_params(
        cfg, args, "cuda", torch.Generator(device="cuda").manual_seed(2),
        quantize=True)

    def to_cpu_f32(leaf):
        if isinstance(leaf, SparseWeight):
            return leaf.map(lambda t: t.to("cpu", torch.float32)
                            if t.is_floating_point() else t.to("cpu"))
        return leaf.to("cpu", torch.float32)

    def ref(ps):
        return {k: ([{n: to_cpu_f32(v) for n, v in lp.items()} for lp in p]
                    if k == "layers" else to_cpu_f32(p))
                for k, p in ps.items()}

    for ps, dtype in ((params, torch.bfloat16), (params8, torch.int8)):
        check(all(isinstance(lp[n], SparseWeight)
                  and lp[n].o_values is not None
                  and lp[n].nm_values.dtype == dtype
                  for lp in ps["layers"] for n in ("wq", "w_down")),
              f"small model: projections not deployed as {dtype} with "
              f"outliers")
    B, S, max_len = 2, 48, 64
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda")
    bs, per_lane = 16, max_len // 16
    tables = 1 + torch.randperm(B * per_lane + 3, generator=torch.Generator()
                                .manual_seed(2))[:B * per_lane]
    tables = tables.reshape(B, per_lane).numpy()        # block 0: trash
    outs = {}
    # name: (device, params, dtype, kv_dtype, paged)
    runs = {"cuda": ("cuda", params, torch.bfloat16, "bf16", False),
            "cuda_paged": ("cuda", params, torch.bfloat16, "bf16", True),
            "cpu": ("cpu", ref(params), torch.float32, "bf16", False),
            "cuda_int8": ("cuda", params8, torch.bfloat16, "int8", False),
            "cuda_int8_paged": ("cuda", params8, torch.bfloat16, "int8", True),
            "cpu_int8": ("cpu", ref(params8), torch.float32, "int8", False)}
    for name, (dev, p, dtype, kv_dtype, paged) in runs.items():
        c = dataclasses.replace(cfg, dtype=dtype)
        if paged:
            shape = (c.n_layers, B * per_lane + 4, bs, c.n_kv_heads, c.hd)
        else:
            shape = (c.n_layers, B, max_len, c.n_kv_heads, c.hd)
        k, v, ks, vs = kv_arenas(shape, kv_dtype, dtype, dev)
        if paged:
            view = PagedPoolView.build(k, v, tables, [0, 0], [S, S - 5], S,
                                       trash=0, k_scale=ks, v_scale=vs)
        else:
            view = SlotPoolView.build(k, v, [0, 1], [0, 0], [S, S - 5], S,
                                      k_scale=ks, v_scale=vs)
        with torch.no_grad():
            logits, _ = tfm.unified_step(p, view, {"tokens": tokens.to(dev)},
                                         c)
        outs[name] = logits.float().cpu()
    result = {}
    for name, ref_name, key in (("cuda", "cpu", ""),
                                ("cuda_paged", "cpu", "paged_"),
                                ("cuda_int8", "cpu_int8", "int8_"),
                                ("cuda_int8_paged", "cpu_int8",
                                 "int8_paged_")):
        scale = float(outs[ref_name].abs().max())
        err = float((outs[name] - outs[ref_name]).abs().max())
        agree = float((outs[name].argmax(-1) == outs[ref_name].argmax(-1))
                      .float().mean())
        log(f"  small model ({name}): max|card-{ref_name}_f32| {err:.3e} of "
            f"scale {scale:.3e}, greedy agreement {agree:.3f}")
        check(bool(torch.isfinite(outs[name]).all()),
              f"small model ({name}): non-finite")
        check(err <= MODEL_TOL_REL * scale,
              f"small model ({name}): error {err:.3e} > {MODEL_TOL_REL} x "
              f"{scale:.3e}")
        result.update({f"{key}scale": scale, f"{key}max_abs_err": err,
                       f"{key}greedy_agreement": agree})
    return result


def attention_case(torch, g, cursors, S, window, H, KV, hd, bs, nb=0):
    """bf16 q and arenas for one phase-2b case, with shuffled,
    non-contiguous block tables padded with the trash block (id 0) to two
    entries past the longest lane, or to ``nb`` entries if that is more."""
    B = len(cursors)
    need = [-(-(c + S) // bs) for c in cursors]
    nb = max(max(need) + 2, nb)
    n_blocks = 1 + sum(need) + 8
    perm = (torch.randperm(n_blocks - 1, generator=g) + 1).tolist()
    tables = torch.zeros((B, nb), dtype=torch.int32)
    for b, n in enumerate(need):
        tables[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    q = torch.randn((B, S, H, hd), generator=g)
    k = torch.randn((n_blocks, bs, KV, hd), generator=g)
    v = torch.randn((n_blocks, bs, KV, hd), generator=g)
    cur = torch.tensor(cursors, dtype=torch.int32)
    return ([t.to(torch.bfloat16).cuda() for t in (q, k, v)]
            + [tables.cuda(), cur.cuda()])


def attention_bound(cursors, S, window, H, KV, hd, bs, int8=False):
    """Least time for the case: the KV blocks its queries can see read once
    (bf16, or int8 values plus a 4-byte scale per position and KV head)
    plus q read and out written at the HBM rate, or the multiply-adds of
    the visible (query, key) pairs (QK^T and PV) at the bf16 peak."""
    kv_bytes = ops = 0
    per_row = hd + 4 if int8 else 2 * hd     # bytes per (position, KV head)
    for c in cursors:
        lo = 0 if window is None else max(0, c - window + 1)
        blocks = -(-(c + S) // bs) - lo // bs
        kv_bytes += blocks * bs * KV * per_row * 2
        for i in range(S):
            keys = c + i + 1 if window is None else min(c + i + 1, window)
            ops += 4 * H * hd * keys
    qo_bytes = 2 * len(cursors) * S * H * hd * 2
    t_bytes = (kv_bytes + qo_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def row_ratio(out, ref):
    """The worst of paged_attention's output rows (a lane's query and q
    head): max|out - ref| over the row's columns over ``KERNEL_TOL_REL``
    times the row's max|ref| (0 where both are 0, inf where only the
    error is).  The decode body passes at <= 1."""
    err = (out.float() - ref.float()).abs().amax(-1)
    tol = KERNEL_TOL_REL * ref.float().abs().amax(-1)
    ratio = err / tol
    ratio[err == 0] = 0.0
    return float(ratio.max())


def attention_run(torch, timer, log, label, case_args, q, k, v, tables, cur,
                  scales):
    """One phase-2b case of one variant: kernel against plain version, gated
    at one bf16 ulp of the largest output (the decode body: of each row's
    largest output, ``row_ratio``), timed beside the plain version,
    SDPA on the pre-gathered (dequantized) K/V with the same boolean mask
    (the library yardstick, never called by the port) and the bound."""
    import torch.nn.functional as F
    from repro_torch.serving.paged import paged_attention as pa

    name, cursors, S, window = case_args
    kw = dict(window=window)
    if scales is not None:
        kw.update(k_scale=scales[0], v_scale=scales[1])

    def kern():
        return pa.paged_attention(q, k, v, tables, cur, **kw)

    def plain():
        return pa.plain(q, k, v, tables, cur, **kw)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    check(out.shape == q.shape and out.dtype == torch.bfloat16,
          f"{label} {name}: {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()),
          f"{label} {name}: non-finite output")
    B, nb = tables.shape
    bs, KV, hd = k.shape[1], k.shape[2], k.shape[3]
    p = pa.plan(B, S, q.shape[2], KV, hd, bs, sm_count(torch), nb=nb)
    err = float((out.float() - ref.float()).abs().max())
    tol = KERNEL_TOL_REL * float(ref.float().abs().max())
    check(err <= tol, f"{label} {name}: max|kernel-plain| {err:.3e} > tol "
                      f"{tol:.3e}")
    worst = row_ratio(out, ref)
    check(p.path != "decode" or worst <= 1,
          f"{label} {name}: a row's max|kernel-plain| is {worst:.3f} x "
          f"2^-7 of its largest output")
    again = kern()
    torch.cuda.synchronize()
    check(torch.equal(out, again),
          f"{label} {name}: two calls give different bits")

    # the old kernel, which ran every case before the two bodies, forced on
    # the same inputs
    def old():
        return pa.paged_attention(q, k, v, tables, cur,
                                  force_plan=pa.Plan("tile"), **kw)
    o = old()
    torch.cuda.synchronize()
    e = float((o.float() - ref.float()).abs().max())
    check(e <= tol, f"{label} {name}: old kernel max|kernel-plain| "
                    f"{e:.3e} > tol {tol:.3e}")
    idx = tables.long()
    kc, vc = k[idx], v[idx]
    if scales is not None:
        kc = (kc.float() * scales[0][idx][..., None]).to(torch.bfloat16)
        vc = (vc.float() * scales[1][idx][..., None]).to(torch.bfloat16)
    kc = kc.reshape(B, nb * bs, KV, hd).transpose(1, 2)
    vc = vc.reshape(B, nb * bs, KV, hd).transpose(1, 2)
    qt = q.transpose(1, 2)
    qpos = cur[:, None] + torch.arange(S, device="cuda")[None]
    kpos = torch.arange(nb * bs, device="cuda")
    mask = kpos[None, None] <= qpos[..., None]
    if window is not None:
        mask &= kpos[None, None] > qpos[..., None] - window
    mask = mask[:, None]

    def library():
        return F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask,
                                              enable_gqa=True)
    b_ms, b_by = attention_bound(cursors, S, window, **ATTN_SHAPE,
                                 int8=scales is not None)
    case = {"case": name, "B": B, "S": S, "cursors": cursors,
            "window": window, "max_abs_err": err, "tol": tol,
            "row_ratio": worst,
            "path": p.path, "rows": p.rows, "splits": p.splits,
            "ms": timer.ms(kern, 20), "plain_ms": timer.ms(plain, 5),
            "library_ms": timer.ms(library, 20),
            "old_ms": timer.ms(old, 20),
            "bound_ms": b_ms, "bound_by": b_by}
    log(f"  {label:20s} {name:18s}: err {err:.2e} (tol {tol:.2e}, worst "
        f"row {worst:.3f})  "
        f"{p.path} {'R' if p.path == 'decode' else 'BM'} {p.rows} kernel "
        f"{case['ms']:.4f} ms  old kernel {case['old_ms']:.4f}  plain "
        f"{case['plain_ms']:.4f}  "
        f"sdpa {case['library_ms']:.4f}  bound {b_ms:.4f} ({b_by})")
    return case


def paged_attention_phase(torch, timer, log):
    """``paged_attention`` against its plain version at llama3-8b's
    attention shapes, on bf16 arenas and on int8 arenas quantized from the
    same K/V by ``quantize_kv``."""
    from repro_torch.serving.cache_pool import quantize_kv

    g = torch.Generator().manual_seed(3)
    cases, cases8 = [], []
    for case_args in ATTN_CASES:
        _, cursors, S, window = case_args
        q, k, v, tables, cur = attention_case(torch, g, cursors, S, window,
                                              **ATTN_SHAPE)
        cases.append(attention_run(torch, timer, log, "paged_attention",
                                   case_args, q, k, v, tables, cur, None))
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        del k, v
        cases8.append(attention_run(torch, timer, log, "paged_attention_int8",
                                    case_args, q, k8, v8, tables, cur,
                                    (ks, vs)))
        del q, k8, v8, ks, vs
    return cases, cases8


def attention_sweep_phase(torch, timer, log):
    """``paged_attention``'s decode body against its prefill-chunk body,
    and the old kernel beside them, each forced by its plan, bf16 and int8
    arenas, for every S of ``ATTN_SWEEP_S`` (rows S * n_rep = 4..256) at
    two sets of 8 lanes: the decode case's (``long``, cursors 15..1000) and
    ``ATTN_SWEEP_SHORT``'s (``short``, ~64 tokens through 64-entry
    tables); each gated against the plain version (the decode body row by
    row).  T is the largest row count at which the decode body was no
    slower than the prefill-chunk body in both variants at the decode
    case's lanes (0 where it was slower at every row count); the same
    count at the short lanes is reported beside it."""
    from repro_torch.serving.cache_pool import quantize_kv
    from repro_torch.serving.paged import paged_attention as pa

    g = torch.Generator().manual_seed(5)
    H, KV, hd, bs = (ATTN_SHAPE[k] for k in ("H", "KV", "hd", "bs"))
    cases = []
    for lanes, (cursors, nb) in (("long", (ATTN_CASES[0][1], 0)),
                                 ("short", ATTN_SWEEP_SHORT)):
        for S in ATTN_SWEEP_S:
            q, k, v, tables, cur = attention_case(torch, g, cursors, S, None,
                                                  **ATTN_SHAPE, nb=nb)
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            rows = S * H // KV
            plans = {path: pa.plan(len(cursors), S, H, KV, hd, bs,
                                   sm_count(torch), nb=tables.shape[1],
                                   decode_max_rows=limit)
                     for path, limit in (("decode", rows), ("prefill", 0))}
            plans["old"] = pa.Plan("tile")
            for variant, args, kw in (
                    ("bf16", (k, v), {}),
                    ("int8", (k8, v8), dict(k_scale=ks, v_scale=vs))):
                ref = pa.plain(q, *args, tables, cur, **kw)
                tol = KERNEL_TOL_REL * float(ref.float().abs().max())
                case = {"lanes": lanes, "S": S, "rows": rows,
                        "variant": variant, "nb": tables.shape[1],
                        "decode_rows": plans["decode"].rows,
                        "decode_splits": plans["decode"].splits,
                        "prefill_rows": plans["prefill"].rows}
                for path, p in plans.items():
                    def run(p=p):
                        return pa.paged_attention(q, *args, tables, cur,
                                                  force_plan=p, **kw)
                    out = run()
                    torch.cuda.synchronize()
                    err = float((out.float() - ref.float()).abs().max())
                    check(bool(torch.isfinite(out).all()) and err <= tol,
                          f"attention sweep {lanes} {variant} S={S} {path}: "
                          f"max|kernel-plain| {err:.3e} > tol {tol:.3e}")
                    if path == "decode":
                        worst = row_ratio(out, ref)
                        check(worst <= 1,
                              f"attention sweep {lanes} {variant} S={S} "
                              f"decode: a row's max|kernel-plain| is "
                              f"{worst:.3f} x 2^-7 of its largest output")
                        case["decode_row_ratio"] = worst
                    case[f"{path}_ms"] = timer.ms(run, 20)
                    case[f"{path}_err"] = err
                cases.append(case)
                log(f"  attention sweep {lanes:5s} {variant} S={S:3d} "
                    f"rows={rows:4d}: decode {case['decode_ms']:.4f} ms (R "
                    f"{case['decode_rows']}, {case['decode_splits']} splits)"
                    f"  prefill {case['prefill_ms']:.4f} (BM "
                    f"{case['prefill_rows']})  old {case['old_ms']:.4f}")
            del q, k, v, k8, v8, ks, vs

    def no_slower(cs):
        return [r for r in sorted({c["rows"] for c in cs})
                if all(c["decode_ms"] <= c["prefill_ms"] for c in cs
                       if c["rows"] == r)]
    faster, short = (no_slower([c for c in cases if c["lanes"] == lanes])
                     for lanes in ("long", "short"))
    T, T_short = (max(f) if f else 0 for f in (faster, short))
    log(f"  attention sweep: decode body no slower at rows {faster} at the "
        f"decode case's lanes, {short} at short lanes; T measured {T} "
        f"(short lanes {T_short}), module T (DECODE_MAX_ROWS) "
        f"{pa.DECODE_MAX_ROWS}")
    return {"T_measured": T, "T_short_lanes": T_short,
            "T_in_module": pa.DECODE_MAX_ROWS, "decode_no_slower_at": faster,
            "decode_no_slower_at_short_lanes": short, "cases": cases}


def _kernel_class(name: str) -> str:
    for cls in ("fused_decode", "fused_prefill", "nm_decode", "nm_prefill"):
        if cls in name:
            return cls
    if "sparse_linear_kernel" in name:
        return "sparse_linear"
    if any(k in name for k in ("paged_attention_kernel",
                               "paged_decode_kernel",
                               "paged_prefill_kernel")):
        return "paged_attention"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "cublas")):
        return "dense_gemm"
    if "softmax" in name.lower():
        return "softmax"
    return "other"


def profile_decode(torch, engine, g, n_steps=2):
    """Device time by kernel class over ``n_steps`` fused decode steps of
    all 8 lanes (torch.profiler; the profiler's own host cost lengthens the
    wall time it sees, so the idle share is also given against the
    unprofiled decode step).  None when the profiler records no device
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import SamplingParams, Status

    reqs = [engine.submit(torch.randint(0, engine.cfg.vocab, (64,),
                                        generator=g, device="cuda").tolist(),
                          SamplingParams(max_new_tokens=n_steps + 2))
            for _ in range(engine.pool.n_slots)]
    while not all(r.status is Status.RUNNING for r in reqs):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            st = engine.step()
            check(st["prefill_tokens"] == 0 and st["decoded"] == len(reqs),
                  f"profiled step was not a pure decode step: {st}")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    engine.run()
    got = _device_time(prof, n_steps)
    if got is None:
        return None
    busy, by_class, _, top, count = got
    return {"steps": n_steps, "profiled_step_ms": wall_us / n_steps / 1e3,
            "device_busy_ms_per_step": busy,
            "idle_share_profiled": 1.0 - busy * 1e3 * n_steps / wall_us,
            "device_ms_per_step_by_class": by_class,
            "kernels_per_step": count, "top_kernels_ms_per_step": top}


def _device_time(prof, n_steps):
    """From a profile over ``n_steps`` steps: device-busy ms per step (the
    union of the kernels' spans), ms and launches per step by kernel class,
    the six costliest kernels' ms per step, and kernels per step; None when
    the profiler recorded no device kernels."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    by_class, count_by_class, by_name = {}, {}, {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    for e in kernels:
        us, cls = e.time_range.elapsed_us(), _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us / n_steps / 1e3
        count_by_class[cls] = count_by_class.get(cls, 0) + 1 / n_steps
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (busy / n_steps / 1e3, by_class, count_by_class,
            {k: v / n_steps / 1e3 for k, v in top}, len(kernels) / n_steps)


def profile_prefill(torch, engine, g, tokens=PREFILL_PROFILE_TOKENS):
    """Device time by kernel class over one model call that prefills one
    ``tokens``-long prompt as a single chunk on an idle engine
    (torch.profiler), with its launches by class and the device's busy
    share of the profiled call's wall time.  None when the profiler records
    no device kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import SamplingParams

    engine.submit(torch.randint(0, engine.cfg.vocab, (tokens,), generator=g,
                                device="cuda").tolist(),
                  SamplingParams(max_new_tokens=1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(st["prefill_tokens"] == tokens and st["decoded"] == 0,
          f"profiled prefill call was not one {tokens}-token chunk: {st}")
    engine.run()
    got = _device_time(prof, 1)
    if got is None:
        return None
    busy, by_class, count_by_class, top, count = got
    return {"chunk_tokens": tokens, "profiled_call_ms": wall_ms,
            "device_busy_ms": busy, "busy_share_profiled": busy / wall_ms,
            "device_ms_by_class": by_class,
            "launches_by_class": count_by_class, "kernels": count,
            "top_kernels_ms": top}


def build_model(torch, log, *, n_layers=None, outlier="16:256",
                quantize=False):
    """llama3-8b at full width (``n_layers`` deep), every projection a
    SparseWeight (int8 N:M values when ``quantize``), drawn from seed 0;
    returns (cfg, params, build numbers)."""
    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models.sparse_serving import SparseWeight

    cfg = get("llama3-8b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    args = serve.parse_args(["--arch", "llama3-8b", "--sparse",
                             "--outlier-pattern", outlier or "none"])
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params, report = serve.build_params(cfg, args, "cuda", g,
                                        quantize=quantize)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sws = [lp[n] for lp in params["layers"] for n in
           ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    check(len(sws) == 7 * cfg.n_layers
          and all(isinstance(s, SparseWeight) for s in sws),
          "not every projection is a SparseWeight")
    check(all((s.o_values is not None) == (outlier is not None) for s in sws),
          "outlier buffers do not match the pattern")
    want = torch.int8 if quantize else torch.bfloat16
    check(all(s.nm_values.dtype == want and (s.v_scale is not None) == quantize
              for s in sws), f"N:M values are not {want}")
    log(f"  built {cfg.n_layers} layers in {build_s:.1f}s: "
        f"{report['n_layers_sparsified']} matrices, "
        f"{report['compressed_bytes'] / 1e9:.2f} GB compressed "
        f"({report['ratio']:.4f} of dense)")
    return cfg, params, {"build_s": build_s, "outliers": outlier,
                         "values": "int8" if quantize else "bf16",
                         "compressed_gb": report["compressed_bytes"] / 1e9}


def prompts_for(torch, cfg, lens, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(0, cfg.vocab, (n,), generator=g,
                          device="cuda").tolist() for n in lens]


def _counters():
    """(kernel name, module, counter attribute) of every kernel variant."""
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.kernels import outlier_spmm as osp
    from repro_torch.serving.paged import paged_attention as pa
    return [(name + suffix, mod, "launches" + suffix)
            for name, mod in (("fused_sparse_linear", fsl), ("nm_spmm", nms),
                              ("paged_attention", pa))
            for suffix in ("", "_int8")] + [
        (f"paged_attention_tile{suffix}", pa, f"launches_tile{suffix}")
        for suffix in ("", "_int8")] + [
        (f"{name}_{path}{suffix}", mod, f"launches_{path}{suffix}")
        for name, mod in (("fused_sparse_linear", fsl), ("nm_spmm", nms),
                          ("paged_attention", pa))
        for path in ("decode", "prefill") for suffix in ("", "_int8")] + [
        ("outlier_spmm", osp, "launches"),
        ("outlier_spmm_decode", osp, "launches_decode"),
        ("outlier_spmm_prefill", osp, "launches_prefill")]


def reset_launches():
    for _, mod, attr in _counters():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, mod, attr in _counters()}


def drive(torch, engine, waves, gen):
    """Serve ``waves`` of prompts greedily, each wave submitted once every
    request of the earlier waves has finished its prefill, with every
    kernel's launch count set to 0 just before and read just after.
    Returns (requests, wall seconds, decode-only step seconds, launches)."""
    from repro_torch.serving import SamplingParams, Status
    sp = SamplingParams(max_new_tokens=gen)
    reqs, decode_only, pending = [], [], list(waves)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    while pending or engine.has_work:
        if pending and all(r.status not in (Status.QUEUED, Status.PREFILLING)
                           for r in reqs):
            reqs += [engine.submit(p, sp) for p in pending.pop(0)]
        s0 = time.perf_counter()
        st = engine.step()
        torch.cuda.synchronize()
        if st["prefill_tokens"] == 0 and st["decoded"] > 0:
            decode_only.append(time.perf_counter() - s0)
        check(bool(torch.isfinite(engine._slot_logits).all()),
              f"non-finite logits at step {engine.n_steps}")
    wall = time.perf_counter() - t0
    launches = read_launches()
    for r in reqs:
        check(r.status is Status.FINISHED and len(r.tokens) == gen,
              f"request {r.request_id}: {r.status}, {len(r.tokens)} tokens")
        check(all(0 <= t < engine.cfg.vocab for t in r.tokens),
              f"request {r.request_id}: token outside the vocab")
        check(all(math.isfinite(lp) for lp in r.logprobs),
              f"request {r.request_id}: non-finite logprob")
    return reqs, wall, decode_only, launches


def serve_numbers(torch, engine, reqs, wall, decode_only, launches):
    """Check each kernel's launches against the model calls of the run and
    summarise it."""
    import numpy as np
    from repro_torch.runtime.metrics import summarize
    cfg, st = engine.cfg, engine.stats()
    calls = st["n_model_calls"]
    wq = engine.params["layers"][0]["wq"]
    suffix = "" if wq.v_scale is None else "_int8"
    weight_key = ("fused_sparse_linear" if wq.o_values is not None
                  else "nm_spmm") + suffix
    want = {weight_key: 7 * cfg.n_layers * calls}
    attn_key = None
    if engine.kv_layout == "paged":
        attn_key = "paged_attention" + (
            "_int8" if engine.kv_dtype == "int8" else "")
        want[attn_key] = cfg.n_layers * calls
    split = tuple(f"{name}_{path}" for name in ("fused_sparse_linear",
                                                "nm_spmm", "paged_attention")
                  for path in ("decode", "prefill"))
    for key, n in launches.items():
        if key.startswith(split):
            continue
        check(n == want.get(key, 0),
              f"{key} launched {n} times, want {want.get(key, 0)} "
              f"({cfg.n_layers} layers, {calls} model calls, "
              f"{engine.kv_layout} layout, {engine.kv_dtype} KV)")
    # each weight wrapper's calls split by path: every call is a decode
    # kernel launch (M <= T, decode steps) or a prefill kernel launch
    # (chunks longer than T); both run in a serve while T >= 1
    from repro_torch.kernels import fused_sparse_linear as fsl
    for name in ("fused_sparse_linear", "nm_spmm"):
        for suffix in ("", "_int8"):
            dec = launches[f"{name}_decode{suffix}"]
            pre = launches[f"{name}_prefill{suffix}"]
            total = launches[name + suffix]
            check(dec + pre == total,
                  f"{name}{suffix}: decode {dec} + prefill {pre} launches "
                  f"!= the wrapper's {total}")
            if weight_key == name + suffix:
                check(pre > 0 and (dec > 0 or fsl.DECODE_MAX_M == 0),
                      f"{name}{suffix}: decode kernel launched {dec}, "
                      f"prefill kernel {pre} of the wrapper's {total}")
    # the paged kernel's calls split by body: decode steps (S * n_rep <=
    # T) take the decode body, prefill chunks longer than that the
    # prefill-chunk body; both run in a paged serve while T >= 1
    from repro_torch.serving.paged import paged_attention as pa
    for suffix in ("", "_int8"):
        dec = launches[f"paged_attention_decode{suffix}"]
        pre = launches[f"paged_attention_prefill{suffix}"]
        total = launches["paged_attention" + suffix]
        check(dec + pre == total,
              f"paged_attention{suffix}: decode {dec} + prefill {pre} "
              f"launches != the wrapper's {total}")
        if attn_key == "paged_attention" + suffix:
            check(pre > 0 and (dec > 0 or pa.DECODE_MAX_ROWS == 0),
                  f"paged_attention{suffix}: decode body launched {dec}, "
                  f"prefill-chunk body {pre} of the wrapper's {total}")
    s = summarize([r.metrics for r in reqs], wall)
    return {"layers": cfg.n_layers, "kv_layout": engine.kv_layout,
            "kv_dtype": engine.kv_dtype,
            "requests": len(reqs), "tokens": s["total_tokens"],
            "wall_s": wall, "tok_per_s": s["tok_per_s"],
            "ttft_ms": {k: v * 1e3 for k, v in s["ttft"].items()},
            "itl_ms": {k: v * 1e3 for k, v in s["itl"].items()},
            "decode_step_ms": {
                "p50": float(np.percentile(decode_only, 50)) * 1e3,
                "mean": float(np.mean(decode_only)) * 1e3,
                "n": len(decode_only)} if decode_only else None,
            "steps": st["n_steps"], "model_calls": calls,
            "max_running": st["max_running"],
            "n_preemptions": st["n_preemptions"], "launches": launches,
            "pool": st["pool"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def add_profile(torch, engine, out, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    prof = profile_decode(torch, engine, g)
    if prof is not None and out["decode_step_ms"]:
        prof["idle_share_vs_unprofiled_step"] = 1.0 - (
            prof["device_busy_ms_per_step"] / out["decode_step_ms"]["p50"])
    out["decode_profile"] = prof
    out["prefill_profile"] = profile_prefill(torch, engine, g)


def serve_phase(torch, log, cfg, params, build, *, prompt_lens=SERVE_PROMPT_LENS,
                gen=SERVE_GEN, alone=True):
    """Serve ``prompt_lens`` through the slot engine; returns its numbers,
    the requests' token streams and the launches."""
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, params, device="cuda", n_slots=8,
                           max_len=1024, token_budget=512)
    prompts = prompts_for(torch, cfg, prompt_lens, seed=10)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts], gen)
    out = dict(build, **serve_numbers(torch, engine, reqs, wall, decode_only,
                                      launches))
    if alone:
        # each prompt served alone through the same engine, against its
        # stream in the batch (reported, not gated: a batch changes the
        # dense products' and the attention's bf16 rounding)
        match = 0
        for p, r in zip(prompts, reqs):
            solo, *_ = drive(torch, engine, [[p]], gen)
            match += solo[0].tokens == r.tokens
        out["alone_matches_batch"] = f"{match}/{len(reqs)}"
    add_profile(torch, engine, out, seed=11)
    log("  " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()
    return out, [r.tokens for r in reqs], launches


def paged_serve_phase(torch, log, cfg, params, slot_streams):
    """Phase 6: the paged layout, three traffic shapes."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.paged import blocks_needed

    bs = ATTN_SHAPE["bs"]
    base = dict(device="cuda", n_slots=8, max_len=1024, token_budget=512,
                kv_layout="paged", block_size=bs)
    results = {}

    # (a) phase 4's traffic
    engine = ServingEngine(cfg, params, **base)
    prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
    torch.cuda.reset_peak_memory_stats()
    reqs_a, wall, decode_only, launches_a = drive(torch, engine, [prompts],
                                                  SERVE_GEN)
    out = serve_numbers(torch, engine, reqs_a, wall, decode_only, launches_a)
    same = [r.tokens == s for r, s in zip(reqs_a, slot_streams)]
    agree = [a == b for r, s in zip(reqs_a, slot_streams)
             for a, b in zip(r.tokens, s)]
    out["slot_streams_identical"] = f"{sum(same)}/{len(same)}"
    out["slot_token_agreement"] = sum(agree) / len(agree)
    add_profile(torch, engine, out, seed=11)
    results["a_phase4_traffic"] = out
    log("  (a) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()

    # (b) prefix sharing, two waves of 4
    engine = ServingEngine(cfg, params, **base)
    cows = [0]
    copy_on_write = engine.pool.blocks.copy_on_write

    def counted(block):
        cows[0] += 1
        return copy_on_write(block)
    engine.pool.blocks.copy_on_write = counted
    prefix = prompts_for(torch, cfg, [PREFIX_LEN], seed=12)[0]
    wave1 = [prefix + s for s in
             prompts_for(torch, cfg, PREFIX_SUFFIX_LENS[0], seed=13)]
    wave2 = [prefix + s for s in
             prompts_for(torch, cfg, PREFIX_SUFFIX_LENS[1], seed=14)]
    i, n = PREFIX_REPEAT
    wave2.append(wave1[i][:PREFIX_LEN + n])
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [wave1, wave2],
                                              SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches)
    pc = out["pool"]["prefix_cache"]
    out["copy_on_write"] = cows[0]
    check(pc["hits"] > 0 and pc["hit_tokens"] >= 4 * PREFIX_LEN,
          f"prefix sharing: hits {pc['hits']}, hit tokens "
          f"{pc['hit_tokens']} < {4 * PREFIX_LEN}")
    check(cows[0] >= 1, "prefix sharing: no copy-on-write")
    results["b_prefix_sharing"] = out
    log("  (b) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()

    # (c) block pressure: half the blocks (a)'s 8 requests need at once
    need = sum(blocks_needed(n + SERVE_GEN, bs) for n in SERVE_PROMPT_LENS)
    engine = ServingEngine(cfg, params, n_blocks=need // 2, **base)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts],
                                              SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches)
    out["n_blocks"] = need // 2
    out["blocks_needed_at_once"] = need
    check(out["n_preemptions"] > 0, "block pressure: no preemption")
    results["c_block_pressure"] = out
    log("  (c) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()
    return results, launches_a, [r.tokens for r in reqs_a]


def int8_serve_phase(torch, log, cfg, params, paged_streams, pressure):
    """Phase 7: int8 weights on int8 paged KV arenas, (a) phase 4's traffic
    and (b) phase 6(c)'s traffic in the bytes of 6(c)'s bf16 arena."""
    from repro_torch.serving import ServingEngine

    base = dict(device="cuda", n_slots=8, max_len=1024, token_budget=512,
                kv_layout="paged", kv_dtype="int8",
                block_size=ATTN_SHAPE["bs"])
    prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
    results = {}

    # (a) phase 4's traffic, 512 blocks as in 6(a)
    engine = ServingEngine(cfg, params, **base)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches_a = drive(torch, engine, [prompts],
                                                SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches_a)
    same = [r.tokens == s for r, s in zip(reqs, paged_streams)]
    agree = [a == b for r, s in zip(reqs, paged_streams)
             for a, b in zip(r.tokens, s)]
    out["bf16_paged_streams_identical"] = f"{sum(same)}/{len(same)}"
    out["bf16_paged_token_agreement"] = sum(agree) / len(agree)
    add_profile(torch, engine, out, seed=11)
    results["a_phase4_traffic"] = out
    log("  (a) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()

    # (b) equal device memory with 6(c): a bf16 position of one KV head
    # takes 2 x hd bytes in each of K and V, an int8 one hd + 4 (its scale)
    n_blocks = pressure["n_blocks"] * 2 * cfg.hd // (cfg.hd + 4)
    engine = ServingEngine(cfg, params, n_blocks=n_blocks, **base)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts],
                                              SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches)
    out["n_blocks"] = n_blocks
    bf16_bytes = pressure["pool"]["arena_bytes"]
    check(out["pool"]["arena_bytes"] <= bf16_bytes,
          f"equal memory: int8 arena {out['pool']['arena_bytes']} bytes > "
          f"6(c)'s bf16 arena {bf16_bytes}")
    out["vs_6c"] = {"arena_bytes": [out["pool"]["arena_bytes"], bf16_bytes],
                    "n_blocks": [n_blocks, pressure["n_blocks"]],
                    "max_running": [out["max_running"],
                                    pressure["max_running"]],
                    "n_preemptions": [out["n_preemptions"],
                                      pressure["n_preemptions"]]}
    results["b_equal_memory_6c"] = out
    log("  (b) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()
    return results, launches_a


# ------------------------------------------------- phase 9: trace replay
def replay_run(torch, cfg, params, trace_path, time_scale, trace_out=None):
    """One replay of the trace file through the CLI's ``run_trace`` on phase
    6(a)'s paged engine, every kernel's launch count set to 0 just before
    and read just after; returns (run_trace's result, launches)."""
    from repro_torch.launch import serve

    argv = ["--arch", "llama3-8b", "--sparse", "--slots", "8",
            "--max-len", "1024", "--token-budget", "512",
            "--kv-layout", "paged", "--block-size", str(ATTN_SHAPE["bs"]),
            "--n-blocks", "512", "--trace", str(trace_path),
            "--time-scale", str(time_scale)]
    if trace_out is not None:
        argv += ["--trace-out", str(trace_out)]
    args = serve.parse_args(argv)
    torch.cuda.synchronize()
    reset_launches()
    res = serve.run_trace(cfg, params, args, "cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    gen = TRACE["max_new_tokens"]
    for r in res["finished"]:
        check(r.status.value == "finished" and len(r.tokens) == gen,
              f"replay: request {r.request_id}: {r.status}, "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.tokens),
              f"replay: request {r.request_id}: token outside the vocab")
    return res, launches


def phase_ms_per_step(tracer, n_steps):
    """Host ms per step of each engine span (step, plan, chunk, decode,
    emit, jit:*) of a traced run: the sum of the span's durations over the
    steps."""
    out = {}
    for e in tracer.buffer.events:
        if e["ph"] == "X" and e["pid"] == tracer._pid_engine:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return {k: v / max(n_steps, 1) for k, v in sorted(out.items())}


def step_ms(tracer):
    """p50 and count of the traced run's step spans, decode-only steps
    apart from steps that ran a prefill chunk."""
    import numpy as np
    out = {}
    for kind, want in (("decode_only", False), ("with_chunk", True)):
        durs = [e["dur"] / 1e3 for e in tracer.buffer.events
                if e["ph"] == "X" and e["name"] == "step"
                and (e["args"]["prefill_tokens"] > 0) == want]
        out[kind] = {"p50": float(np.percentile(durs, 50)) if durs else None,
                     "n": len(durs)}
    return out


def check_lifecycles(tracer, reqs):
    """Every request's request_summary restates its RequestMetrics
    (tests/test_observe.py's check)."""
    summaries = {e["args"]["id"]: e["args"] for e in tracer.buffer.events
                 if e.get("name") == "request_summary"}
    check(len(summaries) == len(reqs),
          f"trace: {len(summaries)} request summaries, {len(reqs)} requests")
    for r in reqs:
        m, s = r.metrics, summaries[r.request_id]
        got = (s["status"], s["admitted"], s["first_token"], s["finished"],
               s["n_tokens"], s["prefill_chunks"], s["n_preemptions"],
               s["last_preempt_reason"])
        want = (r.status.value, m.admitted, m.first_token, m.finished,
                m.n_tokens, m.prefill_chunks, m.n_preemptions,
                m.last_preempt_reason)
        check(got == want and m.n_tokens == len(r.tokens),
              f"trace: request {r.request_id}'s summary {got} != its "
              f"metrics {want}")


def trace_phase(torch, log, cfg, params):
    """Phase 9: the trace written, read back and replayed through the CLI's
    ``run_trace``, (a) untraced and traced at time scale 0, (b) the traced
    run's trace and counters gated, (c) traced at time scale 1.0."""
    from repro_torch.runtime.metrics import format_summary
    from repro_torch.runtime.telemetry import validate_trace_events
    from repro_torch.serving import load_trace, poisson_trace, save_trace

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace_path = out_dir / "phase9_requests.json"
    made = poisson_trace(vocab=cfg.vocab, **TRACE)
    save_trace(str(trace_path), made)
    check(load_trace(str(trace_path)) == made,
          "trace: load_trace did not return the saved requests")
    n_req, gen = TRACE["n_requests"], TRACE["max_new_tokens"]
    out = {"trace": dict(TRACE, file=str(trace_path.relative_to(ROOT)),
                         prompt_tokens=sum(len(t.prompt) for t in made))}

    # (a) untraced, then traced, at time scale 0
    runs = {}
    for name, trace_out in (("untraced", None),
                            ("traced", out_dir / "phase9_trace.json")):
        res, launches = replay_run(torch, cfg, params, trace_path, 0.0,
                                   trace_out)
        engine = res["engine"]
        check(len(res["finished"]) == n_req and res["rejected"] == 0,
              f"replay ({name}): {len(res['finished'])} finished, "
              f"{res['rejected']} rejected")
        nums = serve_numbers(torch, engine, res["finished"], res["wall_s"],
                             [], launches)
        runs[name] = (res, nums)
    (res_u, nums_u), (res_t, nums_t) = runs["untraced"], runs["traced"]
    streams_u = {r.request_id: r.tokens for r in res_u["finished"]}
    streams_t = {r.request_id: r.tokens for r in res_t["finished"]}
    check(streams_t == streams_u,
          "replay: the traced run's greedy streams differ from the "
          "untraced run's")

    # (b) the traced run's trace and counters
    engine, tracer = res_t["engine"], res_t["tracer"]
    events = validate_trace_events(json.loads(
        (out_dir / "phase9_trace.json").read_text()))
    names = {e["name"] for e in events}
    check(TRACE_SPANS <= names,
          f"trace: spans missing: {sorted(TRACE_SPANS - names)}")
    check_lifecycles(tracer, res_t["finished"])
    lb = {"engine": tracer.name, "family": cfg.family}
    reg = tracer.registry
    decoded = reg.counter("serving_tokens_decoded_total").get(**lb)
    prefilled = reg.counter("serving_tokens_prefilled_total").get(**lb)
    st = engine.stats()
    check(decoded == n_req * gen,
          f"trace: serving_tokens_decoded_total {decoded} != {n_req * gen}")
    check(prefilled == st["n_prefill_tokens"],
          f"trace: serving_tokens_prefilled_total {prefilled} != the "
          f"engine's {st['n_prefill_tokens']}")
    attr = tracer.attribution()
    calls = sum(v["calls"] for v in attr.values())
    check(calls == st["n_model_calls"],
          f"trace: attribution counts {calls} calls, the adapter "
          f"{st['n_model_calls']}")
    out["identity"] = {
        "streams_identical": f"{len(streams_u)}/{n_req}",
        "untraced": nums_u, "traced": nums_t,
        "untraced_tok_per_s": nums_u["tok_per_s"],
        "traced_tok_per_s": nums_t["tok_per_s"],
        "trace_events": len(events),
        "trace_file": "chiprun_out/phase9_trace.json",
        "counters_file": "chiprun_out/phase9_trace.json.counters.txt",
        "prefilled_tokens": prefilled, "decoded_tokens": decoded}
    log(f"  (a) streams identical {len(streams_u)}/{n_req}; tok/s untraced "
        f"{nums_u['tok_per_s']:.2f}, traced {nums_t['tok_per_s']:.2f}")
    log(f"  (b) {len(events)} events, prefilled {prefilled:g}, decoded "
        f"{decoded:g}, {calls} model calls")
    del runs, res_u, res_t, engine, tracer
    torch.cuda.empty_cache()

    # (c) traced at time scale 1.0
    res, launches = replay_run(torch, cfg, params, trace_path, 1.0,
                               out_dir / "phase9_trace_t1.json")
    engine, tracer = res["engine"], res["tracer"]
    nums = serve_numbers(torch, engine, res["finished"], res["wall_s"], [],
                         launches)
    attr = tracer.attribution()

    def ms(x):
        return None if x is None else x * 1e3
    variants = {
        k: {"kind": v["kind"], "shapes": v["shapes"], "calls": v["calls"],
            "first_call_ms": ms(v["first_call_s"]),
            "steady_wall_ms": ms(v["steady_mean_s"]),
            "steady_issue_ms": ms(v["steady_issue_mean_s"]),
            "flops": v["flops"], "bytes_accessed": v["bytes_accessed"]}
        for k, v in attr.items()}
    # each kind's variants pooled, first calls left out
    by_kind = {}
    for v in attr.values():
        k = by_kind.setdefault(v["kind"], {"variants": 0, "calls": 0,
                                           "steady_calls": 0, "wall_s": 0.0,
                                           "issue_s": 0.0})
        k["variants"] += 1
        k["calls"] += v["calls"]
        if v["steady_mean_s"] is not None:
            k["steady_calls"] += v["calls"] - 1
            k["wall_s"] += v["steady_mean_s"] * (v["calls"] - 1)
            k["issue_s"] += v["steady_issue_mean_s"] * (v["calls"] - 1)
    by_kind = {kind: {"variants": k["variants"], "calls": k["calls"],
                      "steady_calls": k["steady_calls"],
                      "steady_wall_ms": ms(k["wall_s"] / k["steady_calls"]
                                           if k["steady_calls"] else None),
                      "steady_issue_ms": ms(k["issue_s"] / k["steady_calls"]
                                            if k["steady_calls"] else None)}
               for kind, k in by_kind.items()}
    out["timed"] = {
        "time_scale": 1.0, "summary_line": format_summary("trace",
                                                          res["summary"]),
        "rejected": res["rejected"], "serve": nums, "by_kind": by_kind,
        "variants": variants,
        "phase_ms_per_step": phase_ms_per_step(tracer, engine.n_steps),
        "step_ms": step_ms(tracer), "steps": engine.n_steps,
        "trace_file": "chiprun_out/phase9_trace_t1.json"}
    log(f"  (c) {out['timed']['summary_line']}")

    def fmt(x):
        return "-" if x is None else f"{x:.3f}"
    for k, v in sorted(by_kind.items()):
        log(f"  (c) {k}: {v['variants']} variants, {v['calls']} calls, "
            f"steady wall {fmt(v['steady_wall_ms'])} ms, issue "
            f"{fmt(v['steady_issue_ms'])} ms")
    for k, v in variants.items():
        log(f"  (c) {k:10s} {str(v['shapes'][-1]):10s} calls {v['calls']:4d}"
            f"  steady wall {fmt(v['steady_wall_ms'])} ms  issue "
            f"{fmt(v['steady_issue_ms'])} ms  flops {v['flops']:.4g}  "
            f"bytes {v['bytes_accessed']:.4g}")
    log("  (c) host ms per step: " + json.dumps(
        out["timed"]["phase_ms_per_step"]))
    log("  (c) step spans: " + json.dumps(out["timed"]["step_ms"]))
    del res, engine, tracer
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- phase 8: pipeline
def calibrate(torch, log, cfg):
    """8(a): the dense bf16 model from seed 0 and its own calibration
    statistics over 4 SyntheticLM batches."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.eval import harness
    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    dense = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticLM(vocab=cfg.vocab, seq_len=CALIB["seq_len"],
                       batch=CALIB["batch"], seed=0)
    batches = data.calibration(CALIB["n_batches"])
    t0 = time.perf_counter()
    stats = harness.collect_activation_stats(cfg, dense, batches)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    tokens = CALIB["n_batches"] * CALIB["batch"] * CALIB["seq_len"]
    want = {f"layers/{i}/{p}" for i in range(cfg.n_layers)
            for p in PROJ_NAMES}
    check(set(stats) == want,
          f"calibration: {len(stats)} leaves, want {len(want)}")
    for name, st in stats.items():
        check(float(st.count) == tokens,
              f"calibration: {name} counted {float(st.count)} tokens")
        check(bool(torch.isfinite(st.sq_sum).all()
                   and torch.isfinite(st.max_abs).all()),
              f"calibration: non-finite statistics for {name}")
    out = {"leaves": len(stats), "tokens": tokens, "init_s": init_s,
           "calibrate_s": calib_s}
    log(f"  (a) {json.dumps(out)}")
    return dense, stats, out


def check_container(torch, name, sw, o_n):
    """8(b)'s gates on one compressed projection: bf16 values, the N:M
    invariant, ``o_n`` distinct ascending outlier indices in every 256-group
    and W_nm zero at every salient slot."""
    from repro_torch.core import (unpack_metadata, unpack_outlier_meta,
                                  validate_nm_mask)
    from repro_torch.core.packing import scatter_blocks
    from repro_torch.models.sparse_serving import SparseWeight

    check(isinstance(sw, SparseWeight) and sw.v_scale is None
          and sw.nm_values.dtype == torch.bfloat16
          and sw.o_values is not None and sw.o_n == o_n
          and sw.o_values.dtype == torch.bfloat16,
          f"{name}: not a bf16 SparseWeight with {o_n}:256 outliers")
    N = sw.nm_values.shape[0]
    idx = unpack_metadata(sw.nm_meta, sw.n).long()
    kept = torch.zeros((N, sw.in_dim // sw.m, sw.m), dtype=torch.bool,
                       device=idx.device).scatter_(-1, idx, True)
    check(validate_nm_mask(kept.reshape(N, -1), (sw.n, sw.m)),
          f"{name}: the {sw.n}:{sw.m} invariant does not hold")
    o_idx = unpack_outlier_meta(sw.o_meta, sw.o_n).long()
    check(bool((o_idx[..., 1:] > o_idx[..., :-1]).all()),
          f"{name}: outlier indices not distinct and ascending")
    salient = torch.zeros((N, sw.in_dim // 256, 256), dtype=torch.bool,
                          device=idx.device).scatter_(-1, o_idx, True)
    w_nm = scatter_blocks(sw.nm_values.reshape(*idx.shape), idx, sw.m)
    check(bool((w_nm.reshape(N, -1)[salient.reshape(N, -1)] == 0).all()),
          f"{name}: W_nm is not zero at every salient slot")


def layer0_checks(torch, log, lp, sparse_lp, st, scfg):
    """8(b) on layer 0: the card's containers against the same pipeline on
    the CPU from the same bf16 weights and statistics, and the unstructured
    mode's salient density."""
    from repro_torch.core import (ActStats, sparsify_linear, unpack_metadata,
                                  unpack_outlier_meta)

    agree = {"nm": [0, 0], "outliers": [0, 0]}
    unstructured, t0 = {}, time.perf_counter()
    for p in PROJ_NAMES:
        sw, s = sparse_lp[p], st[p]
        ref = sparsify_linear(lp[p].cpu(), ActStats(
            s.sq_sum.cpu(), s.max_abs.cpu(), s.count.cpu()), scfg)
        for key, ours, theirs in (
                ("nm", unpack_metadata(sw.nm_meta, sw.n).cpu(),
                 ref.nm.indices),
                ("outliers", unpack_outlier_meta(sw.o_meta, sw.o_n).cpu(),
                 ref.outliers.indices)):
            same = ours == theirs
            agree[key][0] += int(same.sum())
            agree[key][1] += same.numel()
            if key == "outliers":       # copies of the weights: exact
                check(torch.equal(sw.o_values.cpu()[same],
                                  ref.outliers.values[same]),
                      f"layer 0 {p}: salient values differ from the CPU's")
    cpu_s = time.perf_counter() - t0
    for p in PROJ_NAMES:
        w = lp[p]
        sl = sparsify_linear(w, st[p], dataclasses.replace(
            scfg, unstructured_outliers=True))
        k = round(w.numel() * 16 / 256)
        extra = int(sl.salient_mask.sum()) - k
        check(sl.outliers is None and 0 <= extra <= 1,
              f"layer 0 {p} unstructured: {extra:+d} salient entries against "
              f"the 16/256 budget of {k}")
        unstructured[p] = {"salient": k + extra, "budget": k,
                           "density": (k + extra) / w.numel()}
    share = {k: a / n for k, (a, n) in agree.items()}
    for key, val in share.items():
        check(val >= PIPELINE_AGREE, f"layer 0: {key} index agreement with "
                                     f"the CPU {val:.6f} < {PIPELINE_AGREE}")
    out = {"cpu_index_agreement": share,
           "cpu_indices_compared": {k: n for k, (_, n) in agree.items()},
           "cpu_pipeline_s": cpu_s, "unstructured": unstructured}
    log(f"  (b) layer 0: {json.dumps(out)}")
    return out


def compress(torch, log, cfg, dense, stats):
    """8(b): RIA + SmoothQuant + VC to 8:16 + 16:256, one layer at a time on
    the card.  Returns (compressed params, numbers)."""
    from repro_torch.core import SparsifyConfig, compression_report
    from repro_torch.models.sparse_serving import sparsify_for_serving

    scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256")
    report = {"n_layers_sparsified": 0, "dense_bytes": 0,
              "compressed_bytes": 0}
    paper_bytes, layers, seconds = 0, [], []
    for i, lp in enumerate(dense["layers"]):
        st = {p: stats[f"layers/{i}/{p}"] for p in PROJ_NAMES}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, rep = sparsify_for_serving(lp, scfg, st)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        for p in PROJ_NAMES:
            check_container(torch, f"layer {i} {p}", new[p], 16)
            paper_bytes += compression_report(
                *lp[p].shape, "8:16", "16:256")["compressed_bytes"]
        for key in report:
            report[key] += rep[key]
        layers.append(new)
    sparse = dict(dense, layers=layers)
    out = {"config": dataclasses.asdict(scfg), "seconds_per_layer": {
        "mean": sum(seconds) / len(seconds), "max": max(seconds),
        "total": sum(seconds)},
        "compressed_gb": report["compressed_bytes"] / 1e9,
        "dense_gb": report["dense_bytes"] / 1e9,
        "ratio": report["compressed_bytes"] / report["dense_bytes"],
        "paper_accounting_gb": paper_bytes / 1e9,
        "matrices": report["n_layers_sparsified"]}
    log(f"  (b) {json.dumps(out)}")
    out["layer0"] = layer0_checks(torch, log, dense["layers"][0], layers[0],
                                  {p: stats[f"layers/0/{p}"]
                                   for p in PROJ_NAMES}, scfg)
    return sparse, scfg, out


def pipeline_serve(torch, log, cfg, sparse, paged_a):
    """8(c): phase 6(a)'s traffic on the paged layout from the compressed
    params, with 6(a)'s numbers of the same run beside."""
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, sparse, device="cuda", n_slots=8,
                           max_len=1024, token_budget=512, kv_layout="paged",
                           block_size=ATTN_SHAPE["bs"])
    prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts],
                                              SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches)
    add_profile(torch, engine, out, seed=11)
    out["vs_6a"] = {
        "decode_step_p50_ms": [out["decode_step_ms"]["p50"],
                               paged_a["decode_step_ms"]["p50"]],
        "tok_per_s": [out["tok_per_s"], paged_a["tok_per_s"]],
        "ttft_p50_ms": [out["ttft_ms"]["p50"], paged_a["ttft_ms"]["p50"]],
        "itl_p50_ms": [out["itl_ms"]["p50"], paged_a["itl_ms"]["p50"]]}
    log(f"  (c) {json.dumps(out)}")
    del engine
    torch.cuda.empty_cache()
    return out


def ops_phase(torch, timer, log, lp, st):
    """8(d): ``kernels/ops`` on layer 0's four projection shapes, each
    outlier pattern and M; the counts are set to 0 just before each group of
    ``ops`` calls and read just after, and the comparisons and timings
    run outside them.  Returns (cases, launches, ceilings): ``ceilings``
    gives each case's gather ceiling, worked out, not measured, so it
    stays out of the cases of the kernels line."""
    import torch.nn.functional as F
    from repro_torch.core import (SparsifyConfig, pack_outlier_meta,
                                  sparsify_linear)
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.kernels import ops
    from repro_torch.kernels import outlier_spmm as osp

    g = torch.Generator(device="cuda").manual_seed(8)
    cases, launches, ceilings = [], {}, []
    for p in OPS_PROJ:
        w = lp[p]
        N, K = w.shape
        for pat in OPS_PATTERNS:
            sl = sparsify_linear(w, st[p], SparsifyConfig(
                weight_pattern="8:16", outlier_pattern=pat))
            o, nm = sl.outliers, sl.nm
            vals, meta = o.values, pack_outlier_meta(o.indices)
            nm_meta = nm.packed_metadata()
            dense_o = o.to_dense()
            del sl
            for M in MS:
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                torch.cuda.synchronize()
                reset_launches()
                y = ops.outlier_matmul(x, o)
                if pat == "16:256":
                    y_nm = ops.nm_matmul(x, nm)
                    y_fused = ops.sparse_linear_apply(x, nm, o)
                torch.cuda.synchronize()
                for key, n in read_launches().items():
                    launches[key] = launches.get(key, 0) + n
                y_plain = osp.plain(x, vals, meta, n=o.n)
                check(y.shape == (M, N) and y.dtype == torch.bfloat16
                      and bool(torch.isfinite(y).all()),
                      f"outlier_spmm {p} {pat} M={M}: {tuple(y.shape)} "
                      f"{y.dtype} or non-finite")
                err = float((y.float() - y_plain.float()).abs().max())
                tol = KERNEL_TOL_REL * float(y_plain.float().abs().max())
                check(err <= tol, f"outlier_spmm {p} {pat} M={M}: "
                                  f"max|kernel-plain| {err:.3e} > {tol:.3e}")
                b_ms, b_by = outlier_bound(M, N, K, o.n)
                case = {"proj": p, "pattern": pat, "N": N, "K": K, "M": M,
                        "max_abs_err": err, "tol": tol,
                        "ms": timer.ms(lambda: osp.outlier_spmm(
                            x, vals, meta, n=o.n), 20),
                        "plain_ms": timer.ms(lambda: osp.plain(
                            x, vals, meta, n=o.n), 5),
                        "library_ms": timer.ms(lambda: F.linear(x, dense_o),
                                               20),
                        "bound_ms": b_ms, "bound_by": b_by}
                ceiling = outlier_gather_ceiling(M, N, K, o.n)
                # the plan's body (decode at M <= T, prefill above): the
                # same inputs twice give the same bits, and the old kernel
                # is timed beside it on the same inputs
                op = osp.plan(M, K, N, o.n, sm_count(torch))
                again = osp.outlier_spmm(x, vals, meta, n=o.n)
                torch.cuda.synchronize()
                check(torch.equal(y, again), f"outlier_spmm {p} {pat} M={M}: "
                                             f"two calls give different bits")
                old_plan = osp.gather8_plan(M, K, N)
                case.update(path=op.path, rows=op.rows, cols=op.cols,
                            splits=op.splits,
                            old_ms=timer.ms(lambda: osp.outlier_spmm(
                                x, vals, meta, n=o.n, force_plan=old_plan),
                                20))
                if pat == "16:256":
                    pair = y_nm + y
                    u_err = float((pair.float() - y_fused.float()).abs().max())
                    u_tol = UNFUSED_TOL_REL * sum(
                        float(t.float().abs().max()) for t in (y_nm, y,
                                                               y_fused))
                    check(u_err <= u_tol, f"ops {p} M={M}: unfused pair vs "
                                          f"fused {u_err:.3e} > {u_tol:.3e}")
                    case.update(
                        unfused_err=u_err, unfused_tol=u_tol,
                        unfused_ms=timer.ms(lambda: nms.nm_spmm(
                            x, nm.values, nm_meta, n=nm.n, m=nm.m)
                            + osp.outlier_spmm(x, vals, meta, n=o.n), 20),
                        fused_ms=timer.ms(lambda: fsl.fused_sparse_linear(
                            x, nm.values, nm_meta, vals, meta, n=nm.n,
                            m=nm.m, o_n=o.n), 20))
                cases.append(case)
                ceilings.append({"proj": p, "pattern": pat, "M": M,
                                 "path": op.path, "ms": ceiling})
                log(f"  (d) outlier_spmm {p:7s} {pat:6s} M={M:4d}: err "
                    f"{err:.2e} (tol {tol:.2e})  {op.path} {op.rows}x"
                    f"{op.cols} S={op.splits} {case['ms']:.4f} ms  old "
                    f"{case['old_ms']:.4f}  plain {case['plain_ms']:.4f}  "
                    f"F.linear {case['library_ms']:.4f}  bound {b_ms:.4f} "
                    f"({b_by})  gather ceiling {ceiling:.4f}"
                    + (f"  unfused {case['unfused_ms']:.4f} fused "
                       f"{case['fused_ms']:.4f}" if pat == "16:256" else ""))
            del o, nm, vals, meta, nm_meta, dense_o
    n16 = len(OPS_PROJ) * len(MS)
    want = {"outlier_spmm": len(OPS_PATTERNS) * n16, "nm_spmm": n16,
            "fused_sparse_linear": n16}
    for name in ("nm_spmm", "fused_sparse_linear"):   # split by path
        want[f"{name}_decode"] = len(OPS_PROJ) * sum(
            M <= fsl.DECODE_MAX_M for M in MS)
        want[f"{name}_prefill"] = len(OPS_PROJ) * sum(
            M > fsl.DECODE_MAX_M for M in MS)
    for path, count in (("decode", sum(M <= osp.DECODE_MAX_M for M in MS)),
                        ("prefill", sum(M > osp.DECODE_MAX_M for M in MS))):
        want[f"outlier_spmm_{path}"] = (len(OPS_PATTERNS) * len(OPS_PROJ)
                                        * count)
    for key, n in launches.items():
        check(n == want.get(key, 0),
              f"ops path: {key} launched {n} times, want {want.get(key, 0)}")
    return cases, launches, ceilings


def perplexity_phase(torch, log, cfg, dense, sparse, stats, scfg):
    """8(e): perplexities, reported; the compressed params' forward (fused
    kernel) against the dense-effective params' (torch.matmul), gated."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.eval import harness
    from repro_torch.models import transformer as tfm

    data = SyntheticLM(vocab=cfg.vocab, seq_len=PPL["seq_len"],
                       batch=PPL["batch"], seed=0)
    n = PPL["n_batches"]
    out = {"tokens": n * PPL["batch"] * PPL["seq_len"],
           "ppl_dense": harness.eval_ppl(cfg, dense, data, n_batches=n)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    effective = harness.sparsify_model(cfg, dense, stats, scfg)
    torch.cuda.synchronize()
    out["sparsify_model_s"] = time.perf_counter() - t0
    check(all(isinstance(lp[p], torch.Tensor) for lp in effective["layers"]
              for p in PROJ_NAMES),
          "sparsify_model: a projection is not a dense tensor")
    out["ppl_dense_effective"] = harness.eval_ppl(cfg, effective, data,
                                                  n_batches=n)
    out["ppl_compressed"] = harness.eval_ppl(cfg, sparse, data, n_batches=n)
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in data.batch_at(50_000).items()}
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches()
        logits, _ = tfm.forward(sparse, batch, cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        reset_launches()
        ref, _ = tfm.forward(effective, batch, cfg)
        torch.cuda.synchronize()
        dense_launches = read_launches()
    del effective
    torch.cuda.empty_cache()
    for key, count in launches.items():
        # 2 x 512 rows a projection: the prefill kernel
        want = 7 * cfg.n_layers if key in (
            "fused_sparse_linear", "fused_sparse_linear_prefill") else 0
        check(count == want, f"forward: {key} launched {count}, want {want}")
    check(not any(dense_launches.values()),
          f"dense-effective forward launched sparse kernels: "
          f"{dense_launches}")
    check(bool(torch.isfinite(logits).all()), "forward: non-finite logits")
    scale = float(ref.float().abs().max())
    err = float((logits.float() - ref.float()).abs().max())
    out.update(layers=cfg.n_layers, logit_scale=scale, max_abs_err=err,
               tol=MODEL_TOL_REL * scale,
               greedy_agreement=float((logits.argmax(-1) == ref.argmax(-1))
                                      .float().mean()))
    log(f"  (e) {json.dumps(out)}")
    check(err <= MODEL_TOL_REL * scale,
          f"forward: compressed vs dense-effective {err:.3e} > "
          f"{MODEL_TOL_REL} x {scale:.3e}")
    return out


def pipeline_phase(torch, log, paged_a):
    """Phase 8: the paper's pipeline on llama3-8b, (a) to (e)."""
    from repro_torch.configs import get

    cfg = get("llama3-8b")
    dense, stats, calib = calibrate(torch, log, cfg)
    sparse, scfg, comp = compress(torch, log, cfg, dense, stats)
    served = pipeline_serve(torch, log, cfg, sparse, paged_a)
    timer = Timer(torch)
    cases, launches, ceilings = ops_phase(torch, timer, log,
                                          dense["layers"][0],
                                          {p: stats[f"layers/0/{p}"]
                                           for p in PROJ_NAMES})
    del timer
    ppl = perplexity_phase(torch, log, cfg, dense, sparse, stats, scfg)
    del dense, sparse
    torch.cuda.empty_cache()
    fused = [c for c in cases if "fused_ms" in c]
    out = {"calibrate": calib, "compress": comp, "serve": served,
           "ops": {"launches": launches,
                   "outlier_spmm_ms": sum(c["ms"] for c in cases),
                   "outlier_spmm_old_ms": sum(c["old_ms"] for c in cases),
                   "unfused_ms": sum(c["unfused_ms"] for c in fused),
                   "fused_ms": sum(c["fused_ms"] for c in fused),
                   # worked out from the shapes (outlier_gather_ceiling)
                   "outlier_spmm_gather_ceiling_ms": {
                       "decode": sum(c["ms"] for c in ceilings
                                     if c["path"] == "decode"),
                       "prefill": sum(c["ms"] for c in ceilings
                                      if c["path"] == "prefill"),
                       "prefill_by_pattern": {
                           pat: sum(c["ms"] for c in ceilings
                                    if c["path"] == "prefill"
                                    and c["pattern"] == pat)
                           for pat in OPS_PATTERNS},
                       "cases": ceilings}},
           "perplexity": ppl}
    return out, cases, launches


def main() -> int:
    import torch

    def log(msg):
        print(msg, flush=True)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    log(f"phase 1 build: {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f}s")
    resources = resource_usage(lib, log)

    timer = Timer(torch)
    log("phase 2 weight kernels vs plain versions (bf16 and int8 values, L2 "
        "flushed per call)")
    cases = kernel_phase(torch, timer, log)
    log("phase 2 sweep: decode kernel vs prefill kernel (and the old tile "
        "kernel) of fused_sparse_linear and nm_spmm, w_gate and w_down")
    sweep = sweep_phase(torch, timer, log)
    log("phase 2 sweep: outlier_spmm's decode body vs prefill body (and the "
        "old kernel), w_gate and w_down, 16:256 and 4:256")
    sweep["outlier_spmm"] = outlier_sweep_phase(torch, timer, log)
    log("phase 2b paged_attention vs plain version (bf16 and int8 arenas, L2 "
        "flushed)")
    attn_cases, attn_cases8 = paged_attention_phase(torch, timer, log)
    log("phase 2b sweep: paged_attention's decode body vs prefill-chunk "
        "body, bf16 and int8 arenas, S 1..64 over the decode case's lanes")
    sweep["paged_attention"] = attention_sweep_phase(torch, timer, log)
    del timer
    log("phase 3 small-model reference check")
    small = small_model_phase(torch, log)
    log("phase 4 serve llama3-8b, 32 layers, 8:16+16:256")
    cfg, params, build_info = build_model(torch, log)
    main_serve, slot_streams, main_launches = serve_phase(
        torch, log, cfg, params, build_info)
    log("phase 5 serve llama3-8b, 4 layers, plain 8:16")
    cfg5, params5, build5 = build_model(torch, log, n_layers=4, outlier=None)
    plain_serve, _, plain_launches = serve_phase(
        torch, log, cfg5, params5, build5, prompt_lens=PLAIN_PROMPT_LENS,
        gen=PLAIN_GEN, alone=False)
    del params5
    log("phase 5 (int8) serve llama3-8b, 4 layers, plain 8:16, int8 values")
    cfg5, params5, build5 = build_model(torch, log, n_layers=4, outlier=None,
                                        quantize=True)
    plain_serve8, _, plain_launches8 = serve_phase(
        torch, log, cfg5, params5, build5, prompt_lens=PLAIN_PROMPT_LENS,
        gen=PLAIN_GEN, alone=False)
    del params5
    log("phase 6 serve llama3-8b, 32 layers, 8:16+16:256, paged layout")
    paged_serve, paged_launches, paged_streams = paged_serve_phase(
        torch, log, cfg, params, slot_streams)
    log("phase 9 replay a Poisson trace through launch/serve.run_trace, "
        "untraced and traced (phase 4's params, phase 6(a)'s engine)")
    replay = trace_phase(torch, log, cfg, params)
    del params
    torch.cuda.empty_cache()
    log("phase 7 serve llama3-8b, 32 layers, int8 8:16 + bf16 16:256, int8 "
        "paged KV")
    cfg, params, build_info8 = build_model(torch, log, quantize=True)
    int8_serve, int8_launches = int8_serve_phase(
        torch, log, cfg, params, paged_streams,
        paged_serve["c_block_pressure"])
    for run in int8_serve.values():
        run.update(build_info8)
    del params
    torch.cuda.empty_cache()
    log("phase 8 the paper's pipeline on llama3-8b, 32 layers: calibrate, "
        "compress (RIA + SmoothQuant + VC), serve, ops, perplexity")
    pipeline, ops_cases, ops_launches = pipeline_phase(
        torch, log, paged_serve["a_phase4_traffic"])

    kernels = {"kernels": [
        kernel_entry("fused_sparse_linear", cases["fused_sparse_linear"],
                     main_launches["fused_sparse_linear"],
                     paths(main_launches, "fused_sparse_linear")),
        kernel_entry("nm_spmm", cases["nm_spmm"], plain_launches["nm_spmm"],
                     paths(plain_launches, "nm_spmm")),
        kernel_entry("paged_attention", attn_cases,
                     paged_launches["paged_attention"],
                     paths(paged_launches, "paged_attention")),
        kernel_entry("fused_sparse_linear_int8",
                     cases["fused_sparse_linear_int8"],
                     int8_launches["fused_sparse_linear_int8"],
                     paths(int8_launches, "fused_sparse_linear_int8")),
        kernel_entry("nm_spmm_int8", cases["nm_spmm_int8"],
                     plain_launches8["nm_spmm_int8"],
                     paths(plain_launches8, "nm_spmm_int8")),
        kernel_entry("paged_attention_int8", attn_cases8,
                     int8_launches["paged_attention_int8"],
                     paths(int8_launches, "paged_attention_int8")),
        kernel_entry("outlier_spmm", ops_cases,
                     ops_launches["outlier_spmm"],
                     {path: ops_launches[f"outlier_spmm_{path}"]
                      for path in ("decode", "prefill")})]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    serves = {"serve": main_serve, "serve_plain_nm": plain_serve,
              "serve_plain_nm_int8": plain_serve8, "serve_paged": paged_serve,
              "serve_int8_paged": int8_serve, "pipeline": pipeline,
              "replay": replay}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "seconds": time.perf_counter() - t_start,
         "kernels": kernels["kernels"], "resources": resources,
         "sweep": sweep, "small_model": small, **serves},
        indent=1))
    print(json.dumps(serves))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
