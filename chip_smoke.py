#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero and prints no result):

  1. device and build: the card's name and power limit; the CUDA kernels
     built from ``src/repro_torch/csrc/`` into ``build/kernels/``;
  2. kernels against their plain PyTorch versions at the llama3-8b
     projection shapes ([4096->4096], [4096->1024], [4096->14336],
     [14336->4096]) and M in {1, 8, 37, 512}, both kernels (the fused one on
     8:16+16:256 weights, ``nm_spmm`` on plain 8:16), timed with CUDA events
     beside the plain version, one ``F.linear`` on the densified weight (the
     library yardstick, never called by the port) and the card's bound;
  3. a small-model reference check: the llama-paper smoke model served one
     step on the card (bf16, kernels), on the slot layout and on shuffled
     paged blocks, against the same weights in f32 on the CPU (plain
     versions, slot layout);
  4. the main path: llama3-8b at full width and depth with every projection
     deployed as 8:16+16:256, served through ``ServingEngine`` (8 slots,
     max_len 1024, 8 greedy requests with prompts of 64..768 tokens, token
     budget 512, 32 new tokens each); the fused kernel must launch exactly
     7 x 32 times per model call;
  5. plain 8:16 (no outliers) at 4 layers, full width, which puts
     ``nm_spmm`` on the engine path;
  2b. ``paged_attention`` against its plain version at llama3-8b's attention
     shapes (H 32, KV 8, hd 128, block size 16): decode (S=1, B=8, cursors
     up to 1000), chunks (S=512 at cursor 256; S=64 over 4 lanes, with and
     without a 128-token window), shuffled trash-padded block tables; timed
     beside the plain version, one ``scaled_dot_product_attention`` on the
     pre-gathered K/V (the library yardstick, never called by the port) and
     the card's bound;
  6. the paged layout: the phase-4 model served by
     ``ServingEngine(kv_layout="paged", block_size=16)``, with the paged
     kernel launching once per layer per model call:
       (a) phase 4's traffic, with decode profile and greedy agreement with
           phase 4's slot streams (reported, not gated);
       (b) prefix sharing: 8 requests on one 512-token prefix in two waves of
           4, the second after the first wave's prefills; gates prefix-cache
           hits, hit tokens >= 4 x 512 and a copy-on-write;
       (c) block pressure: (a)'s traffic with half the blocks it needs at
           once; gates preemptions.

Prints the kernels line ``{"kernels": [...]}``, the serve numbers, the
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.  Run alone (without the checkout) or
without CUDA it fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak
PROJECTIONS = [("wq/wo", 4096, 4096), ("wk/wv", 1024, 4096),
               ("w_gate/w_up", 14336, 4096), ("w_down", 4096, 14336)]
MS = [1, 8, 37, 512]
# Kernel vs plain: both multiply exact bf16 products and accumulate in f32;
# only the summation order and the final rounding to bf16 differ, so they
# may differ by one bf16 ulp of an output, at most 2**-7 of the largest
# output magnitude.
KERNEL_TOL_REL = 2.0 ** -7
# Small-model check: bf16 activations through 4 layers against an f32
# reference; a wrong kernel gives errors of the order of the logits.
MODEL_TOL_REL = 5e-2
SERVE_PROMPT_LENS = [64, 160, 256, 352, 448, 544, 640, 768]
SERVE_GEN = 32
# phase 2b: (name, lanes' cursors, S, window) at H 32, KV 8, hd 128, bs 16
ATTN_SHAPE = dict(H=32, KV=8, hd=128, bs=16)
ATTN_CASES = [("decode", [63, 200, 500, 700, 767, 1000, 15, 16], 1, None),
              ("chunk512", [256], 512, None),
              ("chunk64", [0, 64, 300, 700], 64, None),
              ("chunk64_window128", [0, 64, 300, 700], 64, 128)]
# phase 6(b): a shared 512-token prefix, 8 distinct suffixes in two waves
# (the last of wave 2 repeats the start of a wave-1 suffix, so its whole
# prompt is cached and its recomputed last token forces a copy-on-write)
PREFIX_LEN = 512
PREFIX_SUFFIX_LENS = [[32, 96, 160, 256], [64, 128, 200]]
PREFIX_REPEAT = (1, 48)          # wave-1 suffix 1, its first 48 tokens


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


def kernel_phase(torch, timer, log):
    """Each kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F
    from repro_torch.core import SparsifyConfig
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.kernels.ref import decompress_nm
    from repro_torch.core import unpack_metadata, unpack_outlier_meta
    from repro_torch.models.sparse_serving import to_sparse_weight

    g = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for name, outlier in (("fused_sparse_linear", "16:256"),
                          ("nm_spmm", None)):
        scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern=outlier)
        cases = []
        for proj, N, K in PROJECTIONS:
            w = (torch.randn((N, K), generator=g, device="cuda")
                 / math.sqrt(K)).to(torch.bfloat16)
            sw = to_sparse_weight(w, scfg)
            del w
            dense = decompress_nm(sw.nm_values, unpack_metadata(sw.nm_meta, 8),
                                  16, dtype=torch.float32)
            if outlier is not None:
                dense += decompress_nm(
                    sw.o_values.reshape(N, -1),
                    unpack_outlier_meta(sw.o_meta, sw.o_n), 256,
                    dtype=torch.float32)
            dense = dense.to(torch.bfloat16)
            if outlier is None:
                def kern(x, sw=sw):
                    return nms.nm_spmm(x, sw.nm_values, sw.nm_meta, n=8, m=16)

                def plain(x, sw=sw):
                    return nms.plain(x, sw.nm_values, sw.nm_meta, n=8, m=16)
            else:
                def kern(x, sw=sw):
                    return fsl.fused_sparse_linear(
                        x, sw.nm_values, sw.nm_meta, sw.o_values, sw.o_meta,
                        n=8, m=16, o_n=sw.o_n)

                def plain(x, sw=sw):
                    return fsl.plain(x, sw.nm_values, sw.nm_meta, sw.o_values,
                                     sw.o_meta, n=8, m=16, o_n=sw.o_n)
            for M in MS:
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                y = kern(x)
                y_plain = plain(x)
                torch.cuda.synchronize()
                check(y.shape == (M, N) and y.dtype == torch.bfloat16,
                      f"{name} {proj} M={M}: shape {tuple(y.shape)} {y.dtype}")
                check(bool(torch.isfinite(y).all()),
                      f"{name} {proj} M={M}: non-finite output")
                err = float((y.float() - y_plain.float()).abs().max())
                scale = float(y_plain.float().abs().max())
                tol = KERNEL_TOL_REL * scale
                check(err <= tol, f"{name} {proj} M={M}: max|kernel-plain| "
                                  f"{err:.3e} > tol {tol:.3e}")
                b_ms, b_by = bound(M, N, K, 8, 16, sw.o_n, sw)
                case = {"proj": proj, "N": N, "K": K, "M": M,
                        "max_abs_err": err, "tol": tol,
                        "ms": timer.ms(lambda: kern(x), 20),
                        "plain_ms": timer.ms(lambda: plain(x), 5),
                        "library_ms": timer.ms(lambda: F.linear(x, dense), 20),
                        "bound_ms": b_ms, "bound_by": b_by}
                cases.append(case)
                log(f"  {name:20s} {proj:12s} M={M:4d}: err {err:.2e} "
                    f"(tol {tol:.2e})  kernel {case['ms']:.4f} ms  plain "
                    f"{case['plain_ms']:.4f}  F.linear "
                    f"{case['library_ms']:.4f}  bound {b_ms:.4f} ({b_by})")
            del sw, dense
        results[name] = cases
    return results


def kernel_entry(name, cases, launches):
    b_bytes = sum(c["bound_ms"] for c in cases if c["bound_by"] == "bytes")
    b_ops = sum(c["bound_ms"] for c in cases if c["bound_by"] != "bytes")
    replaces, source = {
        "fused_sparse_linear": ("src/repro/kernels/fused_sparse_linear.py:75",
                                "src/repro_torch/csrc/sparse_linear.cu"),
        "nm_spmm": ("src/repro/kernels/nm_spmm.py:86",
                    "src/repro_torch/csrc/sparse_linear.cu"),
        "paged_attention": (
            "src/repro/serving/paged/paged_attention.py:180",
            "src/repro_torch/csrc/paged_attention.cu")}[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            # times are sums over the cases below (16 (projection, M) cases
            # of a weight kernel, the 4 phase-2b cases of paged attention)
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": b_bytes + b_ops,
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": sum(c["library_ms"] for c in cases),
            "cases": cases}


# ------------------------------------------------------------------ model
def small_model_phase(torch, log):
    """One prefill step of a small sparse model on the card, on the slot
    layout and on shuffled paged blocks, against the same weights in f32 on
    the CPU."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sparse_serving import SparseWeight
    from repro_torch.serving.cache_pool import SlotPoolView
    from repro_torch.serving.paged import PagedPoolView

    cfg = get_smoke("llama-paper")
    args = serve.parse_args(["--arch", "llama-paper", "--smoke-arch",
                             "--sparse"])
    g = torch.Generator(device="cuda").manual_seed(2)
    params, _ = serve.build_params(cfg, args, "cuda", g)

    def to_cpu_f32(leaf):
        if isinstance(leaf, SparseWeight):
            return leaf.map(lambda t: t.to("cpu", torch.float32)
                            if t.is_floating_point() else t.to("cpu"))
        return leaf.to("cpu", torch.float32)

    ref_params = {k: ([{n: to_cpu_f32(v) for n, v in lp.items()} for lp in p]
                      if k == "layers" else to_cpu_f32(p))
                  for k, p in params.items()}
    check(all(isinstance(lp[n], SparseWeight) and lp[n].o_values is not None
              for lp in params["layers"] for n in ("wq", "w_down")),
          "small model: projections not deployed with outliers")
    B, S, max_len = 2, 48, 64
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda")
    bs, per_lane = 16, max_len // 16
    tables = 1 + torch.randperm(B * per_lane + 3, generator=torch.Generator()
                                .manual_seed(2))[:B * per_lane]
    tables = tables.reshape(B, per_lane).numpy()        # block 0: trash
    outs = {}
    for name, dev, p, dtype in (("cuda", "cuda", params, torch.bfloat16),
                                ("cuda_paged", "cuda", params, torch.bfloat16),
                                ("cpu", "cpu", ref_params, torch.float32)):
        c = dataclasses.replace(cfg, dtype=dtype)
        if name == "cuda_paged":
            shape = (c.n_layers, B * per_lane + 4, bs, c.n_kv_heads, c.hd)
        else:
            shape = (c.n_layers, B, max_len, c.n_kv_heads, c.hd)
        k = torch.zeros(shape, dtype=dtype, device=dev)
        v = torch.zeros(shape, dtype=dtype, device=dev)
        if name == "cuda_paged":
            view = PagedPoolView.build(k, v, tables, [0, 0], [S, S - 5], S,
                                       trash=0)
        else:
            view = SlotPoolView.build(k, v, [0, 1], [0, 0], [S, S - 5], S)
        with torch.no_grad():
            logits, _ = tfm.unified_step(p, view, {"tokens": tokens.to(dev)},
                                         c)
        outs[name] = logits.float().cpu()
    scale = float(outs["cpu"].abs().max())
    result = {"scale": scale}
    for name in ("cuda", "cuda_paged"):
        err = float((outs[name] - outs["cpu"]).abs().max())
        agree = float((outs[name].argmax(-1) == outs["cpu"].argmax(-1))
                      .float().mean())
        log(f"  small model ({name}): max|card-cpu_f32| {err:.3e} of scale "
            f"{scale:.3e}, greedy agreement {agree:.3f}")
        check(bool(torch.isfinite(outs[name]).all()),
              f"small model ({name}): non-finite")
        check(err <= MODEL_TOL_REL * scale,
              f"small model ({name}): error {err:.3e} > {MODEL_TOL_REL} x "
              f"{scale:.3e}")
        key = "" if name == "cuda" else "paged_"
        result.update({f"{key}max_abs_err": err,
                       f"{key}greedy_agreement": agree})
    return result


def attention_case(torch, g, cursors, S, window, H, KV, hd, bs):
    """bf16 q and arenas for one phase-2b case, with shuffled,
    non-contiguous block tables padded with the trash block (id 0)."""
    B = len(cursors)
    need = [-(-(c + S) // bs) for c in cursors]
    nb = max(need) + 2
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


def attention_bound(cursors, S, window, H, KV, hd, bs):
    """Least time for the case: the KV blocks its queries can see read once
    plus q read and out written at the HBM rate, or the multiply-adds of
    the visible (query, key) pairs (QK^T and PV) at the bf16 peak."""
    kv_bytes = ops = 0
    for c in cursors:
        lo = 0 if window is None else max(0, c - window + 1)
        blocks = -(-(c + S) // bs) - lo // bs
        kv_bytes += blocks * bs * KV * hd * 2 * 2
        for i in range(S):
            keys = c + i + 1 if window is None else min(c + i + 1, window)
            ops += 4 * H * hd * keys
    qo_bytes = 2 * len(cursors) * S * H * hd * 2
    t_bytes = (kv_bytes + qo_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def paged_attention_phase(torch, timer, log):
    """``paged_attention`` against its plain version at llama3-8b's
    attention shapes."""
    import torch.nn.functional as F
    from repro_torch.serving.paged import paged_attention as pa

    g = torch.Generator().manual_seed(3)
    cases = []
    for name, cursors, S, window in ATTN_CASES:
        q, k, v, tables, cur = attention_case(torch, g, cursors, S, window,
                                              **ATTN_SHAPE)

        def kern():
            return pa.paged_attention(q, k, v, tables, cur, window=window)

        def plain():
            return pa.plain(q, k, v, tables, cur, window=window)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        check(out.shape == q.shape and out.dtype == torch.bfloat16,
              f"paged_attention {name}: {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()),
              f"paged_attention {name}: non-finite output")
        err = float((out.float() - ref.float()).abs().max())
        tol = KERNEL_TOL_REL * float(ref.float().abs().max())
        check(err <= tol, f"paged_attention {name}: max|kernel-plain| "
                          f"{err:.3e} > tol {tol:.3e}")
        # the library yardstick: SDPA on the pre-gathered contiguous K/V
        # with the same boolean mask
        B, nb = tables.shape
        bs, KV, hd = k.shape[1], k.shape[2], k.shape[3]
        kc = k[tables.long()].reshape(B, nb * bs, KV, hd).transpose(1, 2)
        vc = v[tables.long()].reshape(B, nb * bs, KV, hd).transpose(1, 2)
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
        b_ms, b_by = attention_bound(cursors, S, window, **ATTN_SHAPE)
        case = {"case": name, "B": B, "S": S, "cursors": cursors,
                "window": window, "max_abs_err": err, "tol": tol,
                "ms": timer.ms(kern, 20), "plain_ms": timer.ms(plain, 5),
                "library_ms": timer.ms(library, 20),
                "bound_ms": b_ms, "bound_by": b_by}
        cases.append(case)
        log(f"  paged_attention {name:18s}: err {err:.2e} (tol {tol:.2e})  "
            f"kernel {case['ms']:.4f} ms  plain {case['plain_ms']:.4f}  "
            f"sdpa {case['library_ms']:.4f}  bound {b_ms:.4f} ({b_by})")
        del q, k, v, kc, vc, qt, mask
    return cases


def _kernel_class(name: str) -> str:
    if "sparse_linear_kernel" in name:
        return "sparse_linear"
    if "paged_attention_kernel" in name:
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
    from torch.autograd import DeviceType
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
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    by_class, by_name = {}, {}
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
        us = e.time_range.elapsed_us()
        by_class[_kernel_class(e.name)] = by_class.get(
            _kernel_class(e.name), 0.0) + us / n_steps / 1e3
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": n_steps, "profiled_step_ms": wall_us / n_steps / 1e3,
            "device_busy_ms_per_step": busy / n_steps / 1e3,
            "idle_share_profiled": 1.0 - busy / wall_us,
            "device_ms_per_step_by_class": by_class,
            "kernels_per_step": len(kernels) / n_steps,
            "top_kernels_ms_per_step": {k: v / n_steps / 1e3 for k, v in top}}


def build_model(torch, log, *, n_layers=None, outlier="16:256"):
    """llama3-8b at full width (``n_layers`` deep), every projection a
    SparseWeight, drawn from seed 0; returns (cfg, params, build numbers)."""
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
    params, report = serve.build_params(cfg, args, "cuda", g)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sws = [lp[n] for lp in params["layers"] for n in
           ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    check(len(sws) == 7 * cfg.n_layers
          and all(isinstance(s, SparseWeight) for s in sws),
          "not every projection is a SparseWeight")
    check(all((s.o_values is not None) == (outlier is not None) for s in sws),
          "outlier buffers do not match the pattern")
    log(f"  built {cfg.n_layers} layers in {build_s:.1f}s: "
        f"{report['n_layers_sparsified']} matrices, "
        f"{report['compressed_bytes'] / 1e9:.2f} GB compressed "
        f"({report['ratio']:.4f} of dense)")
    return cfg, params, {"build_s": build_s, "outliers": outlier,
                         "compressed_gb": report["compressed_bytes"] / 1e9}


def prompts_for(torch, cfg, lens, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(0, cfg.vocab, (n,), generator=g,
                          device="cuda").tolist() for n in lens]


def reset_launches():
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.serving.paged import paged_attention as pa
    nms.launches = fsl.launches = pa.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.serving.paged import paged_attention as pa
    return {"nm_spmm": nms.launches, "fused_sparse_linear": fsl.launches,
            "paged_attention": pa.launches}


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
    outlier = engine.params["layers"][0]["wq"].o_values is not None
    want = 7 * cfg.n_layers * calls
    key = "fused_sparse_linear" if outlier else "nm_spmm"
    other = "nm_spmm" if outlier else "fused_sparse_linear"
    check(launches[key] == want,
          f"{key} launched {launches[key]} times, want 7 x {cfg.n_layers} x "
          f"{calls} model calls = {want}")
    check(launches[other] == 0, f"{other} launched {launches[other]} times")
    paged = engine.kv_layout == "paged"
    want_pa = cfg.n_layers * calls if paged else 0
    check(launches["paged_attention"] == want_pa,
          f"paged_attention launched {launches['paged_attention']} times, "
          f"want {want_pa} ({engine.kv_layout} layout, {calls} model calls)")
    s = summarize([r.metrics for r in reqs], wall)
    return {"layers": cfg.n_layers, "kv_layout": engine.kv_layout,
            "requests": len(reqs), "tokens": s["total_tokens"],
            "wall_s": wall, "tok_per_s": s["tok_per_s"],
            "ttft_ms": {k: v * 1e3 for k, v in s["ttft"].items()},
            "itl_ms": {k: v * 1e3 for k, v in s["itl"].items()},
            "decode_step_ms": {
                "p50": float(np.percentile(decode_only, 50)) * 1e3,
                "mean": float(np.mean(decode_only)) * 1e3,
                "n": len(decode_only)} if decode_only else None,
            "steps": st["n_steps"], "model_calls": calls,
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
    reqs, wall, decode_only, launches_a = drive(torch, engine, [prompts],
                                                SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches_a)
    same = [r.tokens == s for r, s in zip(reqs, slot_streams)]
    agree = [a == b for r, s in zip(reqs, slot_streams)
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
    return results, launches_a


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

    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    log(f"phase 1 build: {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f}s")

    timer = Timer(torch)
    log("phase 2 kernels vs plain versions (bf16, L2 flushed per call)")
    cases = kernel_phase(torch, timer, log)
    log("phase 2b paged_attention vs plain version (bf16, L2 flushed)")
    attn_cases = paged_attention_phase(torch, timer, log)
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
        torch, log, cfg5, params5, build5, prompt_lens=[128, 96, 200, 64],
        gen=8, alone=False)
    del params5
    log("phase 6 serve llama3-8b, 32 layers, 8:16+16:256, paged layout")
    paged_serve, paged_launches = paged_serve_phase(torch, log, cfg, params,
                                                    slot_streams)
    del params
    torch.cuda.empty_cache()

    kernels = {"kernels": [
        kernel_entry("fused_sparse_linear", cases["fused_sparse_linear"],
                     main_launches["fused_sparse_linear"]),
        kernel_entry("nm_spmm", cases["nm_spmm"], plain_launches["nm_spmm"]),
        kernel_entry("paged_attention", attn_cases,
                     paged_launches["paged_attention"])]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "kernels": kernels["kernels"], "small_model": small,
         "serve": main_serve, "serve_plain_nm": plain_serve,
         "serve_paged": paged_serve}, indent=1))
    print(json.dumps({"serve": main_serve, "serve_plain_nm": plain_serve,
                      "serve_paged": paged_serve}))
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
