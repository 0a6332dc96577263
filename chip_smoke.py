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
     step on the card (bf16, kernels) against the same weights in f32 on
     the CPU (plain versions);
  4. the main path: llama3-8b at full width and depth with every projection
     deployed as 8:16+16:256, served through ``ServingEngine`` (8 slots,
     max_len 1024, 8 greedy requests with prompts of 64..768 tokens, token
     budget 512, 32 new tokens each); the fused kernel must launch exactly
     7 x 32 times per model call;
  5. plain 8:16 (no outliers) at 4 layers, full width, which puts
     ``nm_spmm`` on the engine path.

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
    replaces = {"fused_sparse_linear":
                "src/repro/kernels/fused_sparse_linear.py:75",
                "nm_spmm": "src/repro/kernels/nm_spmm.py:86"}[name]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sparse_linear.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            # times are sums over the 16 (projection, M) cases below
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": b_bytes + b_ops,
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": sum(c["library_ms"] for c in cases),
            "cases": cases}


# ------------------------------------------------------------------ model
def small_model_phase(torch, log):
    """One prefill step of a small sparse model on the card against the same
    weights in f32 on the CPU."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sparse_serving import SparseWeight
    from repro_torch.serving.cache_pool import SlotPoolView

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
    outs = {}
    for dev, p, dtype in (("cuda", params, torch.bfloat16),
                          ("cpu", ref_params, torch.float32)):
        c = dataclasses.replace(cfg, dtype=dtype)
        shape = (c.n_layers, B, max_len, c.n_kv_heads, c.hd)
        k = torch.zeros(shape, dtype=dtype, device=dev)
        v = torch.zeros(shape, dtype=dtype, device=dev)
        view = SlotPoolView.build(k, v, [0, 1], [0, 0], [S, S - 5], S)
        with torch.no_grad():
            logits, _ = tfm.unified_step(p, view, {"tokens": tokens.to(dev)},
                                         c)
        outs[dev] = logits.float().cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    scale = float(outs["cpu"].abs().max())
    agree = float((outs["cuda"].argmax(-1) == outs["cpu"].argmax(-1))
                  .float().mean())
    log(f"  small model: max|card-cpu_f32| {err:.3e} of scale {scale:.3e}, "
        f"greedy agreement {agree:.3f}")
    check(bool(torch.isfinite(outs["cuda"]).all()), "small model: non-finite")
    check(err <= MODEL_TOL_REL * scale,
          f"small model: error {err:.3e} > {MODEL_TOL_REL} x {scale:.3e}")
    return {"max_abs_err": err, "scale": scale, "greedy_agreement": agree}


def _kernel_class(name: str) -> str:
    if "sparse_linear_kernel" in name:
        return "sparse_linear"
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


def serve_phase(torch, log, *, n_layers=None, outlier="16:256",
                prompt_lens=SERVE_PROMPT_LENS, gen=SERVE_GEN, alone=True):
    """Serve llama3-8b (full width) through ServingEngine; returns numbers."""
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.launch import serve
    from repro_torch.models.sparse_serving import SparseWeight
    from repro_torch.runtime.metrics import summarize
    from repro_torch.serving import SamplingParams, ServingEngine, Status

    cfg = get("llama3-8b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    args = serve.parse_args(["--arch", "llama3-8b", "--sparse",
                             "--outlier-pattern", outlier or "none"])
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
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

    engine = ServingEngine(cfg, params, device="cuda", n_slots=8,
                           max_len=1024, token_budget=512)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g,
                             device="cuda").tolist() for n in prompt_lens]
    sp = SamplingParams(max_new_tokens=gen)

    nms.launches = 0
    fsl.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, sp) for p in prompts]
    step_times, decode_only = [], []
    while engine.has_work:
        s0 = time.perf_counter()
        st = engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - s0
        step_times.append(dt)
        if st["prefill_tokens"] == 0 and st["decoded"] > 0:
            decode_only.append(dt)
        check(bool(torch.isfinite(engine._slot_logits).all()),
              f"non-finite logits at step {engine.n_steps}")
    wall = time.perf_counter() - t0
    launches = {"nm_spmm": nms.launches, "fused_sparse_linear": fsl.launches}
    calls = engine.stats()["n_model_calls"]

    for r in reqs:
        check(r.status is Status.FINISHED and len(r.tokens) == gen,
              f"request {r.request_id}: {r.status}, {len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.tokens),
              f"request {r.request_id}: token outside the vocab")
        check(all(math.isfinite(lp) for lp in r.logprobs),
              f"request {r.request_id}: non-finite logprob")
    want = 7 * cfg.n_layers * calls
    key = "fused_sparse_linear" if outlier else "nm_spmm"
    other = "nm_spmm" if outlier else "fused_sparse_linear"
    check(launches[key] == want,
          f"{key} launched {launches[key]} times, want 7 x {cfg.n_layers} x "
          f"{calls} model calls = {want}")
    check(launches[other] == 0, f"{other} launched {launches[other]} times")

    s = summarize([r.metrics for r in reqs], wall)
    out = {"layers": cfg.n_layers, "outliers": outlier,
           "requests": len(reqs), "tokens": s["total_tokens"],
           "wall_s": wall, "tok_per_s": s["tok_per_s"],
           "ttft_ms": {k: v * 1e3 for k, v in s["ttft"].items()},
           "itl_ms": {k: v * 1e3 for k, v in s["itl"].items()},
           "decode_step_ms": {
               "p50": float(np.percentile(decode_only, 50)) * 1e3,
               "mean": float(np.mean(decode_only)) * 1e3,
               "n": len(decode_only)} if decode_only else None,
           "steps": engine.n_steps, "model_calls": calls,
           "launches": launches, "build_s": build_s,
           "compressed_gb": report["compressed_bytes"] / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if alone:
        # each prompt served alone through the same engine, against its
        # stream in the batch (reported, not gated: a batch changes the
        # dense products' and the attention's bf16 rounding)
        match = 0
        for p, r in zip(prompts, reqs):
            solo = engine.submit(p, sp)
            engine.run()
            match += solo.tokens == r.tokens
        out["alone_matches_batch"] = f"{match}/{len(reqs)}"
        prof = profile_decode(torch, engine, g)
        if prof is not None and decode_only:
            prof["idle_share_vs_unprofiled_step"] = 1.0 - (
                prof["device_busy_ms_per_step"]
                / out["decode_step_ms"]["p50"])
        out["decode_profile"] = prof
    log("  " + json.dumps(out))
    del engine, params
    torch.cuda.empty_cache()
    return out, launches


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

    log("phase 2 kernels vs plain versions (bf16, L2 flushed per call)")
    cases = kernel_phase(torch, Timer(torch), log)
    log("phase 3 small-model reference check")
    small = small_model_phase(torch, log)
    log("phase 4 serve llama3-8b, 32 layers, 8:16+16:256")
    main_serve, main_launches = serve_phase(torch, log)
    log("phase 5 serve llama3-8b, 4 layers, plain 8:16")
    plain_serve, plain_launches = serve_phase(
        torch, log, n_layers=4, outlier=None, prompt_lens=[128, 96, 200, 64],
        gen=8, alone=False)

    kernels = {"kernels": [
        kernel_entry("fused_sparse_linear", cases["fused_sparse_linear"],
                     main_launches["fused_sparse_linear"]),
        kernel_entry("nm_spmm", cases["nm_spmm"], plain_launches["nm_spmm"])]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "kernels": kernels["kernels"], "small_model": small,
         "serve": main_serve, "serve_plain_nm": plain_serve}, indent=1))
    print(json.dumps({"serve": main_serve, "serve_plain_nm": plain_serve}))
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
