#!/usr/bin/env python3
"""Variants of paged_attention's split-KV decode body timed side by side on
one card.

    python3 scripts/paged_decode_ab.py [--ss 1,2,4] [--arenas bf16,int8]
                                       [--variants base,stages3,...]

Each variant is ``src/repro_torch/csrc/paged_attention_decode.cu`` with a
few text substitutions, built with the port's nvcc flags into its own
library under ``build/ab_decode/`` and called through its C entry points
with the rows of ``serving/paged/paged_attention.plan`` (decode path) and
a workspace and counters sized for the variant's span of keys a split
(``kSpan`` in its source).  Every variant runs on the inputs of
``chip_smoke.py``'s phase-2b decode case (llama3-8b's attention shapes, H
32, KV 8, hd 128, block size 16, 8 lanes at cursors 15..1000, shuffled
trash-padded tables; int8 arenas quantized from the same K/V) at each S of
``--ss``, in turn, timed like ``chip_smoke.py`` (CUDA events, L2 flushed,
mean of 20 calls); the prefill-chunk body, the old kernel and the bound
stand beside them.  The diagnostic variants compute wrong results on
purpose and are marked so: each takes out one part of the work to show
what it costs, or (``dropsplit``) plants a fault to show that the gate
catches it.

Every variant is held against the plain version by ``chip_smoke.py``'s
gate for the decode body, row by row (``row_ratio`` <= 1), and, for
comparison, by the gate at the scale of the call's largest output; a
correct variant that fails the row gate stops the script, a diagnostic
one prints which gates it passes.

  base        the source as it is (a ring of 2 slots, spans of 128 keys)
  stages3     a ring of 3 slots
  span64      spans of 64 keys (twice the splits)
  span256     spans of 256 keys (half the splits)
  splitmajor  the grid (row tiles x KV, B, splits): every lane's first
              span dispatched before any lane's second
  empty       (diagnostic) every block returns at once: the launch and
              the timer alone
  nocombine   (diagnostic) every live split writes its own normalized
              output, with no workspace, counter or merge
  dropsplit   (diagnostic) the last live split of each row tile hands the
              merge an empty partial (acc and l zero): its keys are lost,
              as with a lost split
  notiles     (diagnostic) no tile: the launch, the live-split count, the
              q load and the combine alone
  nocopies    (diagnostic) no K/V copies: the tiles' products run on
              whatever the ring holds
  noproducts  (diagnostic) no score or P V products (the copies, softmax
              and barriers remain)

Prints each variant's registers and spills (ptxas), one line per case and
the total per variant; needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "paged_attention_decode.cu"
OUT = ROOT / "build" / "ab_decode"
# name: (substitutions, correct)
VARIANTS = {
    "base": ([], True),
    "stages3": ([("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
                True),
    "span64": ([("constexpr int kSpan = 128;", "constexpr int kSpan = 64;")],
               True),
    "span256": ([("constexpr int kSpan = 128;", "constexpr int kSpan = 256;")],
                True),
    "nocombine": ([("  const int live = s_hi - s_lo + 1;",
                    "  const int live = 1;")], False),
    "dropsplit": ([("      reinterpret_cast<float4*>(part + r * HD + d)[0] = "
                    "sum;",
                    "      reinterpret_cast<float4*>(part + r * HD + d)[0] = "
                    "split == s_hi ? make_float4(0.f, 0.f, 0.f, 0.f) : sum;"),
                   ("    part[R * HD + R + tid] = sl[tid];",
                    "    part[R * HD + R + tid] = split == s_hi ? 0.f : "
                    "sl[tid];")], False),
    "notiles": ([("  const int tiles = j_hi > j_lo ? (j_hi - j_lo + kTK - 1) "
                  "/ kTK : 0;", "  const int tiles = 0;")], False),
    "splitmajor": ([("  const int split = blockIdx.x % a.splits, tile = "
                     "blockIdx.x / a.splits;\n  const int kvh = blockIdx.y, "
                     "b = blockIdx.z;",
                     "  const int split = blockIdx.z, tile = blockIdx.x / "
                     "a.KV;\n  const int kvh = blockIdx.x % a.KV, b = "
                     "blockIdx.y;"),
                    ("  const dim3 grid(a.splits * a.tiles, a.KV, B);",
                     "  const dim3 grid(a.tiles * a.KV, B, a.splits);")],
                   True),
    "empty": ([("  const int cur = a.cursor[b];",
                "  if (a.S > 0) return;\n  const int cur = a.cursor[b];")],
              False),
    "nocopies": ([("  auto issue = [&](int t) {\n    if (t >= tiles) return;",
                   "  auto issue = [&](int t) {\n    if (t >= 0) return;")],
                 False),
    "noproducts": ([("      for (int c = 0; c < CPR / 2; ++c) {",
                     "      for (int c = 0; c < 0; ++c) {"),
                    ("    for (int i = 0; i < kTK / G; ++i) {",
                     "    for (int i = 0; i < 0; ++i) {")], False),
}
ENTRY = ("paged_attention_decode_bf16", "paged_attention_decode_int8")


def resources(ptxas: str) -> list[str]:
    """Registers and spill bytes of each decode instance, from ``-Xptxas
    -v`` output."""
    out, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"paged_decode_kernelILi(\d+)ELi(\d+)E(\w+?)E", line)
        if m and "Compiling" in line:
            name = (f"hd{m.group(1)}/R{m.group(2)}/"
                    f"{'int8' if m.group(3) == 'a' else 'bf16'}")
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name and spill.group(1) != "0":
            out.append(f"{name}: {spill.group(1)} bytes spilled")
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append(f"{name} {regs.group(1)} regs")
            name = None
    return out


def build_variants(build, names):
    """One library per variant, all nvcc processes started together; with
    each variant's span of keys a split."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    procs, spans = {}, {}
    for name in names:
        text = source
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {SRC.name}")
            text = text.replace(old, new)
        spans[name] = int(re.search(r"constexpr int kSpan = (\d+);",
                                    text).group(1))
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *build.include_flags(),
             "-Xptxas", "-v", "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{output}")
        print(f"{name}: " + "; ".join(resources(output)), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn in ENTRY:
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, spans


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ss", default="1",
                    help="query rows a lane, comma-separated")
    ap.add_argument("--arenas", default="bf16,int8",
                    help="arena types, comma-separated (bf16, int8)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="variants to build and time, comma-separated")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_decode_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.serving.cache_pool import quantize_kv
    from repro_torch.serving.paged import paged_attention as pa

    print(cs.nvidia_smi_line(), flush=True)
    names = args.variants.split(",")
    libs, spans = build_variants(build, names)
    timer = cs.Timer(torch)
    g = torch.Generator().manual_seed(3)
    sms = cs.sm_count(torch)
    stream = torch.cuda.current_stream().cuda_stream
    shape = cs.ATTN_SHAPE
    H, KV, hd, bs = (shape[k] for k in ("H", "KV", "hd", "bs"))
    cursors = cs.ATTN_CASES[0][1]
    totals = {}
    for S in map(int, args.ss.split(",")):
        q, k, v, tables, cur = cs.attention_case(torch, g, cursors, S, None,
                                                 **shape)
        B, nb = tables.shape
        rows = S * H // KV
        dec = pa.plan(B, S, H, KV, hd, bs, sms, nb=nb, decode_max_rows=rows)
        pre = pa.plan(B, S, H, KV, hd, bs, sms, nb=nb, decode_max_rows=0)
        tiles = -(-rows // dec.rows)
        for arena in args.arenas.split(","):
            if arena == "int8":
                (kk, ks), (vv, vs) = quantize_kv(k), quantize_kv(v)
                scales = dict(k_scale=ks, v_scale=vs)
                ptrs = [kk.data_ptr(), vv.data_ptr(), ks.data_ptr(),
                        vs.data_ptr()]
            else:
                kk, vv, scales = k, v, {}
                ptrs = [k.data_ptr(), v.data_ptr()]
            out = torch.empty_like(q)
            ref = pa.plain(q, kk, vv, tables, cur, **scales)
            tol = cs.KERNEL_TOL_REL * float(ref.float().abs().max())
            line = f"S={S:<3d} {arena}"
            for name in names:
                splits = -(-nb * bs // spans[name])
                ws = torch.empty(max(1, B * KV * tiles * splits * dec.rows
                                     * (hd + 2)), dtype=torch.float32,
                                 device="cuda")
                cnt = torch.zeros(B * KV * tiles, dtype=torch.int32,
                                  device="cuda")
                fn = getattr(libs[name], f"paged_attention_decode_{arena}")

                def run():
                    status = fn(q.data_ptr(), *ptrs, tables.data_ptr(),
                                cur.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                cnt.data_ptr(), B, S, H, KV, hd, bs, nb,
                                kk.shape[0], 0, dec.rows, stream)
                    build.check(status, name)
                out.fill_(float("nan"))   # no earlier variant's output
                run()
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                worst = cs.row_ratio(out, ref)
                if VARIANTS[name][1] and not worst <= 1:
                    raise SystemExit(f"{name} S={S} {arena}: a row's error "
                                     f"is {worst:.3f} x 2^-7 of its largest "
                                     f"output")
                if not VARIANTS[name][1]:
                    print(f"  {name} S={S} {arena} (diagnostic): row gate "
                          f"{'passes' if worst <= 1 else 'FAILS'} (worst row "
                          f"{worst:.3f}), largest-output gate "
                          f"{'passes' if err <= tol else 'FAILS'} (error "
                          f"{err:.3e}, tol {tol:.3e})", flush=True)
                ms = timer.ms(run, 20)
                totals[name] = totals.get(name, 0.0) + ms
                line += f"  {name} {ms * 1e3:.1f}"
            pre_us = timer.ms(lambda: pa.paged_attention(
                q, kk, vv, tables, cur, force_plan=pre, **scales), 20) * 1e3
            old_us = timer.ms(lambda: pa.paged_attention(
                q, kk, vv, tables, cur, force_plan=pa.Plan("tile"),
                **scales), 20) * 1e3
            b_ms, b_by = cs.attention_bound(cursors, S, None, **shape,
                                            int8=arena == "int8")
            print(f"{line}  prefill body {pre_us:.1f}  old kernel "
                  f"{old_us:.1f}  bound {b_ms * 1e3:.1f} ({b_by}) (us)",
                  flush=True)
    print("total ms " + json.dumps(totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
