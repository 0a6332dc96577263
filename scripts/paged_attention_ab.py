#!/usr/bin/env python3
"""Variants of paged_attention's prefill-chunk body timed side by side on one
card.

    python3 scripts/paged_attention_ab.py [--cases chunk512,chunk64,...]
                                          [--arenas bf16,int8]
                                          [--variants base,stages2,...]
                                          [--bms plan,64,128]

Each variant is ``src/repro_torch/csrc/paged_attention_prefill.cu`` with a
few text substitutions, built with the port's nvcc flags into its own
library under ``build/ab_attention/`` and called through its C entry points
with the plan of ``serving/paged/paged_attention.plan`` (prefill path; its
BM replaced by ``--bms``).  Every variant runs on the same inputs as
``chip_smoke.py``'s phase 2b (llama3-8b's attention shapes, H 32, KV 8, hd
128, block size 16, shuffled trash-padded tables; int8 arenas quantized
from the same K/V), case by case in turn, timed like ``chip_smoke.py``
(CUDA events, L2 flushed, mean of 20 calls); the decode body and the bound
stand beside them.  The diagnostic variants compute wrong results on
purpose and are marked so: each takes out one part of the work to show
what it costs.

  base        the source as it is (a ring of 3 slots)
  stages2     a ring of 2 slots (int8: 3)
  div         the first build's table lookup: a runtime division by bs
              inside the lookup's condition, and j % bs, instead of a
              multiply-high before it
  cvt         int8 converted to bf16 on the conversion unit (I2F, F2FP),
              as first built, instead of by byte permutes and an f32 add
  late        the next tile's copies issued after this tile's PV products
              instead of before its QK^T products
  nocopies    (diagnostic) no K/V copies after the prologue's: the loop
              reuses the first tiles
  noproducts  (diagnostic) no tensor-core products
  nomask      (diagnostic) no tile masked
  noconvert   (diagnostic) int8: no conversion of the tiles to bf16 after
              the first
  hot         (diagnostic) every copy from one of 8 arena rows (the same
              addresses, instructions and copies, no gather traffic)
  notiles     (diagnostic) no tile: the launch, the q copies and the
              epilogue alone

Prints each variant's registers and spills (ptxas) and any wgmma
serialization ptxas reports, one line per case and the total per
variant; needs one card.
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
SRC = ROOT / "src" / "repro_torch" / "csrc" / "paged_attention_prefill.cu"
OUT = ROOT / "build" / "ab_attention"
CONVERT_NEW = """  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __float_as_uint(
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | b)) -
          8388736.f);
    out[2 * i] = __byte_perm(f[0], f[1], 0x7632u);
    out[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632u);
  }"""
CONVERT_OLD = """  for (int i = 0; i < 8; ++i) {
    const int8_t* e = reinterpret_cast<const int8_t*>(w);
    out[i] = pack_bf16x2(static_cast<float>(e[2 * i]),
                         static_cast<float>(e[2 * i + 1]));
  }"""
# name: (substitutions, correct)
VARIANTS = {
    "base": ([], True),
    "stages2": ([("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
                True),
    "div": ([("      const int jb = div_bs(a, j);\n      int blk = -1;\n"
              "      if (j < kv_end) blk = __ldg(table + jb);",
              "      int blk = -1;\n"
              "      if (j < kv_end) blk = __ldg(table + j / a.bs);"),
             ("(j - jb * a.bs)", "j % a.bs")], True),
    "cvt": ([(CONVERT_NEW, CONVERT_OLD)], True),
    "late": ([("    issue(t + NSLOT - 1);\n    cp_async_commit();\n", ""),
              ("kTK * 128));\n    wgmma_commit();\n",
               "kTK * 128));\n    wgmma_commit();\n"
               "    issue(t + NSLOT - 1);\n    cp_async_commit();\n")],
             True),
    "nocopies": ([("    issue(t + NSLOT - 1);\n", "")], False),
    "noproducts": ([("      wgmma_n64(s, dq, dk, kk > 0);", ""),
                    ("      pv_step<HD>(o, pa[kk], mn_desc(vt + kk * 16 * 64, "
                     "kTK * 128));", "")], False),
    "nomask": ([("    const bool masked = !(j0 >= full_lo && j0 + kTK - 1 <= "
                 "full_hi);", "    const bool masked = false;")], False),
    "noconvert": ([("      if (t + 1 < tiles) convert(slot((t + 1) % NSLOT), "
                    "(t + 1) & 1);\n", "")], False),
    "hot": ([("const T* ksrc = karena + row * HD",
              "const T* ksrc = karena + (row & 7) * HD"),
             ("const T* vsrc = varena + row * HD",
              "const T* vsrc = varena + (row & 7) * HD")], False),
    "notiles": ([("  const int tiles = kv_end > kv_begin ? (kv_end - kv_begin + "
                  "kTK - 1) / kTK : 0;", "  const int tiles = 0;")],
                False),
}
ENTRY = ("paged_attention_prefill_bf16", "paged_attention_prefill_int8")


def resources(ptxas: str) -> list[str]:
    """Registers and spill bytes of each prefill instance, and ptxas's
    wgmma serialization notes, from ``-Xptxas -v`` output."""
    out, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"paged_prefill_kernelILi(\d+)ELi(\d+)E(\w+?)E", line)
        if m and "Compiling" in line:
            name = (f"hd{m.group(1)}/BM{m.group(2)}/"
                    f"{'int8' if m.group(3) == 'a' else 'bf16'}")
        if "Potential Performance Loss" in line:
            out.append(f"{name}: {line.strip()[:160]}")
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name and spill.group(1) != "0":
            out.append(f"{name}: {spill.group(1)} bytes spilled")
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append(f"{name} {regs.group(1)} regs")
            name = None
    return out


def build_variants(build, names):
    """One library per variant, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {SRC.name}")
            text = text.replace(old, new)
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
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="chunk512,chunk64,chunk64_window128",
                    help="phase 2b cases, comma-separated")
    ap.add_argument("--arenas", default="bf16,int8",
                    help="arena types, comma-separated (bf16, int8)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="variants to build and time, comma-separated")
    ap.add_argument("--bms", default="plan",
                    help="rows a block, comma-separated: 'plan' or 64, 128")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_attention_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import dataclasses

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.serving.cache_pool import quantize_kv
    from repro_torch.serving.paged import paged_attention as pa

    print(cs.nvidia_smi_line(), flush=True)
    names = args.variants.split(",")
    libs = build_variants(build, names)
    timer = cs.Timer(torch)
    g = torch.Generator().manual_seed(3)
    sms = cs.sm_count(torch)
    stream = torch.cuda.current_stream().cuda_stream
    shape = cs.ATTN_SHAPE
    totals = {}
    for case, cursors, S, window in cs.ATTN_CASES:
        if case not in args.cases.split(","):
            continue
        q, k, v, tables, cur = cs.attention_case(torch, g, cursors, S,
                                                 window, **shape)
        B, nb = tables.shape
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
            ref = pa.plain(q, kk, vv, tables, cur, window=window, **scales)
            tol = cs.KERNEL_TOL_REL * float(ref.float().abs().max())
            base = pa.plan(B, S, shape["H"], shape["KV"], shape["hd"],
                           shape["bs"], sms, decode_max_rows=0)
            line = f"{case:18s} {arena}"
            for bm in args.bms.split(","):
                p = base if bm == "plan" else dataclasses.replace(
                    base, rows=int(bm))
                for name in names:
                    fn = getattr(libs[name], f"paged_attention_prefill_{arena}")
                    name_p = name if bm == "plan" else f"{name}@{p.rows}"

                    def run():
                        status = fn(q.data_ptr(), *ptrs, tables.data_ptr(),
                                    cur.data_ptr(), out.data_ptr(), B, S,
                                    shape["H"], shape["KV"], shape["hd"],
                                    shape["bs"], nb, kk.shape[0],
                                    window or 0, p.rows, stream)
                        build.check(status, name)
                    run()
                    torch.cuda.synchronize()
                    err = float((out.float() - ref.float()).abs().max())
                    if VARIANTS[name][1] and not err <= tol:
                        raise SystemExit(f"{name} {case} {arena}: error "
                                         f"{err:.3e} > {tol:.3e}")
                    ms = timer.ms(run, 20)
                    totals[name_p] = totals.get(name_p, 0.0) + ms
                    line += f"  {name_p}@BM{p.rows} {ms * 1e3:.1f}"
            dec = pa.plan(B, S, shape["H"], shape["KV"], shape["hd"],
                          shape["bs"], sms, decode_max_rows=10**9)
            dec_us = timer.ms(lambda: pa.paged_attention(
                q, kk, vv, tables, cur, window=window, force_plan=dec,
                **scales), 20) * 1e3
            b_ms, b_by = cs.attention_bound(cursors, S, window, **shape,
                                            int8=arena == "int8")
            print(f"{line}  decode body {dec_us:.1f}  bound "
                  f"{b_ms * 1e3:.1f} ({b_by}) (us)", flush=True)
    print("total ms " + json.dumps(totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
