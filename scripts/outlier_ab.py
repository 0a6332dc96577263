#!/usr/bin/env python3
"""Variants of outlier_spmm's two bodies timed side by side on one card.

    python3 scripts/outlier_ab.py [--body prefill|decode] [--ms 37,512]
                                  [--ns 16,8,4] [--rows plan,64,128]

Each variant is ``src/repro_torch/csrc/outlier_spmm.cu`` with a few text
substitutions, built with the port's nvcc flags into its own library under
``build/ab_outlier/`` (its registers and spills printed) and called through
its C entry point (``outlier_spmm_prefill_bf16`` or
``outlier_spmm_decode_bf16``) with the plan of ``kernels/outlier_spmm.plan``
for that body, or with the rows of x a tile forced by ``--rows`` and the
plan's grid rule.  Every variant runs on the same random N:256 outliers at
llama3-8b's four projection shapes and the same x, case by case in turn,
timed like ``chip_smoke.py`` (CUDA events, L2 flushed, mean of 20 calls);
the bound and the gather ceiling stand beside them.  The diagnostic
variants compute wrong results on purpose and are marked so: each takes out
one part of the work to show what it costs.

Prefill body (default; ``--ms 37,512``):

  base      the source as it is (a unit's loads before its quarter of the
            products at RL = 2, after it at RL = 4)
  early     (correct) loads before the quarter at RL = 4 too (spills)
  late      (correct) loads after the quarter at RL = 2 too
  serial    (correct) the whole next stage copied after this stage's
            products
  async     (correct) x copied by cp.async into a [column pair][rows]
            tile, no registers: the copies overlap the whole stage; each
            outlier costs one more instruction (its column's half picked
            by a byte permutation, the value masked)
  nox       (diagnostic) no x copies after the first stage
  nolists   (diagnostic) no list copies after the first stage: every stage
            reads the first stage's lists
  nocopies  (diagnostic) neither: the products and barriers alone
  nogather  (diagnostic) no loads of x in the products: each outlier's
            address stands in for x

Decode body (``--body decode --ms 1,4,8``):

  base      the source as it is
  nostage   (diagnostic) no x slice staged
  noloads   (diagnostic) no index words or values loaded
  nogather  (diagnostic) no loads of x in the products
  noshfl    (diagnostic) a lane's sums added in place of the warp's
            reduce-scatter

Together they say what sets each body's pace.
Prints one line per case and the total per variant; needs one card.
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
SRC = ROOT / "src" / "repro_torch" / "csrc" / "outlier_spmm.cu"
OUT = ROOT / "build" / "ab_outlier"
QUARTERS = """    quarter(p0);
    quarter(p1);
    quarter(p2);
    quarter(p3);
"""
SERIAL = """    compute(cur, p0);
    compute(cur, p1);
    compute(cur, p2);
    compute(cur, p3);
    if (next) {
      load(g, p0);
      store(cur ^ 1, p0);
      load(g, p1);
      store(cur ^ 1, p1);
      load(g, p2);
      store(cur ^ 1, p2);
      load(g, p3);
      store(cur ^ 1, p3);
    }
"""


def _copies(load, store):
    """The stage loop's copies (not the first stage's) replaced."""
    return [("      if (kEarly && next) load(g, part);",
             f"      if (kEarly && next) {load};"),
            ("        if (!kEarly) load(g, part);",
             f"        if (!kEarly) {load};"),
            ("        store(cur ^ 1, part);", f"        {store};")]


EARLY = "  constexpr bool kEarly = RL == 2;"
FIRST_LISTS = ("const uint32_t* ls = ls_of(slot)", "const uint32_t* ls = ls_of(0)")
# "async": x copied by cp.async, 4 bytes (two columns of one row) a copy,
# into [column pair][BM + RL rows] words, so a lane reads its RL rows of a
# column pair with one load and picks the column's half with a byte
# permutation; the selector rides in the low 16 bits of the list entry's
# value word (masked off for the multiply-add), the offset is the pair's
ASYNC = [
    ("  static constexpr int kPitch = kBM / 2 + 2;\n"
     "  static constexpr int kXWords = kGroup * kPitch;",
     "  static constexpr int kPitch = kBM + RL;\n"
     "  static constexpr int kXWords = kGroup / 2 * kPitch;"),
    ("""template <int RL>
__device__ __forceinline__ void fma_rows(float (&acc)[RL], float v,
                                         const char* col) {
  if constexpr (RL == 2) {
    const uint32_t xv = *reinterpret_cast<const uint32_t*>(col);
    acc[0] = fmaf(v, lo_bf16(xv), acc[0]);
    acc[1] = fmaf(v, hi_bf16(xv), acc[1]);
  } else {
    static_assert(RL == 4, "RL is 2 or 4");
    const uint2 xv = *reinterpret_cast<const uint2*>(col);
    acc[0] = fmaf(v, lo_bf16(xv.x), acc[0]);
    acc[1] = fmaf(v, hi_bf16(xv.x), acc[1]);
    acc[2] = fmaf(v, lo_bf16(xv.y), acc[2]);
    acc[3] = fmaf(v, hi_bf16(xv.y), acc[3]);
  }
}""", """template <int RL>
__device__ __forceinline__ void fma_rows(float (&acc)[RL], uint32_t e,
                                         const char* col) {
  const float v = __uint_as_float(e & 0xffff0000u);
  if constexpr (RL == 2) {
    const uint2 xv = *reinterpret_cast<const uint2*>(col);
    acc[0] = fmaf(v, __uint_as_float(__byte_perm(xv.x, 0u, e)), acc[0]);
    acc[1] = fmaf(v, __uint_as_float(__byte_perm(xv.y, 0u, e)), acc[1]);
  } else {
    const uint4 xv = *reinterpret_cast<const uint4*>(col);
    acc[0] = fmaf(v, __uint_as_float(__byte_perm(xv.x, 0u, e)), acc[0]);
    acc[1] = fmaf(v, __uint_as_float(__byte_perm(xv.y, 0u, e)), acc[1]);
    acc[2] = fmaf(v, __uint_as_float(__byte_perm(xv.z, 0u, e)), acc[2]);
    acc[3] = fmaf(v, __uint_as_float(__byte_perm(xv.w, 0u, e)), acc[3]);
  }
}"""),
    ("        fma_rows<RL>(acc[r], __uint_as_float(e.x), xl + e.y);\n"
     "        fma_rows<RL>(acc[r], __uint_as_float(e.z), xl + e.w);",
     "        fma_rows<RL>(acc[r], e.x, xl + e.y);\n"
     "        fma_rows<RL>(acc[r], e.z, xl + e.w);"),
    ("reinterpret_cast<const char*>(xs_of(slot) + lane * (RL / 2));",
     "reinterpret_cast<const char*>(xs_of(slot) + lane * RL);"),
    ("""        constexpr uint32_t kCol = P::kPitch * 4;  // bytes an x column
        *reinterpret_cast<uint4*>(e) =
            make_uint4(lv.x << 16, index_at(lm, 0) * kCol,
                       lv.x & 0xffff0000u, index_at(lm, 1) * kCol);
        *reinterpret_cast<uint4*>(e + 4) =
            make_uint4(lv.y << 16, index_at(lm, 2) * kCol,
                       lv.y & 0xffff0000u, index_at(lm, 3) * kCol);""",
     """        constexpr uint32_t kCol = P::kPitch * 4;  // bytes a column pair
        auto ent = [&](uint32_t v, int q) {
          const uint32_t c = index_at(lm, q);
          return make_uint2(v | (0x1044u + (c & 1u) * 0x2200u),
                            (c >> 1) * kCol);
        };
        const uint2 e0 = ent(lv.x << 16, 0), e1 = ent(lv.x & 0xffff0000u, 1);
        const uint2 e2 = ent(lv.y << 16, 2), e3 = ent(lv.y & 0xffff0000u, 3);
        *reinterpret_cast<uint4*>(e) = make_uint4(e0.x, e0.y, e1.x, e1.y);
        *reinterpret_cast<uint4*>(e + 4) = make_uint4(e2.x, e2.y, e3.x, e3.y);"""),
    ("""  uint4 xa, xb;
  auto load_x = [&](int g, auto part) {
    int i, c;
    unit(decltype(part)::value, i, c);
    const int ma = m0 + 2 * i, mb = ma + 1;
    const size_t col = size_t(g) * kGroup + 8 * c;
    xa = make_uint4(0u, 0u, 0u, 0u);
    xb = xa;
    if (ma < M)
      xa = __ldg(reinterpret_cast<const uint4*>(x + size_t(ma) * K + col));
    if (mb < M)
      xb = __ldg(reinterpret_cast<const uint4*>(x + size_t(mb) * K + col));
  };
  auto store_x = [&](int slot, auto part) {
    uint32_t* xs = xs_of(slot);
    int i, c;
    unit(decltype(part)::value, i, c);
    const uint32_t av[4] = {xa.x, xa.y, xa.z, xa.w};
    const uint32_t bv[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xs[(8 * c + 2 * j) * P::kPitch + i] = __byte_perm(av[j], bv[j], 0x5410);
      xs[(8 * c + 2 * j + 1) * P::kPitch + i] =
          __byte_perm(av[j], bv[j], 0x7632);
    }
  };""", """  int xg = 0;
  auto load_x = [&](int g, auto part) { xg = g; };
  // a quarter of the group's 128 * BM four-byte copies: a warp's copy
  // covers RL rows by 32 / RL column pairs (bank = lane), a thread's
  // eight copies of a quarter one row of x
  auto store_x = [&](int slot, auto part) {
    constexpr int k = decltype(part)::value;
    const int mb = warp * (8 / RL) + (8 * k) / (4 * RL);
    const int m = mb * RL + lane % RL;
    const bool in = m0 + m < M;
    const bf16* row = x + size_t(in ? m0 + m : 0) * K + size_t(xg) * kGroup +
                      2 * (lane / RL);
    const uint32_t xs =
        static_cast<uint32_t>(__cvta_generic_to_shared(xs_of(slot))) +
        4u * uint32_t((lane / RL) * P::kPitch + m);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int jb = (8 * k + i) % (4 * RL);  // 32 / RL column pairs each
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(
                       xs + 4u * uint32_t(jb * (32 / RL) * P::kPitch)),
                   "l"(row + 2 * jb * (32 / RL)), "r"(in ? 4 : 0)
                   : "memory");
    }
  };"""),
    ("    __syncthreads();\n    quarter(p0);",
     "    asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
     "    __syncthreads();\n    quarter(p0);"),
]
# name: (substitutions, correct)
VARIANTS = {
    "base": ([], True),
    "early": ([(EARLY, "  constexpr bool kEarly = true;")], True),
    "late": ([(EARLY, "  constexpr bool kEarly = false;")], True),
    "serial": ([(QUARTERS, SERIAL)], True),
    "async": (ASYNC, True),
    "nox": (_copies("load_lists(g, part)", "store_lists(cur ^ 1, part)"),
            False),
    "nolists": (_copies("load_x(g, part)", "store_x(cur ^ 1, part)")
                + [FIRST_LISTS], False),
    "nocopies": (_copies("(void)0", "(void)0") + [FIRST_LISTS], False),
    "nogather": ([("    const uint32_t xv = *reinterpret_cast<const uint32_t*>(col);",
                   "    const uint32_t xv = uint32_t(uintptr_t(col));"),
                  ("    const uint2 xv = *reinterpret_cast<const uint2*>(col);",
                   "    const uint2 xv = make_uint2(uint32_t(uintptr_t(col)), "
                   "0u);")], False),
}

# the decode body's variants (--body decode)
DECODE_VARIANTS = {
    "base": ([], True),
    "nostage": ([("  for (int t = threadIdx.x; t < (cols / 8) * (R / 2); "
                  "t += kThreads) {",
                  "  for (int t = threadIdx.x; t < 0; t += kThreads) {")],
                False),
    "noloads": ([("          word[r] = __ldg(meta + at);",
                  "          word[r] = uint32_t(at);"),
                 ("          v[r] = __ldg(vals + at);",
                  "          v[r] = make_uint2(uint32_t(at), 0u);")], False),
    "nogather": ([("    out.w[0] = xs[c];", "    out.w[0] = c;"),
                  ("    const uint2 v = reinterpret_cast<const uint2*>(xs)[c];",
                   "    const uint2 v = make_uint2(c, c);"),
                  ("    const uint4 v = reinterpret_cast<const uint4*>(xs)[c];",
                   "    const uint4 v = make_uint4(c, c, c, c);")], False),
    "noshfl": ([("    const float sum = reduce_scatter<kWarpRows * R>(acc, "
                 "lane);",
                 "    float sum = 0.f;\n#pragma unroll\n"
                 "    for (int i = 0; i < kWarpRows * R; ++i) sum += acc[i];")],
               False),
}


def build_variants(build, names, variants, entry):
    """One library per variant, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    procs = {}
    for name in names:
        text = source
        for old, new in variants[name][0]:
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
        getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def resources(ptxas: str) -> list[str]:
    """'body RL,n (or R): registers/spilled bytes' of each instance of the
    two bodies in ptxas -v output."""
    out, inst = [], None
    for line in ptxas.splitlines():
        m = re.search(r"outlier_(prefill|decode)_kernelILi(\d)E(?:Li(\d+)E)?",
                      line)
        if "Compiling entry" in line:
            inst = (f"{m.group(1)} " + ",".join(x for x in m.groups()[1:] if x)
                    if m else None)
        elif inst and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif inst and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{inst}: {regs}/{spill}")
            inst = None
    return out


def forced_plan(osp, common, M, K, N, n, sms, rows, body):
    """The plan's choice for ``body``, or ``rows`` x rows a tile with the
    plan's grid rule."""
    if body == "decode":
        if rows == "plan":
            return osp.plan(M, K, N, n, sms, decode_max_m=M)
        return osp.decode_plan(M, K, N, int(rows), sms)
    p = osp.plan(M, K, N, n, sms, decode_max_m=0)
    if rows == "plan":
        return p
    bm, groups = int(rows), K // 256
    tiles = -(-M // bm) * -(-N // osp.prefill_cols(bm))
    S = common.prefill_splits(tiles, groups,
                              osp.prefill_blocks_per_sm(bm, n) * sms)
    return osp.Plan("prefill", bm, osp.prefill_cols(bm), S,
                    -(-groups // S) * 256,
                    S * M * N * 4 if S > 1 else 0, tiles * S,
                    tiles if S > 1 else 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ms", default="37,512",
                    help="rows of x, comma-separated")
    ap.add_argument("--ns", default="16,8,4",
                    help="outliers per 256 columns, comma-separated")
    ap.add_argument("--body", default="prefill", choices=("prefill", "decode"))
    ap.add_argument("--variants", default=None,
                    help="variants to build and time, comma-separated "
                         "(default: all of the body's)")
    ap.add_argument("--rows", default="plan",
                    help="x rows per tile, comma-separated: 'plan' or "
                         "64, 128 (prefill), 2, 4, 8 (decode)")
    args = ap.parse_args()
    variants = VARIANTS if args.body == "prefill" else DECODE_VARIANTS
    entry = f"outlier_spmm_{args.body}_bf16"
    import torch
    if not torch.cuda.is_available():
        print("outlier_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build, common
    from repro_torch.kernels import outlier_spmm as osp

    print(cs.nvidia_smi_line(), flush=True)
    names = (args.variants or ",".join(variants)).split(",")
    libs = build_variants(build, names, variants, entry)
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = cs.sm_count(torch)
    stream = torch.cuda.current_stream().cuda_stream
    totals = {}
    for proj, N, K in cs.PROJECTIONS:
        for n in map(int, args.ns.split(",")):
            vals, meta = cs.random_outliers(torch, N, K, n, g)
            for M in map(int, args.ms.split(",")):
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
                y_plain = osp.plain(x, vals, meta, n=n)
                tol = cs.KERNEL_TOL_REL * float(y_plain.float().abs().max())
                plans = [forced_plan(osp, common, M, K, N, n, sms, rows,
                                     args.body)
                         for rows in args.rows.split(",")]
                line = f"{proj:12s} {n:2d}:256 M={M:4d}"
                for name, p in ((v, p) for p in plans for v in names):
                    ws, cnt = common.scratch_for(x.device, p)
                    name_p = (f"{name}@{p.rows}/{p.splits}" if len(plans) > 1
                              else name)
                    if len(plans) == 1 and name == names[0]:
                        line += f" {p.rows}x{p.cols} S={p.splits}"
                    fn = getattr(libs[name], entry)

                    def run():
                        build.check(fn(x.data_ptr(), vals.data_ptr(),
                                       meta.data_ptr(), y.data_ptr(),
                                       ws.data_ptr(), cnt.data_ptr(), M, K,
                                       N, n, p.rows, p.cols, p.splits,
                                       p.k_per_split, stream), name)
                    run()
                    torch.cuda.synchronize()
                    err = float((y.float() - y_plain.float()).abs().max())
                    if variants[name][1] and not err <= tol:
                        raise SystemExit(f"{name} {proj} n={n} M={M}: error "
                                         f"{err:.3e} > {tol:.3e}")
                    ms = timer.ms(run, 20)
                    totals[name_p] = totals.get(name_p, 0.0) + ms
                    line += f"  {name_p} {ms * 1e3:.1f}"
                b_ms, _ = cs.outlier_bound(M, N, K, n)
                ceil_ms = cs.outlier_gather_ceiling(M, N, K, n)
                print(f"{line}  bound {b_ms * 1e3:.1f}  gather "
                      f"{ceil_ms * 1e3:.1f} (us)", flush=True)
            del vals, meta
    print("total ms " + json.dumps(totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
