#!/usr/bin/env python3
"""Variants of the fused prefill kernel timed side by side on one card.

    python3 scripts/fused_prefill_ab.py [--ms 37,512] [--values bf16,int8]
                                        [--kernel fused|nm]

Each variant is ``src/repro_torch/csrc/fused_sparse_linear_prefill.cu``
with a few text substitutions, built with the port's nvcc flags into its
own library under ``build/ab_prefill/`` and called through its C entry
points with the plan of ``kernels/fused_sparse_linear.plan`` (prefill path).
``--kernel nm`` calls the same variants' no-outlier instance, ``nm_spmm``'s
prefill kernel, on 8:16 weights without outliers (the outlier variants then
change nothing).  Every variant runs on the same llama3-8b projection
weights (8:16 + 16:256, or 8:16) and x, case by case in turn, timed like ``chip_smoke.py`` (CUDA events, L2
flushed, mean of 20 calls); the bound stands beside them.  The diagnostic
variants compute wrong results on purpose and are marked so: each takes
out one part of the work to show what it costs.

  base        the source as it is
  stages2     a ring of 2 slots instead of 3
  nomma       (diagnostic) no tensor-core products
  nodecomp    (diagnostic) no decompression after the first stage: the
              copies, products and barriers alone
  noselect    (diagnostic) the kept values written to fixed slots, no
              compare-select
  nooutliers  (diagnostic) no outlier pass
  noloop      (diagnostic) the outlier run found but not added
  nodecomp_nox, nodecomp_now  (diagnostic) nodecomp without the copies of
              x, or of the weight stream

Prints one line per case and the total per variant; needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "fused_sparse_linear_prefill.cu"
OUT = ROOT / "build" / "ab_prefill"
SELECT = ("w[p] = ((word >> (4 * k)) & 0xFu) == uint32_t(p) ? v[k] : w[p];")
NODECOMP = ("    if (t + 1 < steps) decompress(t % kStages, t + 1, (t + 1) & 1);",
            "")
# name: (substitutions, correct)
VARIANTS = {
    "base": ([], True),
    "stages2": ([("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
                True),
    "nomma": ([("    multiply(x_tile(t % kStages), bt + (t & 1) * (BN * kBK));",
                "")], False),
    "nodecomp": ([NODECOMP], False),
    "noselect": ([(SELECT, "w[p] = v[p & 7];")], False),
    "nooutliers": ([("for (int i = c; i < e; ++i)", "for (int i = c; i < c; "
                     "++i)")], False),
    "noloop": ([("          for (int i = c; i < e; ++i)\n"
                 "            add_at(w, om[i] & 15, bf16_bits_to_float(ov[i]));",
                 "          w[0] += float(e - c);")], False),
    "nodecomp_nox": ([NODECOMP, ("    if (tx < steps) {",
                                  "    if (false) {")], False),
    "nodecomp_now": ([NODECOMP, ("      if (tw < steps) {",
                                  "      if (false) {")], False),
}
ENTRY = ("fused_sparse_linear_prefill_bf16", "fused_sparse_linear_prefill_int8",
         "nm_spmm_prefill_bf16", "nm_spmm_prefill_int8")


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
             "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{output}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn in ENTRY:
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def forced_plan(fsl, M, K, N, o_n, sms, bm):
    """The plan's prefill choice, or BM = ``bm`` with BN = 128 and the
    plan's split rule."""
    from repro_torch.kernels.common import prefill_splits
    p = fsl.plan(M, K, N, 8, 16, o_n, sms, decode_max_m=0)
    if bm == "plan":
        return p
    bm, groups = int(bm), -(-K // 256)
    tiles = -(-M // bm) * -(-N // 128)
    S = prefill_splits(tiles, groups,
                       fsl.prefill_blocks_per_sm(bm, o_n) * sms)
    return fsl.Plan("prefill", bm, S, -(-groups // S) * 256,
                    S * M * N * 4 if S > 1 else 0, tiles * S,
                    tiles if S > 1 else 0, 128)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ms", default="37,512",
                    help="rows of x, comma-separated")
    ap.add_argument("--values", default="bf16",
                    help="N:M value types, comma-separated (bf16, int8)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="variants to build and time, comma-separated")
    ap.add_argument("--bms", default="plan",
                    help="x rows per block, comma-separated: 'plan' (the "
                         "plan's choice) or 64, 128, 256 (BN 128, the "
                         "plan's split rule)")
    ap.add_argument("--kernel", default="fused", choices=("fused", "nm"),
                    help="the fused kernel (8:16 + 16:256) or nm_spmm's "
                         "no-outlier instance (8:16)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fused_prefill_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core import SparsifyConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.kernels.common import scratch_for
    from repro_torch.models.sparse_serving import to_sparse_weight

    print(cs.nvidia_smi_line(), flush=True)
    fused = args.kernel == "fused"
    o_n = 16 if fused else 0
    plain = fsl.plain if fused else nms.plain
    entry = "fused_sparse_linear_prefill_" if fused else "nm_spmm_prefill_"
    names = args.variants.split(",")
    libs = build_variants(build, names)
    timer = cs.Timer(torch)
    scfg = SparsifyConfig(weight_pattern="8:16",
                          outlier_pattern="16:256" if fused else None,
                          scorer="magnitude", use_smoothquant=False)
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = cs.sm_count(torch)
    stream = torch.cuda.current_stream().cuda_stream
    totals = {}
    for proj, N, K in cs.PROJECTIONS:
        w = (torch.randn((N, K), generator=g, device="cuda")
             / math.sqrt(K)).to(torch.bfloat16)
        for values in args.values.split(","):
            sw = to_sparse_weight(w, scfg, quantize=values == "int8")
            bufs = (sw.nm_values, sw.nm_meta) + (
                (sw.o_values, sw.o_meta) if fused else ())
            kw = dict(n=sw.n, m=sw.m, scale=sw.v_scale,
                      **(dict(o_n=sw.o_n) if fused else {}))
            ptrs = [t.data_ptr() for t in bufs]
            if sw.v_scale is not None:
                ptrs.append(sw.v_scale.data_ptr())
            for M in map(int, args.ms.split(",")):
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
                y_plain = plain(x, *bufs, **kw)
                tol = cs.KERNEL_TOL_REL * float(y_plain.float().abs().max())
                plans = [forced_plan(fsl, M, K, N, o_n, sms, bm)
                         for bm in args.bms.split(",")]
                line = f"{proj:12s} {values} M={M:4d}"
                for name, p in ((n, p) for p in plans for n in names):
                    ws, cnt = scratch_for(x.device, p)
                    if len(plans) > 1:
                        name_p = f"{name}@{p.rows}x{p.cols}/{p.splits}"
                    else:
                        name_p = name
                        line += f" {p.rows}x{p.cols} S={p.splits}" * (
                            name == names[0])
                    fn = getattr(libs[name], entry + values)

                    def run():
                        status = fn(x.data_ptr(), *ptrs, y.data_ptr(),
                                    ws.data_ptr(), cnt.data_ptr(), M, K, N,
                                    8, 16, *((o_n,) if fused else ()),
                                    p.rows, p.cols, p.splits, p.k_per_split,
                                    stream)
                        build.check(status, name)
                    run()
                    torch.cuda.synchronize()
                    err = float((y.float() - y_plain.float()).abs().max())
                    if VARIANTS[name][1] and not err <= tol:
                        raise SystemExit(f"{name} {proj} {values} M={M}: "
                                         f"error {err:.3e} > {tol:.3e}")
                    ms = timer.ms(run, 20)
                    totals[name_p] = totals.get(name_p, 0.0) + ms
                    line += f"  {name_p} {ms * 1e3:.1f}"
                b_ms, _ = cs.bound(M, N, K, 8, 16, o_n, sw)
                print(f"{line}  bound {b_ms * 1e3:.1f} (us)", flush=True)
            del sw, bufs
        del w
    print("total ms " + json.dumps(totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
