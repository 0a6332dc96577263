#!/usr/bin/env python3
"""Variants of the fused decode kernel timed side by side on one card.

    python3 scripts/fused_decode_ab.py [--ms 1,8,16]

Each variant is ``src/repro_torch/csrc/fused_sparse_linear.cu`` with a few
text substitutions, built with the port's nvcc flags into its own library
under ``build/ab/`` and called through its C entry points with the plan of
``kernels/fused_sparse_linear.plan``.  Every variant runs on the same
llama3-8b projection weights (8:16 + 16:256, bf16 and int8 values) and x,
case by case in turn, timed like ``chip_smoke.py`` (CUDA events, L2
flushed, mean of 20 calls); the tile kernel and the bound stand beside
them.  The diagnostic variants compute wrong results on purpose and are
marked so: they take out one part of the work to show what it costs.

  base      the source as it is
  nopad     no pad column in the staged x slice
  depth3    a ring of 3 steps of weight loads instead of 2
  rows2     2 output rows per warp instead of 4 (16 per block)
  loadonly  (diagnostic) the weight loads and index decoding, no gathers
            from x and no FMAs
  nogather  (diagnostic) the FMAs on x values made up from the index, no
            loads from shared memory

Prints one line per case and the total per variant; needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "fused_sparse_linear.cu"
OUT = ROOT / "build" / "ab"
FMA_NM = "fma_col<R>(acc[r], value_at<VT>(w, k, sc[r]), load_col<R>(xs, c));"
FMA_O = "fma_col<R>(acc[r], lo_bf16(raw[r].oval), load_col<R>(xs, c));"
# name: (substitutions, output rows per block, correct)
VARIANTS = {
    "base": ([], 32, True),
    "nopad": ([("return c + (c >> 4);", "return c;")], 32, True),
    "depth3": ([("constexpr int kDepth = 2;", "constexpr int kDepth = 3;")],
               32, True),
    "rows2": ([("constexpr int kRowsPerWarp = 4;",
                "constexpr int kRowsPerWarp = 2;")], 16, True),
    "loadonly": ([(FMA_NM, "acc[r][0] += __uint_as_float(c + w[k / 4]);"),
                  (FMA_O, "acc[r][0] += __uint_as_float(c + raw[r].oval);")],
                 32, False),
    "nogather": ([("const uint4 v = reinterpret_cast<const uint4*>(xs)[c];",
                   "const uint4 v = make_uint4(c, c + 1, c + 2, c + 3);"),
                  ("const uint2 v = reinterpret_cast<const uint2*>(xs)[c];",
                   "const uint2 v = make_uint2(c, c + 1);"),
                  ("out.w[0] = xs[c];", "out.w[0] = c * 65537u;")],
                 32, False),
}


def build_variants(build):
    """One library per variant, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    procs = {}
    for name, (subs, _, _) in VARIANTS.items():
        text = source
        for old, new in subs:
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
        for fn in ("fused_sparse_linear_decode_bf16",
                   "fused_sparse_linear_decode_int8"):
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ms", default="1,8,16",
                    help="rows of x, comma-separated")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fused_decode_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core import SparsifyConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels.common import scratch_for
    from repro_torch.models.sparse_serving import to_sparse_weight

    print(cs.nvidia_smi_line(), flush=True)
    libs = build_variants(build)
    timer = cs.Timer(torch)
    scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                          scorer="magnitude", use_smoothquant=False)
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = cs.sm_count(torch)
    stream = torch.cuda.current_stream().cuda_stream
    totals = dict.fromkeys(VARIANTS, 0.0)
    for proj, N, K in cs.PROJECTIONS:
        w = (torch.randn((N, K), generator=g, device="cuda")
             / math.sqrt(K)).to(torch.bfloat16)
        for values in ("bf16", "int8"):
            sw = to_sparse_weight(w, scfg, quantize=values == "int8")
            bufs = (sw.nm_values, sw.nm_meta, sw.o_values, sw.o_meta)
            kw = dict(n=sw.n, m=sw.m, o_n=sw.o_n, scale=sw.v_scale)
            ptrs = [t.data_ptr() for t in bufs]
            if sw.v_scale is not None:
                ptrs.append(sw.v_scale.data_ptr())
            for M in map(int, args.ms.split(",")):
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
                y_plain = fsl.plain(x, *bufs, **kw)
                tol = cs.KERNEL_TOL_REL * float(y_plain.float().abs().max())
                line = f"{proj:12s} {values} M={M:3d}"
                for name, lib in libs.items():
                    _, rows, correct = VARIANTS[name]
                    p = fsl.plan(M, K, N, 8, 16, 16, sms, decode_max_m=M)
                    if rows != fsl.BLOCK_ROWS:     # one counter per block
                        p = dataclasses.replace(
                            p, counters=-(-N // rows) * -(-M // p.rows))
                    ws, cnt = scratch_for(x.device, p)
                    fn = getattr(lib, "fused_sparse_linear_decode_"
                                 + values)

                    def run():
                        status = fn(x.data_ptr(), *ptrs, y.data_ptr(),
                                    ws.data_ptr(), cnt.data_ptr(), M, K, N,
                                    8, 16, 16, p.rows, p.splits,
                                    p.k_per_split, stream)
                        build.check(status, name)
                    run()
                    torch.cuda.synchronize()
                    err = float((y.float() - y_plain.float()).abs().max())
                    if correct and not err <= tol:
                        raise SystemExit(f"{name} {proj} {values} M={M}: "
                                         f"error {err:.3e} > {tol:.3e}")
                    ms = timer.ms(run, 20)
                    totals[name] += ms
                    line += f"  {name} {ms * 1e3:.1f}"
                tile = fsl.tile_plan(M, K, N)
                tile_ms = timer.ms(lambda: fsl.fused_sparse_linear(
                    x, *bufs, force_plan=tile, **kw), 20)
                b_ms, _ = cs.bound(M, N, K, 8, 16, 16, sw)
                print(f"{line}  tile {tile_ms * 1e3:.1f}  bound "
                      f"{b_ms * 1e3:.1f} (us)", flush=True)
    print("total ms " + json.dumps(totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
