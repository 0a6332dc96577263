"""Serving driver: a thin CLI over the port's continuous-batching engine
(port of ``repro/launch/serve.py``'s ``build_params``, ``run_engine``,
``run_trace`` and the observability outputs).

With ``--sparse`` every projection is deployed as an 8:16 (+16:256
outlier) ``SparseWeight`` as soon as its layer is drawn, so a full-size
model never holds all its dense weights at once; on the card each sparse
product runs through the hand-written kernels.  ``--kv-dtype int8`` stores
the KV arenas as int8 with per-position scales, on either layout.

  python -m repro_torch.launch.serve --arch llama3-8b --sparse
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --batch 2 --prompt-len 16 --gen 4 --sparse
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --sparse --kv-layout paged --block-size 8
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --sparse --kv-layout paged --block-size 8 --kv-dtype int8

``--trace t.json`` replays a JSON request trace (``serving/trace.py``,
written by either package's ``save_trace``) open-loop through the engine,
arrival gaps scaled by ``--time-scale``, and prints ``format_summary``'s
line and the requests admission control rejected.  ``--trace-out
out.json`` turns the tracer on (``serving/observe.py``): a Chrome/Perfetto
``trace_event`` JSON of every request lifecycle, engine step, model call
and preemption (load it in ui.perfetto.dev), and a Prometheus counter
snapshot in ``out.json.counters.txt``:

  python -c "from repro_torch.serving import *; save_trace('t.json', \\
      poisson_trace(n_requests=6, rate_per_s=4, vocab=512, \\
      prompt_len=(8, 16), max_new_tokens=6))"
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --sparse --kv-layout paged --trace t.json --max-len 32 \\
      --trace-out out.json
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get, get_smoke
from ..core import SparsifyConfig
from ..device import resolve
from ..models import transformer as tfm
from ..models.sparse_serving import sparsify_for_serving
from ..runtime.metrics import format_summary, summarize
from ..serving import (SamplingParams, ServingEngine, ServingTracer,
                       load_trace, replay)


def build_params(cfg, args, device, generator: torch.Generator, *,
                 quantize: bool = False):
    """Draw the model from ``generator`` one layer at a time, deploying
    compressed weights with ``--sparse`` (int8 N:M values with exact
    outliers when ``quantize``).  Returns (params, report)."""
    report = {"n_layers_sparsified": 0, "dense_bytes": 0,
              "compressed_bytes": 0}
    layer_fn = None
    if args.sparse:
        outlier = None if args.outlier_pattern == "none" \
            else args.outlier_pattern
        # random weights have no calibration statistics: magnitude scores
        # without SmoothQuant, as the JAX package's serve passes them
        scfg = SparsifyConfig(weight_pattern=args.weight_pattern,
                              outlier_pattern=outlier, scorer="magnitude",
                              use_smoothquant=False)

        def layer_fn(lp):
            lp, rep = sparsify_for_serving(lp, scfg, quantize=quantize)
            for key in report:
                report[key] += rep[key]
            return lp
    params = tfm.init_params(cfg, generator, device, layer_fn=layer_fn)
    report["ratio"] = report["compressed_bytes"] / max(report["dense_bytes"], 1)
    return params, report


def _make_tracer(args):
    """A ServingTracer when --trace-out was given, else None (the engine
    then runs with NULL_TRACER: no observability work per step)."""
    return ServingTracer() if args.trace_out else None


def _build_engine(cfg, params, args, device, *, max_len: int):
    """The engine of ``args`` and its tracer (None without --trace-out)."""
    tracer = _make_tracer(args)
    engine = ServingEngine(cfg, params, device=device, n_slots=args.slots,
                           max_len=max_len, max_queue=args.max_queue,
                           token_budget=args.token_budget,
                           kv_layout=args.kv_layout,
                           block_size=args.block_size,
                           n_blocks=args.n_blocks,
                           prefix_caching=not args.no_prefix_cache,
                           kv_dtype=args.kv_dtype, tracer=tracer)
    return engine, tracer


def _write_observability(tracer, args) -> None:
    """Write the Perfetto trace and the Prometheus counter snapshot next
    to it (<trace-out> and <trace-out>.counters.txt)."""
    if tracer is None:
        return
    tracer.write_trace(args.trace_out)
    counters = args.trace_out + ".counters.txt"
    with open(counters, "w") as f:
        f.write(tracer.counters_text())
    print(f"trace written to {args.trace_out} (load in ui.perfetto.dev); "
          f"counters in {counters}")


def run_engine(cfg, params, args, device, generator: torch.Generator):
    """Serve ``--batch`` random prompts drawn from ``generator``; returns
    the finished requests and the engine."""
    engine, tracer = _build_engine(cfg, params, args, device,
                                   max_len=args.prompt_len + args.gen)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=generator, device=generator.device)
    sp = SamplingParams(max_new_tokens=args.gen, temperature=args.temperature,
                        top_k=args.top_k, seed=args.seed)
    t0 = time.perf_counter()
    reqs = [engine.submit(p.tolist(), sp) for p in prompts]
    engine.run()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in reqs)
    st = engine.stats()
    print(f"engine[{args.kv_layout}]: {args.batch} requests, {n_tok} tokens "
          f"in {wall:.2f}s ({n_tok / max(wall, 1e-9):.1f} tok/s, "
          f"{st['n_steps']} steps, {args.slots} slots, "
          f"{st['n_preemptions']} preemptions, {device})")
    pool = st["pool"]
    print(f"kv arena: {pool['kv_dtype']}, {pool['arena_bytes']} bytes "
          f"({pool['scale_bytes']} of scales)")
    pc = pool.get("prefix_cache")
    if pc is not None:
        print(f"prefix cache: {pc['hits']}/{pc['lookups']} lookups hit, "
              f"{pc['hit_tokens']} hit tokens, {pc['entries']} entries, "
              f"{pc['evicted_blocks']} evicted blocks")
    _write_observability(tracer, args)
    return reqs, engine


def run_trace(cfg, params, args, device):
    """Replay the --trace file through the engine; returns replay's result
    dict with the engine and its tracer (None without --trace-out)."""
    engine, tracer = _build_engine(cfg, params, args, device,
                                   max_len=args.max_len)
    trace = load_trace(args.trace)
    res = replay(engine, trace, time_scale=args.time_scale)
    summary = summarize([r.metrics for r in res["finished"]], res["wall_s"])
    print(format_summary("trace", summary))
    if res["rejected"]:
        print(f"rejected by admission control: {res['rejected']}")
    _write_observability(tracer, args)
    return dict(res, summary=summary, engine=engine, tracer=tracer)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke-arch", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sparse", action="store_true",
                    help="deploy 8:16 + 16:256-outlier compressed weights")
    ap.add_argument("--weight-pattern", default="8:16")
    ap.add_argument("--outlier-pattern", default="16:256",
                    help="N:256 outlier pattern, or 'none' for plain N:M")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--token-budget", type=int, default=None)
    ap.add_argument("--kv-layout", default="slot", choices=("slot", "paged"),
                    help="contiguous per-slot KV vs paged block pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged layout)")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="paged arena size in blocks (default: the same "
                         "device memory as the slot layout would reserve)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prefix-cache block sharing (paged)")
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"),
                    help="KV arena storage: bf16, or int8 with per-position "
                         "f32 scales (either layout)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="JSON request trace to replay through the engine")
    ap.add_argument("--max-len", type=int, default=256,
                    help="per-slot KV capacity (trace mode)")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="compress (<1) / stretch (>1) trace arrival gaps")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run here (load in ui.perfetto.dev); a Prometheus "
                         "counter snapshot lands next to it")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve(args.device)
    cfg = get_smoke(args.arch) if args.smoke_arch else get(args.arch)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params, report = build_params(cfg, args, device, generator)
    if args.sparse:
        print(f"sparse deploy: {report['n_layers_sparsified']} matrices, "
              f"bytes {report['dense_bytes'] / 2**20:.1f}MiB -> "
              f"{report['compressed_bytes'] / 2**20:.1f}MiB "
              f"({report['ratio']:.3f}x)")
    if args.trace is not None:
        return run_trace(cfg, params, args, device)
    reqs, _ = run_engine(cfg, params, args, device, generator)
    print("sample:", reqs[0].tokens[:12])
    return reqs


if __name__ == "__main__":
    main()
