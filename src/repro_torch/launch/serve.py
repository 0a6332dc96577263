"""Serving driver: a thin CLI over the port's continuous-batching engine
(port of ``repro/launch/serve.py``'s ``build_params`` and ``run_engine``).

With ``--sparse`` every projection is deployed as an 8:16 (+16:256
outlier) ``SparseWeight`` as soon as its layer is drawn, so a full-size
model never holds all its dense weights at once; on the card each sparse
product runs through the hand-written kernels.

  python -m repro_torch.launch.serve --arch llama3-8b --sparse
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --batch 2 --prompt-len 16 --gen 4 --sparse
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
from ..serving import SamplingParams, ServingEngine


def build_params(cfg, args, device, generator: torch.Generator):
    """Draw the model from ``generator`` one layer at a time, deploying
    compressed weights with ``--sparse``.  Returns (params, report)."""
    report = {"n_layers_sparsified": 0, "dense_bytes": 0,
              "compressed_bytes": 0}
    layer_fn = None
    if args.sparse:
        outlier = None if args.outlier_pattern == "none" \
            else args.outlier_pattern
        scfg = SparsifyConfig(weight_pattern=args.weight_pattern,
                              outlier_pattern=outlier)

        def layer_fn(lp):
            lp, rep = sparsify_for_serving(lp, scfg)
            for key in report:
                report[key] += rep[key]
            return lp
    params = tfm.init_params(cfg, generator, device, layer_fn=layer_fn)
    report["ratio"] = report["compressed_bytes"] / max(report["dense_bytes"], 1)
    return params, report


def run_engine(cfg, params, args, device, generator: torch.Generator):
    """Serve ``--batch`` random prompts drawn from ``generator``; returns
    the finished requests and the engine."""
    engine = ServingEngine(cfg, params, device=device, n_slots=args.slots,
                           max_len=args.prompt_len + args.gen,
                           token_budget=args.token_budget)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=generator, device=generator.device)
    sp = SamplingParams(max_new_tokens=args.gen, temperature=args.temperature,
                        top_k=args.top_k, seed=args.seed)
    t0 = time.perf_counter()
    reqs = [engine.submit(p.tolist(), sp) for p in prompts]
    engine.run()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in reqs)
    print(f"engine[slot]: {args.batch} requests, {n_tok} tokens in "
          f"{wall:.2f}s ({n_tok / max(wall, 1e-9):.1f} tok/s, "
          f"{engine.stats()['n_steps']} steps, {args.slots} slots, "
          f"{device})")
    return reqs, engine


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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
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
    reqs, _ = run_engine(cfg, params, args, device, generator)
    print("sample:", reqs[0].tokens[:12])
    return reqs


if __name__ == "__main__":
    main()
