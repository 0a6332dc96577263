"""End-to-end driver (port of ``examples/sparsify_e2e.py``): train a dense
LM for a few hundred steps, sparsify it with the paper's full pipeline
(RIA+SQ+VC), recover with EBFT, and report the perplexity ladder at every
stage.

The default config is small (~8M params); pass --d-model 768 --layers 12
for a ~100M-param run (the same code path).

    PYTHONPATH=src python examples/torch/sparsify_e2e.py --steps 300
    PYTHONPATH=src python examples/torch/sparsify_e2e.py --device cpu \\
        --steps 20 --ebft-steps 2 --layers 1 --d-model 64

``run_ebft_row`` is the port of the reference's benchmark helper
(``benchmarks/ebft_bench.py``), carried here until the port has a
benchmark folder of its own.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.core import EBFTConfig, SparsifyConfig, ebft_block, \
    sparsify_tree
from repro_torch.core.ebft import make_block_masks
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve
from repro_torch.eval.harness import (collect_activation_stats, eval_ppl,
                                      sparsify_model, train_small_lm)
from repro_torch.models import transformer as tfm


def _block_fn(cfg):
    def fn(lp, x):
        pos = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[:2])
        return tfm.block_forward(lp, x, pos, cfg)[0]
    return fn


def run_ebft_row(cfg, params, data, weight_pattern="2:4",
                 outlier_pattern=None, steps: int = 40, **scfg_kw):
    """Sparsify, then EBFT every block against its dense teacher on the
    embeddings of 8 calibration sequences, each block's inputs carried
    through the tuned blocks before it.  Returns (ppl_after, wall_us)."""
    t0 = time.time()
    stats = collect_activation_stats(cfg, params, data.calibration(2))
    scfg = SparsifyConfig(weight_pattern=weight_pattern,
                          outlier_pattern=outlier_pattern, **scfg_kw)
    sparse_params, records = sparsify_tree(params, stats, scfg)

    calib = data.calibration(1)[0]
    device = params["embed"].device
    toks = torch.as_tensor(calib["tokens"][:8], device=device).long()
    x_sparse = sparse_params["embed"][toks]

    block_fn = _block_fn(cfg)
    ecfg = EBFTConfig(steps=steps, lr=2e-4, batch_size=4)
    tuned_layers = []
    for i, (lp_dense, lp_sparse) in enumerate(zip(params["layers"],
                                                  sparse_params["layers"])):
        kept = {name.split("/")[-1]: sl.nonsalient_kept_mask
                for name, sl in records.items()
                if name.startswith(f"layers/{i}/")}
        masks = make_block_masks(lp_sparse, kept)
        tuned, _losses = ebft_block(block_fn, lp_sparse, lp_dense, masks,
                                    x_sparse, ecfg)
        tuned_layers.append(tuned)
        with torch.no_grad():
            x_sparse = block_fn(tuned, x_sparse)

    tuned_params = dict(sparse_params, layers=tuned_layers)
    p = eval_ppl(cfg, tuned_params, data, n_batches=4)
    return p, (time.time() - t0) * 1e6


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--d-ff", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pattern", default="8:16")
    ap.add_argument("--outliers", default="16:256")
    ap.add_argument("--ebft-steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def model_config(args):
    """The reference's e2e model: its llama-paper smoke twin resized."""
    return dataclasses.replace(
        configs.get_smoke("llama-paper"), name="e2e",
        n_layers=args.layers, d_model=args.d_model, d_ff=args.d_ff,
        vocab=args.vocab,
        n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(4, args.d_model // 64),
        head_dim=64 if args.d_model >= 256 else args.d_model // 4,
        remat=False)


def run(args, params=None) -> dict:
    """The ladder of ``args``; ``params`` start the dense training in
    place of a seeded init (a parity test's JAX init)."""
    device = resolve(args.device)
    cfg = model_config(args)
    n_params = cfg.param_count()
    print(f"== 1. train dense LM ({n_params/1e6:.1f}M params, "
          f"{args.steps} steps, {device}) ==")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    t0 = time.time()
    params, losses = train_small_lm(cfg, data, steps=args.steps, lr=3e-3,
                                    log_every=50, device=device,
                                    params=params)
    print(f"   loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({time.time()-t0:.0f}s)")
    ppl_dense = eval_ppl(cfg, params, data)
    print(f"   dense PPL {ppl_dense:.3f}")

    print("== 2. calibrate (activation statistics) ==")
    stats = collect_activation_stats(cfg, params, data.calibration(4))

    print(f"== 3. sparsify {args.pattern} + outliers {args.outliers} "
          f"(RIA+SQ+VC) ==")
    ladder = {}
    for tag, kw in (
        ("magnitude", dict(scorer="magnitude", use_smoothquant=False,
                           use_variance_correction=False)),
        ("RIA", dict(scorer="ria", use_smoothquant=False,
                     use_variance_correction=False)),
        ("RIA+SQ+VC", dict(scorer="ria", use_smoothquant=True,
                           use_variance_correction=True)),
    ):
        scfg = SparsifyConfig(weight_pattern=args.pattern,
                              outlier_pattern=args.outliers, **kw)
        sp = sparsify_model(cfg, params, stats, scfg)
        ladder[tag] = eval_ppl(cfg, sp, data)
        print(f"   {tag:12s} PPL {ladder[tag]:.3f}")

    print(f"== 4. EBFT recovery ({args.ebft_steps} steps/block) ==")
    ppl_ebft, us = run_ebft_row(cfg, params, data,
                                weight_pattern=args.pattern,
                                outlier_pattern=args.outliers,
                                steps=args.ebft_steps, scorer="ria",
                                use_smoothquant=True,
                                use_variance_correction=True)
    print(f"   RIA+SQ+VC+EBFT PPL {ppl_ebft:.3f} ({us/1e6:.0f}s)")

    print("== summary (PPL, lower is better) ==")
    print(f"   dense          {ppl_dense:8.3f}")
    for k, v in ladder.items():
        print(f"   {k:14s} {v:8.3f}")
    print(f"   RIA+SQ+VC+EBFT {ppl_ebft:8.3f}")
    return {"dense": ppl_dense, **ladder, "RIA+SQ+VC+EBFT": ppl_ebft,
            "losses": losses}


def ladder_check(ladder: dict) -> None:
    """The reference's closing assertion."""
    assert ladder["RIA+SQ+VC+EBFT"] <= ladder["magnitude"], \
        "pipeline should beat magnitude"


def main(argv=None) -> dict:
    ladder = run(parse_args(argv))
    ladder_check(ladder)
    return ladder


if __name__ == "__main__":
    main()
