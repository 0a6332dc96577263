"""Training driver: data stream -> train step -> checkpoint and restart
(port of ``repro/launch/train.py``).

Each step draws its batch from ``SyntheticLM.batch_at(step)`` and runs
``steps.make_train_step``'s step eagerly on ``--device``.
``runtime.TrainSupervisor`` saves a checkpoint every ``--save-every``
steps and at the end (``runtime.CheckpointManager``, the JAX package's
on-disk layout, asynchronous); a failure (``--fail-at-step`` simulates one,
once) restores the last committed checkpoint and replays the stream from
its step.  A run whose ``--ckpt-dir`` already holds a checkpoint resumes
from it.  ``--n-layers`` cuts a full-width model's depth (a one-card
run), ``--keep-last-k`` bounds the checkpoints kept on disk.
``--production-mesh`` waits for the training mesh (ROADMAP A12c).

  python -m repro_torch.launch.train --arch llama3-8b --steps 50
  python -m repro_torch.launch.train --arch llama-paper --smoke-arch \\
      --device cpu --steps 4 --fail-at-step 2 --save-every 2
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import get, get_smoke
from ..data.pipeline import SyntheticLM
from ..device import resolve
from ..models.model_zoo import get_model
from ..optim import AdamWConfig, adamw_init
from ..runtime.checkpoint import CheckpointManager
from ..runtime.fault_tolerance import HostFailure, TrainSupervisor
from .steps import TrainOptions, make_train_step


def build(cfg, opt_cfg, opts: TrainOptions, mesh=None):
    """The train step of ``cfg``; ``mesh`` (the reference's sharded FSDP
    step) waits for ROADMAP A12c."""
    if mesh is not None:
        raise NotImplementedError(
            "a sharded train step (FSDP over a mesh) is not ported yet "
            "(ROADMAP A12c)")
    return make_train_step(cfg, opt_cfg, opts)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke-arch", action="store_true",
                    help="resolve --arch through the smoke registry")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to this many layers (full width), "
                         "so that a large model's state fits one card")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                        "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--keep-last-k", type=int, default=3,
                    help="committed checkpoints kept on disk")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="simulate a host failure once at this step")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args):
    """Train as ``args`` say; returns (``SupervisorReport``, the final
    state ``{"params", "opt"}``)."""
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh needs the training mesh, which is not ported "
            "yet (ROADMAP A12c)")
    device = resolve(args.device)
    cfg = get_smoke(args.arch) if args.smoke_arch else get(args.arch)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    opt_cfg = AdamWConfig(lr=args.lr)
    opts = TrainOptions(microbatches=args.microbatches,
                        grad_compression=args.grad_compression)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, keep_last_k=args.keep_last_k)
    supervisor = TrainSupervisor(ckpt, save_every=args.save_every)
    zoo = get_model(cfg, device)
    step = build(cfg, opt_cfg, opts)
    final = {}

    def make_state(restored):
        if restored is None:
            params = zoo.init(
                torch.Generator(device=device).manual_seed(args.seed))
            return {"params": params, "opt": adamw_init(params, opt_cfg)}
        return restored          # on the device of the state it replaces

    failed = {"done": False}

    def step_fn(state, i):
        if i == args.fail_at_step and not failed["done"]:
            failed["done"] = True
            raise HostFailure(f"simulated failure at step {i}")
        batch = {k: torch.as_tensor(v, device=device).long()
                 for k, v in data.batch_at(i).items()}
        t0 = time.time()
        params, opt, metrics = step(state["params"], state["opt"], batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_s"] = time.time() - t0
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} "
                  f"({metrics['step_s']:.2f}s)")
        final["state"] = {"params": params, "opt": opt}
        return final["state"], metrics

    report = supervisor.run(make_state, step_fn, args.steps, cfg=cfg)
    print(f"finished: {report.steps_run} steps, {report.restarts} restarts, "
          f"final loss {report.losses[-1]:.4f}")
    return report, final.get("state")


def main(argv=None):
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
