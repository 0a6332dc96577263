"""Training driver: data stream -> sharded train step -> checkpoint and
restart (port of ``repro/launch/train.py``).

Each step draws its batch from ``SyntheticLM.batch_at(step)`` and runs
``build``'s step eagerly on ``--device``, on a mesh and under its
activation policy, as the reference's ``main`` does: ``make_host_mesh()``
(1x1 in a process of its own; one data shard a rank under ``torchrun``)
or, with ``--production-mesh``, ``make_production_mesh()`` (256 ranks).
So a moe model trains through the capacity path (``models/moe._moe_ep``)
on any mesh.  Every rank holds its blocks of the params and moments
(``parallel/fsdp.py``).  ``runtime.TrainSupervisor`` saves a checkpoint
every ``--save-every`` steps and at the end (``runtime.CheckpointManager``,
the JAX package's on-disk layout, gathered from the ranks and written by
rank 0 in the background); a failure (``--fail-at-step`` simulates one,
once, on every rank) restores the last committed checkpoint onto the mesh
and replays the stream from its step.  A run whose ``--ckpt-dir`` already
holds a checkpoint resumes from it.  ``--n-layers`` cuts a full-width
model's depth (a one-card run), ``--keep-last-k`` bounds the checkpoints
kept on disk.  A process group ``run`` starts it also destroys.

  python -m repro_torch.launch.train --arch llama3-8b --steps 50
  python -m repro_torch.launch.train --arch llama-paper --smoke-arch \\
      --device cpu --steps 4 --fail-at-step 2 --save-every 2
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch mixtral-8x7b --smoke-arch --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..configs import get, get_smoke
from ..data.pipeline import SyntheticLM
from ..device import resolve
from ..models.model_zoo import get_model
from ..optim import AdamWConfig, adamw_init
from ..parallel import fsdp
from ..runtime.checkpoint import CheckpointManager
from ..runtime.fault_tolerance import HostFailure, TrainSupervisor
from .mesh import make_host_mesh, make_production_mesh
from .steps import TrainOptions, make_train_step


def build(cfg, opt_cfg, opts: TrainOptions, mesh=None, state=None):
    """(the train step of ``cfg``, the params' ``StateSharding``, the
    optimizer state's), as the reference returns (jitted, p_sh, o_sh).
    With a ``mesh`` the step takes and returns this rank's blocks (cut by
    ``fsdp.shard_tree`` from the specs) and the global batch; without
    one it is the unplaced step and the shardings are None.  The specs
    are read off ``state`` (params, optimizer state: whole or fake
    tensors, as a dry run holds them) or, by default, off the zoo's fake
    init."""
    if mesh is None:
        return make_train_step(cfg, opt_cfg, opts), None, None
    params, opt = state or fsdp.shapes_of(get_model(cfg, "cpu"),
                                          lambda p: adamw_init(p, opt_cfg))
    tm = fsdp.TrainMesh(mesh)           # every rank builds its groups here
    p_sh = fsdp.state_sharding(tm, params)
    o_sh = fsdp.state_sharding(tm, opt)
    return make_train_step(cfg, opt_cfg, opts, sharding=p_sh), p_sh, o_sh


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
    state ``{"params", "opt"}``: this rank's blocks)."""
    device = resolve(args.device)
    cfg = get_smoke(args.arch) if args.smoke_arch else get(args.arch)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    started = not dist.is_initialized()
    try:
        mesh = (make_production_mesh(device=device) if args.production_mesh
                else make_host_mesh(device))
        return _run(args, cfg, device, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, cfg, device, mesh):
    opt_cfg = AdamWConfig(lr=args.lr)
    opts = TrainOptions(microbatches=args.microbatches,
                        grad_compression=args.grad_compression)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=args.seed)
    step, p_sh, o_sh = build(cfg, opt_cfg, opts, mesh)
    state_sh = fsdp.StateSharding(
        p_sh.tm, {"params": p_sh.specs, "opt": o_sh.specs},
        {"params": p_sh.shapes, "opt": o_sh.shapes})
    ckpt = CheckpointManager(args.ckpt_dir, keep_last_k=args.keep_last_k,
                             shardings=state_sh)
    supervisor = TrainSupervisor(ckpt, save_every=args.save_every)
    zoo = get_model(cfg, device)
    lead = dist.get_rank() == 0
    final = {}

    def make_state(restored):
        if restored is None:
            params = fsdp.shard_tree(zoo.init(
                torch.Generator(device=device).manual_seed(args.seed)), p_sh)
            return {"params": params, "opt": adamw_init(params, opt_cfg)}
        return restored          # this rank's blocks, on the state's device

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
        if lead and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} "
                  f"({metrics['step_s']:.2f}s)")
        final["state"] = {"params": params, "opt": opt}
        return final["state"], metrics

    report = supervisor.run(make_state, step_fn, args.steps, cfg=cfg)
    if lead:
        print(f"finished: {report.steps_run} steps, {report.restarts} "
              f"restarts, final loss {report.losses[-1]:.4f}")
    return report, final.get("state")


def main(argv=None):
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
