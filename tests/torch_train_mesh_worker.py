"""One rank of the gloo worlds that ``tests/test_torch_train_mesh.py``
spawns, and the cases both sides share.  Imports only numpy, torch and
the port (``repro_torch``): the JAX side runs in
``tests/jax_train_mesh_reference.py``.

A world of 2 ranks holds the 2x1 and 1x2 meshes, a world of 4 the 4x1,
2x2 and 1x4 ones (``DeviceMesh``es over the same ranks).  Each rank joins a
gloo group through a ``file://`` store and runs, in lockstep with the
others:

  * every sharded-step case of its world (``launch/train.build(mesh=)``):
    the losses and gradient norms of each step, whether each block it
    holds is its spec's block of the gathered leaf, and (the mesh's first
    rank) the gathered params and moments;
  * every MoE case of its world: ``moe_apply`` under
    ``activation_sharding`` on the rank's rows, with the dropped pairs;
  * checkpoints: on 4 ranks the 2x2 step's state saved from 2x2 and
    restored onto 1x4; on 2 ranks an unplaced save restored onto 2x1;
  * on 2 ranks, with the file-store group destroyed, ``launch/train.run``
    twice under a ``torchrun``-like environment (``env://``), each with a
    simulated failure.

It saves what it saw to ``<out_dir>/rank<r>.pt``.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pathlib

import numpy as np

B, S = 4, 16
LR = 1e-3
N_STEPS = 2
# a mixtral twin whose 2 experts split one a shard over 2 data shards
E2 = {"moe": {"num_experts": 2}}
# a mixtral twin whose 3 experts divide no data split: every shard runs
# every expert on its own buffers
E3 = {"moe": {"num_experts": 3}}

# name -> (arch, cfg overrides, mesh shape, microbatches, compression)
STEP_CASES = {
    "llama-2x1": ("llama-paper", {}, (2, 1), 1, False),
    "llama-1x2": ("llama-paper", {}, (1, 2), 1, False),
    "llama-2x2": ("llama-paper", {}, (2, 2), 1, False),
    "llama-2x2-mb2-int8": ("llama-paper", {}, (2, 2), 2, True),
    "mixtral-1x2": ("mixtral-8x7b", {}, (1, 2), 1, False),
    "mixtral-4x1": ("mixtral-8x7b", {}, (4, 1), 1, False),
    "mixtral-e2-2x1": ("mixtral-8x7b", E2, (2, 1), 1, False),
    "mixtral-e2-2x2": ("mixtral-8x7b", E2, (2, 2), 1, False),
    "xlstm-2x2": ("xlstm-350m", {}, (2, 2), 1, False),
    "qwen2-vl-2x2": ("qwen2-vl-72b", {}, (2, 2), 1, False),
}
# name -> (arch, cfg overrides, mesh shape, tokens)
MOE_CASES = {
    "ep-2x1": ("mixtral-8x7b", {}, (2, 1), 96),
    "ep-2x2": ("mixtral-8x7b", {}, (2, 2), 96),
    "ep-4x1": ("mixtral-8x7b", {}, (4, 1), 96),
    "all-experts-2x1": ("mixtral-8x7b", E3, (2, 1), 96),
    "all-experts-2x2": ("mixtral-8x7b", E3, (2, 2), 96),
}
# the driver on 2x1: 6 steps, saves at 3 and 6, a failure at step 4
DRIVER = ["--smoke-arch", "--device", "cpu", "--steps", "6", "--batch",
          "4", "--seq", "32", "--save-every", "3", "--fail-at-step", "4",
          "--lr", "1e-3", "--seed", "0"]
DRIVER_ARCHS = {"llama": ("llama-paper", {}),
                "mixtral-e2": ("mixtral-8x7b", E2)}


def port_cfg(arch: str, over: dict):
    import torch
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    if "moe" in over:
        over = dict(over, moe=dataclasses.replace(cfg.moe, **over["moe"]))
    return dataclasses.replace(cfg, **over)


def world_of(shape) -> int:
    return int(np.prod(shape))


def _mesh(shape):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(world_of(shape)).view(*shape),
                      mesh_dim_names=("data", "model"))


def _blocks_ok(blocks, whole, sh) -> bool:
    """Every block is its spec's block of the gathered leaf, at the spec
    block's shape."""
    import torch
    from repro_torch.parallel.sharding import local_shard
    from repro_torch.tree import flatten
    tm = sh.tm
    for b, w, spec in zip(flatten(blocks), flatten(whole), flatten(sh.specs)):
        want = local_shard(w, spec, tm.sizes, tm.coords)
        if tuple(b.shape) != tuple(want.shape) or not torch.equal(b, want):
            return False
    return True


def _step_case(name, case, params, batches, meshes):
    import torch
    from repro_torch.launch import steps, train
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import fsdp
    arch, over, shape, mb, compress = case
    cfg = port_cfg(arch, over)
    ocfg = AdamWConfig(lr=LR)
    step, p_sh, o_sh = train.build(cfg, ocfg, steps.TrainOptions(
        microbatches=mb, grad_compression=compress), mesh=meshes[shape].mesh)
    lead = not any(p_sh.tm.coords.values())
    blocks = fsdp.shard_tree(params, p_sh)
    opt = adamw_init(blocks, ocfg)
    res = {"loss": [], "grad_norm": [], "blocks_ok": True}
    for b in batches:
        blocks, opt, m = step(blocks, opt, {
            k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()})
        res["loss"].append(float(m["loss"]))
        res["grad_norm"].append(float(m["grad_norm"]))
        whole_p = fsdp.unshard_tree(blocks, p_sh)
        whole_o = fsdp.unshard_tree(opt, o_sh)
        res["blocks_ok"] &= (_blocks_ok(blocks, whole_p, p_sh)
                             and _blocks_ok(opt, whole_o, o_sh))
        if lead and "first" not in res:
            res["first"] = {"params": whole_p, "m": whole_o["m"],
                            "v": whole_o["v"]}
    res["split"] = sum(fsdp.splits(s) for s in _leaves(p_sh.specs))
    return res, (blocks, opt, p_sh, o_sh)


def _leaves(tree):
    from repro_torch.tree import flatten
    return flatten(tree)


def _moe_case(case, p, x2, meshes):
    import torch
    from repro_torch.models import moe
    from repro_torch.parallel.policy import activation_sharding
    arch, over, shape, _ = case
    cfg = port_cfg(arch, over)
    tm = meshes[shape]
    rows = torch.from_numpy(x2).chunk(tm.n_fsdp)[tm.fsdp_index]
    with activation_sharding(tm), moe.record_drops() as drops:
        out = moe.moe_apply(p, rows, cfg)
    return {"out": out, "drops": [d.numpy() for d in drops],
            "shard": tm.fsdp_index}


def _run_driver(rank, world, port, arch, over, ckpt_dir):
    import torch.distributed as dist
    from repro_torch.launch import train
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    real = train.get_smoke
    train.get_smoke = lambda a: port_cfg(a, over)
    try:
        report, state = train.run(train.parse_args(
            ["--arch", arch, "--ckpt-dir", ckpt_dir] + DRIVER))
    finally:
        train.get_smoke = real
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            os.environ.pop(k, None)
    return {"losses": report.losses, "restarts": report.restarts,
            "restored_steps": report.restored_steps,
            "steps_run": report.steps_run,
            "group_left": dist.is_initialized()}


def rank_main(rank: int, world: int, store: str, job: dict,
              out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    out = pathlib.Path(out_dir)
    res = {"steps": {}, "moe": {}}
    try:
        from repro_torch.parallel import fsdp
        from repro_torch.runtime.checkpoint import CheckpointManager
        shapes = [(4, 1), (2, 2), (1, 4)] if world == 4 else [(2, 1), (1, 2)]
        meshes = {s: fsdp.TrainMesh(_mesh(s)) for s in shapes}
        kept = {}
        for name, case in STEP_CASES.items():
            if world_of(case[2]) != world:
                continue
            res["steps"][name], kept[name] = _step_case(
                name, case, job["params"][name], job["batches"][name],
                meshes)
        for name, case in MOE_CASES.items():
            if world_of(case[2]) == world:
                res["moe"][name] = _moe_case(case, job["moe_params"][name],
                                             job["x2"][name], meshes)
        if world == 4:
            # the 2x2 state saved from 2x2, restored onto 1x4
            blocks, opt, p_sh, o_sh = kept["llama-2x2"]
            sh22 = _state_sharding(p_sh, o_sh)
            cm = CheckpointManager(out / "ck22", shardings=sh22)
            cm.save(2, {"params": blocks, "opt": opt}, blocking=False)
            cm.wait()
            whole = fsdp.unshard_tree({"params": blocks, "opt": opt}, sh22)
            sh14 = _reshard(sh22, meshes[(1, 4)])
            like = fsdp.shard_tree(whole, sh14)
            got, manifest = CheckpointManager(out / "ck22").restore(
                like, shardings=sh14)
            back = fsdp.unshard_tree(got, sh14)
            res["ckpt_1x4"] = {
                "step": manifest["step"],
                "blocks_ok": _blocks_ok(got, back, sh14),
                "equal": all(torch.equal(a, b) for a, b in zip(
                    _leaves(back), _leaves(whole))),
                "latest": CheckpointManager(
                    out / "ck22", shardings=sh14).latest_step()}
            if rank == 0:
                res["ckpt_whole"] = whole
        else:
            # an unplaced save (the parent's) restored onto 2x1
            state = job["unplaced_state"]
            sh21 = _state_sharding_of(meshes[(2, 1)], state)
            like = fsdp.shard_tree(state, sh21)
            got, _ = CheckpointManager(job["unplaced_dir"]).restore(
                like, shardings=sh21)
            res["restore_2x1"] = {
                "blocks_ok": _blocks_ok(got, state, sh21),
                "split": sum(fsdp.splits(s) for s in _leaves(sh21.specs))}
    finally:
        dist.destroy_process_group()
    if world == 2:
        res["driver"] = {
            key: _run_driver(rank, world, job["ports"][key], arch, over,
                             str(out / f"driver-{key}"))
            for key, (arch, over) in DRIVER_ARCHS.items()}
    torch.save(res, out / f"rank{rank}.pt")


def _state_sharding(p_sh, o_sh):
    from repro_torch.parallel import fsdp
    return fsdp.StateSharding(p_sh.tm,
                              {"params": p_sh.specs, "opt": o_sh.specs},
                              {"params": p_sh.shapes, "opt": o_sh.shapes})


def _state_sharding_of(tm, state):
    from repro_torch.parallel import fsdp
    return _state_sharding(fsdp.state_sharding(tm, state["params"]),
                           fsdp.state_sharding(tm, state["opt"]))


def _reshard(sh, tm):
    from repro_torch.parallel import fsdp
    from repro_torch.tree import flatten, unflatten
    import torch
    fake = unflatten(sh.shapes, [torch.empty(s, device="meta")
                                 for s in flatten(sh.shapes)])
    return _state_sharding_of(tm, fake)
