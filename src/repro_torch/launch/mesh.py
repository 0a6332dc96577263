"""Serving meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``).

JAX serves a mesh from one controller process; the port runs one process
per card, started by ``torchrun``, each holding a ``torch.distributed``
process group (NCCL on the card, gloo on the CPU) and a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")``.  The layers call explicit collectives on the ``"model"``
group (``parallel/tensor_parallel.py``).

  torchrun --nproc-per-node 8 -m repro_torch.launch.serve \\
      --arch llama3-8b --sparse --mesh 1x8

The fleet's per-replica meshes are disjoint rank slices
(``make_replica_meshes``):

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch llama3-8b --sparse --replicas 2 --mesh 1x2

Training runs on ``make_host_mesh()``: 1x1 in a process of its own, and
one data shard a rank, (W, 1), under ``torchrun`` with W ranks; or, with
``--production-mesh``, on ``make_production_mesh()`` over 256 ranks (512
with ``multi_pod``):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch mixtral-8x7b --smoke-arch --device cpu
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production training mesh over the process group: (16, 16)
    ``("data", "model")``, or (2, 16, 16) ``("pod", "data", "model")``
    with ``multi_pod``.  The group must have exactly that many ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = math.prod(shape)
    device = torch.device(device)
    _start_process_group(size, device)
    world = dist.get_world_size()
    if world != size:
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} needs {size} "
            f"ranks but the process group has world size {world} (start "
            f"one process per rank: torchrun --nproc-per-node {size}, or "
            f"over several hosts with --nnodes)")
    return DeviceMesh(device.type, torch.arange(world).view(*shape),
                      mesh_dim_names=names)


def parse_mesh_spec(spec: str | None) -> tuple[int, int] | None:
    """CLI mesh spec -> (data, model) sizes.

    ``"1x8"`` -> (1, 8); a bare ``"8"`` means model-only TP, i.e. (1, 8);
    None/"" -> None (no mesh: the single-device serving path)."""
    if spec is None or spec == "" or spec.lower() == "none":
        return None
    parts = spec.lower().split("x")
    try:
        if len(parts) == 1:
            dm = 1, int(parts[0])
        elif len(parts) == 2:
            dm = int(parts[0]), int(parts[1])
        else:
            dm = None
    except ValueError:
        dm = None
    if dm is None or dm[0] < 1 or dm[1] < 1:
        raise ValueError(f"mesh spec must be positive sizes like '1x8' or "
                         f"'8', got {spec!r}")
    return dm


def _start_process_group(size: int, device: torch.device) -> None:
    """Join the process group, unless this process already has one:
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
    and its rendezvous) when it is there, else a world of one process over
    an in-process store when ``size`` is 1.  NCCL on the card (after
    selecting ``cuda:LOCAL_RANK``), gloo on the CPU."""
    if dist.is_initialized():
        return
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not launched and size != 1:
        raise ValueError(
            f"a mesh of {size} ranks needs one process per rank: start them "
            f"with torchrun --nproc-per-node {size}")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if launched:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_serving_mesh(spec: str | None, device="cuda"):
    """The serving ("data", "model") ``DeviceMesh`` named by a CLI spec
    over the process group's ranks (joined or started here,
    ``_start_process_group``); None when no mesh is requested.  Every rank
    of the group serves, so the mesh's size must be the world size."""
    dm = parse_mesh_spec(spec)
    if dm is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    d, m = dm
    device = torch.device(device)
    _start_process_group(d * m, device)
    world = dist.get_world_size()
    if d * m != world:
        raise ValueError(
            f"mesh {d}x{m} needs {d * m} ranks but the process group has "
            f"world size {world} (start one process per rank: torchrun "
            f"--nproc-per-node {d * m})")
    return DeviceMesh(device.type, torch.arange(world).view(d, m),
                      mesh_dim_names=("data", "model"))


def make_host_mesh(device="cuda"):
    """The (W, 1) ("data", "model") mesh over the process group's W ranks
    (joined or started here): the 1x1 mesh on a world of one process."""
    from torch.distributed.device_mesh import DeviceMesh
    device = torch.device(device)
    _start_process_group(1, device)
    world = dist.get_world_size()
    return DeviceMesh(device.type, torch.arange(world).view(world, 1),
                      mesh_dim_names=("data", "model"))


def make_replica_meshes(spec: str | None, n_replicas: int, device="cuda"):
    """Per-replica serving meshes over disjoint rank slices, for the
    fleet's scale-out: replica i's ``spec``-shaped ("data", "model") mesh
    holds ranks [i*d*m, (i+1)*d*m) of the process group (joined or
    started here, ``_start_process_group``), so N replicas serve side by
    side with no rank shared.  ``spec`` is the per-replica mesh; None
    gives ``[None] * n_replicas`` (every replica on the single-device
    path).  Every rank builds every slice's mesh, because creating a
    group is a collective call; a rank is a member of one of them at
    most (``DeviceMesh.get_coordinate`` is None on the others)."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    dm = parse_mesh_spec(spec)
    if dm is None:
        return [None] * n_replicas
    from torch.distributed.device_mesh import DeviceMesh
    d, m = dm
    per = d * m
    device = torch.device(device)
    _start_process_group(per * n_replicas, device)
    world = dist.get_world_size()
    if per * n_replicas > world:
        raise ValueError(
            f"{n_replicas} replicas of a {d}x{m} mesh need "
            f"{per * n_replicas} ranks but the process group has world "
            f"size {world} (start one process per rank: torchrun "
            f"--nproc-per-node {per * n_replicas})")
    return [DeviceMesh(device.type,
                       torch.arange(i * per, (i + 1) * per).view(d, m),
                       mesh_dim_names=("data", "model"))
            for i in range(n_replicas)]
