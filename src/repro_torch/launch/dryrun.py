"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell,
on fake tensors over a fake process group (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step for 512 host devices
and reads XLA's analyses.  The port has one card, and its steps are eager
PyTorch with explicit collectives, so for each cell this driver:
  1. starts a fake process group of 256 ranks (512 with ``--multi-pod``)
     as rank ``--rank`` and builds the production mesh over it
     (``launch/mesh.make_production_mesh``: 16x16 or 2x16x16);
  2. builds the cell's step (``build_step``) with this rank's inputs as
     fake tensors on ``--device`` (fake CUDA tensors by default: the
     card's path, whose kernel wrappers record their launches instead of
     launching), nothing allocated;
  3. runs the step once and reads what it ran (``launch/hlo_analysis``):
     FLOPs, bytes, the memory analysis' keys and the collectives by kind;
  4. (single-pod) runs it again at two reduced depths and fits the
     per-layer costs (``depth_probe``; the port has no scan, so the fit
     reproduces the full-depth counts, a check of the record);
  5. writes one JSON per cell to ``--out``, in the reference's layout, so
     its ``benchmarks/roofline.load_cell`` and ``dryrun_summary`` read it.

The placements are the port's: training shards the state by
``parallel/fsdp.py`` (with the reference's rule for ssm: only the
embedding and head keep their ``model`` split); prefill and decode place
the params by ``serving/placement.ServingPlacement`` over the mesh's
``model`` axis, the batch rows (and the decode caches' rows) over the
fsdp axes by ``parallel/sharding.batch_spec``, and the KV heads by
``place_kv`` where the family's one-shot step attends head-locally (the
transformer families).  What the port places otherwise is recorded under
``"placement"``: the reference's sequence split of a global batch of one
(``seq_shard``) has no counterpart and is replicated over ``data``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu \\
      --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist

from ..configs import ASSIGNED, SHAPES, ShapeConfig, get, shape_applicable
from ..core.pipeline import SparsifyConfig, map_leaves
from ..models import model_zoo
from ..models.model_zoo import cache_specs, input_specs, param_specs
from ..models.sparse_serving import sparsify_specs
from ..optim import AdamWConfig, adamw_init
from ..parallel import fsdp
from ..parallel.sharding import (axis_sizes, batch_spec, block_shape,
                                 local_shard, splits)
from ..tree import flatten, unflatten
from .hlo_analysis import (collective_bytes, collective_counts, cost_summary,
                           nbytes, record_step)
from .mesh import make_production_mesh
from .steps import (TrainOptions, make_decode_step, make_prefill_step,
                    make_train_step)

PROBE_DEPTHS = {
    "dense": (2, 4), "moe": (2, 4), "vlm": (2, 4), "encdec": (2, 4),
    "ssm": (8, 16), "hybrid": (6, 12),
}

SKIP_REASON = ("full-attention arch; long_500k requires sub-quadratic state "
               "(DESIGN.md §5)")

SEQ_SHARD_NOTE = ("global batch 1: the reference splits the sequence over "
                  "data (seq_shard); the port has no sequence split and "
                  "replicates the rows over data")


def _opt_cfg(cfg) -> AdamWConfig:
    big = cfg.param_count() > 1e11
    return AdamWConfig(state_dtype=torch.bfloat16 if big else torch.float32)


def _train_opts(cfg) -> TrainOptions:
    """>30B models: microbatched gradient accumulation (8x)."""
    return TrainOptions(microbatches=8 if cfg.param_count() > 30e9 else 1)


def _reduce_depth(cfg, L: int):
    kw = {"n_layers": L}
    if cfg.family == "encdec":
        kw["enc_layers"] = L
    return dataclasses.replace(cfg, **kw)


@dataclasses.dataclass
class BuiltStep:
    """A cell's step and this rank's fake inputs, not yet run."""
    step: Any
    args: tuple
    mode: Any                 # the FakeTensorMode the inputs live in
    held: Any = None          # what the rank holds, when not ``args``
    donated: tuple = ()
    placement: dict = dataclasses.field(default_factory=dict)

    @property
    def argument_bytes(self) -> int:
        return nbytes(self.args if self.held is None else self.held)


def _fake_batch(cfg, shape, device) -> dict:
    return {k: torch.zeros(dims, dtype=dtype, device=device)
            for k, (dims, dtype) in input_specs(cfg, shape).items()}


def _rows(batch: dict, mesh, coords) -> dict:
    """This rank's rows of a global batch (``batch_spec``)."""
    sizes = axis_sizes(mesh)
    return {k: local_shard(v, batch_spec(mesh, v.shape), sizes, coords)
            for k, v in batch.items()}


def _blocks(tree, sh: fsdp.StateSharding):
    """This rank's block of every fake leaf, as ``fsdp.shard_tree`` cuts
    it (a contiguous tensor of the block's shape), made empty: a fake
    tensor's copy holds nothing to copy."""
    return unflatten(tree, [
        t.new_empty(block_shape(t.shape, spec, sh.tm.sizes))
        if splits(spec) else t
        for t, spec in zip(flatten(tree), flatten(sh.specs))])


def _drop_model(sh: fsdp.StateSharding) -> fsdp.StateSharding:
    """The reference's ssm rule: the embedding and head keep their
    ``model`` split, every other leaf drops it (pure data-parallel FSDP
    for the block weights)."""
    def drop(path, spec):
        if "embed" in path or "lm_head" in path:
            return spec
        return tuple(None if ax == "model" or (isinstance(ax, tuple)
                                               and "model" in ax) else ax
                     for ax in spec)
    return dataclasses.replace(sh, specs=map_leaves(sh.specs, drop))


def _train(cfg, shape, mesh, opts, device, mode) -> BuiltStep:
    ocfg = _opt_cfg(cfg)
    if mesh is None:
        step = make_train_step(cfg, ocfg, opts)
        with mode:
            params = param_specs(cfg, device)
            opt = adamw_init(params, ocfg)
            batch = _fake_batch(cfg, shape, device)
        return BuiltStep(step, (params, opt, batch), mode, donated=(0, 1))
    from .train import build
    with mode:
        params = param_specs(cfg, device)
        opt = adamw_init(params, ocfg)
    step, p_sh, o_sh = build(cfg, ocfg, opts, mesh, state=(params, opt))
    if cfg.family == "ssm":
        p_sh, o_sh = _drop_model(p_sh), _drop_model(o_sh)
        step = make_train_step(cfg, ocfg, opts, sharding=p_sh)
    coords = p_sh.tm.coords
    with mode:
        blocks = _blocks(params, p_sh)
        opt = _blocks(opt, o_sh)
        del params
        batch = _fake_batch(cfg, shape, device)
        rows = _rows(batch, mesh, coords)
    return BuiltStep(step, (blocks, opt, batch), mode,
                     held=(blocks, opt, rows), donated=(0, 1))


def _serve(cfg, shape, mesh, sparse, quant, device, mode) -> BuiltStep:
    """A prefill or decode cell: the step on this rank's placed params,
    batch rows and (decode) caches."""
    placement, heads = {}, None
    if mesh is not None:
        from ..serving.placement import ServingPlacement
        sp = ServingPlacement(mesh["model"], cfg)
        sp.axis, sp.coords                     # read the mesh outside the mode
        coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        if cfg.family == "ssm":
            placement["state"] = "replicated over model"
        elif not sp.kv_sharded:
            placement["kv"] = "replicated over model"
        elif cfg.family in model_zoo.TRANSFORMER_FAMILIES:
            heads = sp.heads
            placement["kv"] = "KV heads over model (place_kv)"
        else:
            placement["kv"] = ("replicated over model: the family's "
                               "one-shot step attends every head")
        if shape.global_batch == 1:
            placement["seq_shard"] = SEQ_SHARD_NOTE
    with mode:
        params = param_specs(cfg, device)
        if sparse:
            params = sparsify_specs(params, SparsifyConfig(
                scorer="magnitude", use_smoothquant=False),
                quantize=quant)[0]
        if mesh is not None:
            params = sp.place_params(params)
        batch = _fake_batch(cfg, shape, device)
        if mesh is not None:
            batch = _rows(batch, mesh, coords)
        if shape.kind == "prefill":
            return BuiltStep(make_prefill_step(cfg, heads=heads),
                             (params, batch), mode, placement=placement)
        rows = next(iter(batch.values())).shape[0]
        local = ShapeConfig(shape.name, shape.seq_len, rows, shape.kind)
        caches = _fake_caches(cfg, local, device)
        if heads is not None:
            caches["k"], caches["v"] = (sp.place_kv(caches[k])
                                        for k in ("k", "v"))
    return BuiltStep(make_decode_step(cfg, heads=heads),
                     (params, caches, batch), mode, donated=(1,),
                     placement=placement)


def _fake_caches(cfg, shape, device) -> dict:
    """The decode cache of ``cache_specs`` as fake tensors; ``pos`` on the
    host at the cache's last position (a fake tensor holds no value for
    the host's cursor)."""
    def make(spec):
        if spec is None:
            return None
        if isinstance(spec, list):
            return [make(s) for s in spec]
        if isinstance(spec[0], tuple) and (not spec[0] or
                                           isinstance(spec[0][0], int)):
            dims, dtype = spec
            return torch.zeros(dims, dtype=dtype, device=device)
        return tuple(make(s) for s in spec)
    caches = {k: make(v) for k, v in cache_specs(cfg, shape).items()
              if k != "pos"}
    caches["pos"] = shape.seq_len - 1
    return caches


def build_step(cfg, shape, mesh, sparse: bool = False, quant: bool = False,
               *, device="cuda", opts: TrainOptions | None = None
               ) -> BuiltStep:
    """The cell's step and this rank's inputs as fake tensors on
    ``device``, without running the step (the reference's
    ``build_lowered``).  ``mesh`` is the cell's ``DeviceMesh`` over a
    (fake) process group, or None for the unplaced step of a world of
    one.  ``sparse=True`` deploys the compressed 8:16 + 16:256 weights
    (magnitude, no SmoothQuant; ``quant``: int8 values) in the serving
    steps, by shape alone (``sparsify_specs``)."""
    mode = fsdp.fake_mode()
    if shape.kind == "train":
        if sparse:
            raise ValueError("sparse deploy is a serving feature")
        return _train(cfg, shape, mesh, opts or _train_opts(cfg), device,
                      mode)
    return _serve(cfg, shape, mesh, sparse, quant, device, mode)


def analyse(built: BuiltStep) -> dict:
    """Run the built step once on its fake inputs and summarise it: the
    reference's ``cost_summary`` plus the collectives by kind, the
    hand-written kernels' launches by plan, and the run's wall (under
    the reference's key ``compile_s``)."""
    t0 = time.time()
    with built.mode:
        rec = record_step(built.step, built.args, held=built.held,
                          donated=built.donated)
    res = cost_summary(rec)
    res["collective_bytes"] = collective_bytes(rec)
    res["collective_counts"] = collective_counts(rec)
    res["kernel_launches"] = rec.launches_by_plan()
    res["compile_s"] = round(time.time() - t0, 1)
    return res


@dataclasses.dataclass
class FakeWorld:
    """A fake process group of ``shape``'s ranks with this process as
    ``rank``, and its mesh: the production mesh for (16, 16) and (2, 16,
    16), else a ``DeviceMesh`` of ``names`` (the tests' small worlds).
    A group this started it destroys on exit."""
    shape: tuple
    rank: int = 0
    device: str = "cuda"

    def __enter__(self):
        import math
        from torch.testing._internal.distributed.fake_pg import FakeStore
        self.started = not dist.is_initialized()
        size = math.prod(self.shape)
        if self.started:
            dist.init_process_group("fake", store=FakeStore(),
                                    rank=self.rank, world_size=size)
        dev = torch.device(self.device).type
        if self.shape in ((16, 16), (2, 16, 16)):
            return make_production_mesh(multi_pod=len(self.shape) == 3,
                                        device=dev)
        from torch.distributed.device_mesh import DeviceMesh
        names = (("pod", "data", "model") if len(self.shape) == 3
                 else ("data", "model"))
        return DeviceMesh(dev, torch.arange(size).view(*self.shape),
                          mesh_dim_names=names)

    def __exit__(self, *exc):
        if self.started and dist.is_initialized():
            dist.destroy_process_group()
        return False


def run_cell(arch: str, shape_name: str, multi_pod: bool, probe: bool = True,
             out_dir: pathlib.Path | None = None, verbose: bool = True,
             sparse: bool = False, quant: bool = False, *,
             device="cuda", rank: int = 0, cfg=None, shape=None,
             mesh_shape: tuple | None = None) -> dict:
    """One cell's record, written to ``out_dir`` as
    ``{arch}__{shape}__{mesh}.json``.  ``cfg``, ``shape`` and
    ``mesh_shape`` replace the registry's config, the named shape and the
    production mesh (the tests' smoke twins on small worlds); the record
    keeps the names it was given."""
    cfg = cfg or get(arch)
    shape = shape or SHAPES[shape_name]
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    if sparse:
        mesh_tag += "_sparse"
    if quant:
        mesh_tag += "q"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "params": cfg.param_count(), "active_params": cfg.active_param_count()}

    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = SKIP_REASON
    else:
        world = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
        rec["rank"] = rank
        rec["device"] = str(device)
        with FakeWorld(world, rank, device) as mesh:
            try:
                built = build_step(cfg, shape, mesh, sparse=sparse,
                                   quant=quant, device=device)
                if built.placement:
                    rec["placement"] = built.placement
                rec["full"] = analyse(built)
                del built
                rec["status"] = "ok"
                if verbose:
                    mem = rec["full"]["memory"]
                    print(f"  [{arch} x {shape_name} x {mesh_tag}] ok "
                          f"args={mem['argument_size_in_bytes']/2**30:.2f}GiB/dev "
                          f"temp={mem['temp_size_in_bytes']/2**30:.2f}GiB/dev "
                          f"flops={rec['full']['flops']:.3g} "
                          f"coll={rec['full']['collective_bytes'].get('total', 0)/2**20:.1f}MiB",
                          flush=True)
            except Exception as e:  # noqa: BLE001 — record the failure, the run goes on
                rec["status"] = "error"
                rec["error"] = f"{type(e).__name__}: {e}"
                rec["traceback"] = traceback.format_exc()[-2000:]
                print(f"  [{arch} x {shape_name} x {mesh_tag}] FAILED: "
                      f"{rec['error']}", flush=True)

            if probe and not multi_pod and rec["status"] == "ok":
                try:
                    rec["probe"] = depth_probe(cfg, shape, mesh,
                                               sparse=sparse, quant=quant,
                                               device=device)
                except Exception as e:  # noqa: BLE001
                    rec["probe_error"] = f"{type(e).__name__}: {e}"

    if out_dir is not None:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        fn = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
        fn.write_text(json.dumps(rec, indent=1))
    return rec


def depth_probe(cfg, shape, mesh, sparse: bool = False, quant: bool = False,
                *, device="cuda") -> dict:
    """Run at two reduced depths; linear-fit the per-layer cost.  The
    probes keep the full cell's microbatches (the reference's take them
    from the reduced model, one below 30e9 params, so its fit mixes two
    microbatch counts for the models above)."""
    L1, L2 = PROBE_DEPTHS[cfg.family]
    opts = _train_opts(cfg) if shape.kind == "train" else None
    probes = {}
    for L in (L1, L2):
        built = build_step(_reduce_depth(cfg, L), shape, mesh, sparse=sparse,
                           quant=quant, device=device, opts=opts)
        probes[L] = analyse(built)
        del built

    def fit(get_val):
        c1, c2 = get_val(probes[L1]), get_val(probes[L2])
        b = (c2 - c1) / (L2 - L1)
        a = c1 - b * L1
        return a + b * cfg.n_layers

    return {
        "flops": fit(lambda r: r["flops"]),
        "bytes_accessed": fit(lambda r: r["bytes_accessed"]),
        "collective_bytes": fit(lambda r: r["collective_bytes"].get("total",
                                                                     0.0)),
        "depths": [L1, L2],
        "probe_full": probes,
    }


def iter_cells():
    for arch in ASSIGNED:
        for shape_name in SHAPES:
            yield arch, shape_name


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--sparse", action="store_true",
                    help="deploy compressed 8:16+outlier weights (serving cells)")
    ap.add_argument("--quant", action="store_true",
                    help="with --sparse: int8 N:M values (beyond-paper)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the card's path, "
                         "kernel launches recorded) or cpu (the plain path)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the fake world whose step is read")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out = pathlib.Path(args.out)
    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    t0 = time.time()
    for arch, shape_name in cells:
        for mp in meshes:
            run_cell(arch, shape_name, mp, probe=not args.no_probe,
                     out_dir=out, sparse=args.sparse, quant=args.quant,
                     device=args.device, rank=args.rank)
    print(f"done in {time.time()-t0:.0f}s -> {out}")


if __name__ == "__main__":
    main()
