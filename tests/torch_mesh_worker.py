"""One rank of the gloo meshes that ``tests/test_torch_mesh_serving.py``
(the dense family) and ``tests/test_torch_mesh_families.py`` with its
1x4 twin (ssm, hybrid, moe, encdec) spawn, and the serving cases both
sides share.  Imports only numpy, torch
and the port (``repro_torch``): the JAX side of the comparison runs in the
test's own process.

Each rank joins a gloo process group through a ``file://`` store, builds
the 1 x world ``DeviceMesh`` with ``launch/mesh.make_serving_mesh``, and
serves every case of ``cases()`` on ``ServingEngine(mesh=)`` in lockstep
with the other ranks, then every case of ``spec_cases()`` with a drafter
on the same mesh, a fleet of two replicas of 1 x world/2 over
``make_replica_meshes`` on the fleet trace, and ``serve --mesh`` and
``serve --replicas 2 --mesh`` replaying a trace; it saves what it saw
(streams, the plan of every step, the pool's stats, its arenas' heads,
whether its ``SparseWeight`` rows are the co-sliced rows of the whole
container, drafted and accepted counts, the fleet's decisions) to
``<out_dir>/rank<r>.pt`` for the test to hold against the JAX
single-device engines, the JAX fleet and the other ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import pathlib

import numpy as np

BS, GEN, VOCAB = 8, 5, 512
SHAPE = dict(n_layers=2, d_model=128, n_heads=8, head_dim=16, d_ff=256,
             vocab=VOCAB)
KV_HEADS = {"dense": 8, "sparse": 8, "gqa": 2,      # gqa: KV divides no mesh
            "other": 8}                             # a drafter's other weights
SPEC_K = 3
# the fleet's trace and engines (``tests/test_torch_fleet.py``'s, at
# steal threshold 1: steals, preemptions and a drain)
FLEET_TRACE = dict(n_requests=16, n_tenants=4, vocab=VOCAB, sys_len=16,
                   rate_per_s=200.0, burst_mean=3.0, prompt_median=6,
                   prompt_sigma=0.5, prompt_max=16, gen_median=5,
                   gen_sigma=0.8, gen_max=12, seed=11)
FLEET_KW = dict(n_replicas=2, routing="prefix", steal_threshold=1,
                n_slots=4, n_blocks=16, kv_layout="paged", block_size=4,
                max_len=48, prefix_caching=True, max_queue=64,
                token_budget=32)
FLEET_DT = 0.005                # virtual seconds between fleet steps


def _prompts(n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, length).tolist() for _ in range(n)]


def cases() -> dict:
    """name -> (params key, engine kwargs, waves): each wave a list of
    (prompt, SamplingParams kwargs), submitted when the engine has drained
    the previous one.  The reference's mesh cases (``tests/
    test_mesh_serving.py``): dense and 8:16 + 16:256, slot and paged KV,
    bf16 and int8 KV, prefix-cache hits, preemption and resume; and GQA
    with 2 KV heads, which divide neither 4 nor 8 ranks (arenas
    replicated)."""
    greedy = [[(p, dict(max_new_tokens=GEN)) for p in _prompts(3, 12, 1)]]
    out = {}
    # every pair of (weights, layout), (weights, KV dtype) and (layout, KV
    # dtype) in four runs
    for which, layout, kv_dtype in (("dense", "slot", "bf16"),
                                    ("sparse", "paged", "bf16"),
                                    ("dense", "paged", "int8"),
                                    ("sparse", "slot", "int8")):
        out[f"{which}-{layout}-{kv_dtype}"] = (
            which, dict(n_slots=4, max_len=32, kv_layout=layout,
                        block_size=BS, kv_dtype=kv_dtype), greedy)
    system = _prompts(1, 3 * BS, 5)[0]
    out["prefix-hits"] = (
        "sparse", dict(n_slots=4, max_len=64, kv_layout="paged",
                       block_size=BS),
        [[(system + t, dict(max_new_tokens=GEN))]
         for t in _prompts(3, 6, 6)])
    out["preemption"] = (
        "dense", dict(n_slots=4, max_len=40, kv_layout="paged",
                      block_size=BS, n_blocks=10, prefix_caching=False),
        [[(p, dict(max_new_tokens=12)) for p in _prompts(4, 16, 9)]])
    for layout, kv_dtype in (("paged", "int8"), ("slot", "bf16")):
        out[f"gqa-{layout}-{kv_dtype}"] = (
            "gqa", dict(n_slots=4, max_len=32, kv_layout=layout,
                        block_size=BS, kv_dtype=kv_dtype), greedy)
    return out


def sampled_case():
    """The reference's seeded-stochastic mix, held against the port's own
    single-device engine (the two packages draw from different
    generators)."""
    return ("dense", dict(n_slots=4, max_len=32, kv_layout="paged",
                          block_size=BS),
            [[(p, dict(max_new_tokens=GEN, temperature=t, top_k=k, seed=s))
              for p, (t, k, s) in zip(_prompts(3, 12, 1),
                                      [(0.0, 0, 0), (0.0, 0, 0),
                                       (1.0, 8, 5)])]])


def spec_cases() -> dict:
    """name -> (target key, draft key, engine kwargs, waves): the
    reference's ``test_mesh_parity`` (``tests/test_speculative.py``) on the
    mesh, on the greedy wave of ``cases()`` (whose plain streams its
    "dense-slot-bf16" case holds): a dense target drafted by a model of
    other weights on the slot layout (rejections, k shrinking), and by
    itself on the paged layout (every draft accepted, k growing)."""
    greedy = cases()["dense-slot-bf16"][2]
    return {"spec-other-slot": ("dense", "other",
                                dict(n_slots=4, max_len=32), greedy),
            "spec-self-paged": ("dense", "dense",
                                dict(n_slots=4, max_len=32,
                                     kv_layout="paged", block_size=BS),
                                greedy)}


def drive_fleet(target, trace, clock):
    """``tests/test_torch_fleet.py``'s ``_drive``: submit ``trace`` in
    arrival order under the virtual ``clock`` (a one-element list),
    stepping the target and advancing the clock by FLEET_DT between
    submissions, then ``run()`` to the end; the finished streams by
    request id."""
    pending = sorted(trace, key=lambda t: t.arrival_s)
    i = 0
    while i < len(pending):
        while i < len(pending) and pending[i].arrival_s <= clock[0]:
            tr = pending[i]
            i += 1
            target.submit(tr.prompt, tr.sampling(), session=tr.session)
        if target.has_work:
            target.step()
        clock[0] += FLEET_DT
    target.run()
    return {r.request_id: list(r.tokens) for r in target.finished}


def fleet_summary(rs, streams) -> dict:
    """What the fleet decided: streams, homes, moves, routing terms."""
    st = rs.stats()
    return {"streams": streams, "home": dict(rs.home),
            "n_steals": rs.n_steals, "n_drains": rs.n_drains,
            "decisions_by": st["router"]["decisions_by"],
            "n_finished": [p["n_finished"] for p in st["replicas"]],
            "preemptions": [p["n_preemptions"] for p in st["replicas"]]}


def serve(engine, waves, sampling_cls, max_steps: int = 400):
    """Submit each wave once the engine drained the previous one; returns
    (token streams in submission order, each step's stats)."""
    reqs, plans = [], []
    for wave in waves:
        reqs += [engine.submit(p, sampling_cls(**kw)) for p, kw in wave]
        while engine.has_work and len(plans) < max_steps:
            plans.append(engine.step())
    return [list(r.tokens) for r in reqs], plans


def _coslice(placed, whole, rank: int, world: int) -> tuple[int, bool]:
    """(how many leaves are split, whether each is this rank's block of
    rows of the whole leaf: every buffer of a SparseWeight, the embedding
    and the head)."""
    import torch
    from repro_torch.models.sparse_serving import SparseWeight
    from repro_torch.parallel import RowShard

    pairs = [(placed[k], whole[k]) for k in ("embed", "lm_head")
             if k in whole]
    for plp, wlp in zip(placed["layers"], whole["layers"]):
        pairs += [(plp[k], wlp[k]) for k in wlp]
    n, ok = 0, True
    for p, w in pairs:
        if not isinstance(p, RowShard):
            continue
        n += 1
        if isinstance(w, SparseWeight):
            bufs = [(getattr(p.local, f), getattr(w, f))
                    for f in ("nm_values", "nm_meta", "o_values", "o_meta",
                              "v_scale") if getattr(w, f) is not None]
        else:
            bufs = [(p.local, w)]
        for lb, wb in bufs:
            rows = wb.shape[0] // world
            ok &= lb.shape[0] == rows and torch.equal(
                lb, wb.narrow(0, rank * rows, rows))
    return n, bool(ok)


def _run_case(cfg, params, mesh, kw, waves, rank, world):
    from repro_torch.serving import SamplingParams, ServingEngine
    engine = ServingEngine(cfg, params, device="cpu", mesh=mesh, **kw)
    pool = engine.pool.blocks if kw["kv_layout"] == "paged" else engine.pool
    arena, ptr = pool.k, pool.k.data_ptr()
    streams, plans = serve(engine, waves, SamplingParams)
    st = engine.stats()
    # the arenas were written in place, on their head-split layout; the
    # scheduling state the steps ship (positions, block tables) is host
    # numpy, whole on every rank
    host = [engine.pool.pos.tolist()]
    if kw["kv_layout"] == "paged":
        host.append(engine.pool._bt_np.tolist())
    return {"streams": streams, "plans": plans, "pool": st["pool"],
            "placement": st["placement"],
            "n_preemptions": engine.n_preemptions,
            "arena_heads": pool.k.shape[-2],
            "scale_heads": None if pool.k_scale is None
            else pool.k_scale.shape[-1],
            "coslice": _coslice(engine.params, params, rank, world),
            "in_place": pool.k is arena and pool.k.data_ptr() == ptr
            and bool(pool.k.abs().sum() > 0),
            "host": host}


def _cli(mesh_args: list, trace: str, trace_out: str, too_large) -> dict:
    """``launch/serve`` with ``mesh_args`` replaying ``trace`` on this
    rank, as under ``torchrun``: (what it printed, the finished streams,
    the world-size error ``too_large()`` raises)."""
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve.main(["--arch", "llama-paper", "--smoke-arch", "--device",
                          "cpu", "--kv-layout", "paged",
                          "--block-size", "8", "--trace", trace, "--max-len",
                          "32", "--time-scale", "0.05", "--trace-out",
                          trace_out] + mesh_args)
    try:
        too_large()
        error = None
    except ValueError as e:
        error = str(e)
    return {"stdout": buf.getvalue(), "error": error,
            "streams": sorted((r.request_id, list(r.tokens))
                              for r in res["finished"])}


def _spec_case(cfgs, params, mesh, tkey, dkey, kw, waves, rank, world):
    """A speculative engine on the mesh: its streams, drafted and accepted
    counts, the drafter's placed params and arena heads."""
    from repro_torch.serving import (SamplingParams, ServingEngine,
                                     SpeculativeConfig)
    draft = SpeculativeConfig(k=SPEC_K, method="model", params=params[dkey],
                              cfg=cfgs[dkey])
    engine = ServingEngine(cfgs[tkey], params[tkey], device="cpu", mesh=mesh,
                           draft=draft, **kw)
    streams, plans = serve(engine, waves, SamplingParams)
    drafter = engine.spec.drafter.adapter
    return {"streams": streams, "plans": plans,
            "drafted": engine.n_drafted, "accepted": engine.n_accepted,
            "draft_coslice": _coslice(drafter.params, params[dkey], rank,
                                      world),
            "draft_arena_heads": drafter.pool.k.shape[-2]}


def _fleet(cfgs, params, world: int) -> dict:
    """Two replicas of 1 x world/2 over disjoint slices, driven by the
    fleet trace under a virtual clock; the slices and every decision."""
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.serving import ReplicaSet, fleet_trace
    meshes = make_replica_meshes(f"1x{world // 2}", 2, "cpu")
    clock = [0.0]
    rs = ReplicaSet(cfgs["dense"], params["dense"], meshes=meshes,
                    clock=lambda: clock[0], device="cpu", **FLEET_KW)
    out = fleet_summary(rs, drive_fleet(rs, fleet_trace(**FLEET_TRACE),
                                        clock))
    out["slices"] = [m.mesh.flatten().tolist() for m in meshes]
    out["own"] = rs.own_replica
    st = rs.stats()
    out["critical_path_s"] = (st["critical_path_s"], max(st["busy_s"])
                              + st["router_busy_s"])
    try:
        make_replica_meshes("1x1", world + 1, "cpu")
        out["too_large"] = None
    except ValueError as e:
        out["too_large"] = str(e)
    return out


def rank_main(rank: int, world: int, store: str, cfgs: dict, params: dict,
              out_dir: str) -> None:
    """One rank: join the group, serve every case on the mesh and the CLI
    on its trace, save."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        from repro_torch.launch.mesh import (make_replica_meshes,
                                             make_serving_mesh)
        from repro_torch.serving import SamplingParams, ServingEngine
        out = pathlib.Path(out_dir)
        mesh = make_serving_mesh(f"1x{world}", "cpu")
        res = {name: _run_case(cfgs[key], params[key], mesh, kw, waves,
                               rank, world)
               for name, (key, kw, waves) in cases().items()}
        key, kw, waves = sampled_case()
        res["sampled"] = _run_case(cfgs[key], params[key], mesh, kw, waves,
                                   rank, world)
        if rank == 0:
            solo = ServingEngine(cfgs[key], params[key], device="cpu", **kw)
            res["sampled_solo"] = serve(solo, waves, SamplingParams)[0]
        for name, (tkey, dkey, kw, waves) in spec_cases().items():
            res[name] = _spec_case(cfgs, params, mesh, tkey, dkey, kw, waves,
                                   rank, world)
        res["fleet"] = _fleet(cfgs, params, world)
        res["cli"] = _cli(["--mesh", f"1x{world}"], str(out / "trace.json"),
                          str(out / "trace_out.json"),
                          lambda: make_serving_mesh(f"1x{2 * world}", "cpu"))
        res["cli_fleet"] = _cli(
            ["--replicas", "2", "--mesh", f"1x{world // 2}"],
            str(out / "trace.json"), str(out / "fleet_trace_out.json"),
            lambda: make_replica_meshes(f"1x{world}", 2, "cpu"))
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def port_cfg(key: str):
    import torch
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke("llama-paper"),
                               name="mesh-serving-test", dtype=torch.float32,
                               n_kv_heads=KV_HEADS[key], **SHAPE)


# --------------------------------------------------------------------------
# the other families (ssm, hybrid, moe, encdec)
# --------------------------------------------------------------------------

# name -> (arch, config overrides): the smoke twins, and zamba2's with a
# 64-wide SSM head (2 heads), whose state splits its P columns on 1x4
FAMILY_MODELS = {"xlstm": ("xlstm-350m", {}),
                 "zamba2": ("zamba2-2.7b", {}),
                 "zamba2-p": ("zamba2-2.7b", {"ssm_head_dim": 64}),
                 "mixtral": ("mixtral-8x7b", {}),
                 "maverick": ("llama4-maverick-400b-a17b", {}),
                 "whisper": ("whisper-medium", {})}
F_GEN, F_PLEN, F_CTX = 5, 12, 7
F_ENGINE = dict(n_slots=4, max_len=F_PLEN + F_GEN, token_budget=8)


def family_cases() -> dict:
    """name -> (model, weights ("dense" or "sparse"), engine kwargs, whether
    to preempt, the requests' encoder features or None): the reference's
    family engine cases (``tests/test_family_engines.py``) on a mesh: the
    ssm family on the slot layout and with a swap preemption, the hybrid
    on both layouts and its P-mode twin, moe on the paged layout and
    llama4's shared expert, and whisper with its encoder features and a
    swap preemption."""
    paged = dict(kv_layout="paged", block_size=4)
    rng = np.random.default_rng(7)
    frames = [rng.standard_normal((F_CTX - i, 64)).astype(np.float32)
              for i in range(3)]
    return {"xlstm-slot": ("xlstm", "sparse", {}, False, None),
            "xlstm-swap": ("xlstm", "dense", {}, True, None),
            "zamba2-slot": ("zamba2", "dense", {}, False, None),
            "zamba2-paged": ("zamba2", "sparse", paged, False, None),
            "zamba2-p-slot": ("zamba2-p", "dense", {}, True, None),
            "mixtral-paged": ("mixtral", "dense", paged, False, None),
            "maverick-slot": ("maverick", "sparse", {}, False, None),
            "whisper-swap": ("whisper", "dense", dict(max_ctx=F_CTX), True,
                             frames)}


def family_prompts(vocab: int) -> list:
    """The three prompts every family case serves."""
    return np.random.default_rng(11).integers(0, vocab,
                                              (3, F_PLEN)).tolist()


def serve_family(engine, prompts, sampling_cls, preempt: bool, embeds=None,
                 on_step=None, max_steps: int = 200):
    """Submit every prompt, step to the end, and with ``preempt`` preempt
    one request (``engine._preempt_one``) after the first step that leaves
    a running request with a token, as the reference's
    ``test_preempt_resume_exact`` does; returns (streams, plans)."""
    embeds = embeds or [None] * len(prompts)
    reqs = [engine.submit(p, sampling_cls(max_new_tokens=F_GEN), embeds=e)
            for p, e in zip(prompts, embeds)]
    plans = []
    while engine.has_work and len(plans) < max_steps:
        plans.append(engine.step())
        if on_step is not None:
            on_step()
        if preempt and any(r.tokens for r in engine.running.values()):
            engine._preempt_one({"preempted": 0})
            preempt = False
    return [list(r.tokens) for r in reqs], plans


def kv_arena(pool):
    """The K arena of a KV pool (slot or paged), or of a hybrid pool's."""
    pool = getattr(pool, "kv", pool)
    return pool.blocks.k if hasattr(pool, "blocks") else pool.k


def state_pool(engine):
    """The recurrent-state pool of an ssm or hybrid engine, else None."""
    pool = engine.pool
    pool = getattr(pool, "state", pool)
    return pool if hasattr(pool, "shards") else None


def _experts(placed, whole, rank: int, world: int) -> list:
    """(name, local shape, whether it is this rank's last-dim block of the
    whole stack) of every expert stack, and each shared-expert leaf's
    (name, local rows, whether its rows are the rank's)."""
    import torch
    from repro_torch.parallel import ColShard, RowShard
    out = []
    for plp, wlp in zip(placed["layers"], whole["layers"]):
        pm, wm = plp["moe"], wlp["moe"]
        for k in sorted(wm):
            p, w = pm[k], wm[k]
            if isinstance(p, ColShard):
                n = w.shape[-1] // world
                out.append((k, tuple(p.local.shape), bool(torch.equal(
                    p.local, w.narrow(-1, rank * n, n)))))
            elif isinstance(p, RowShard):
                out.append((k, "rows", True))
            else:
                out.append((k, None, p is w))
    return out


def family_rank_main(rank: int, world: int, store: str, models: dict,
                     out_dir: str) -> None:
    """One rank: join the group, serve every family case on the 1 x world
    mesh counting its collectives, save what it saw to
    ``<out_dir>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        from repro_torch.launch.mesh import make_serving_mesh
        from repro_torch.models import moe
        from repro_torch.parallel import ModelAxis
        from repro_torch.serving import SamplingParams, ServingEngine
        calls = [0]
        gather, total = ModelAxis.gather, ModelAxis.sum

        def counted(fn):
            def wrapper(self, *a, **kw):
                calls[0] += 1
                return fn(self, *a, **kw)
            return wrapper
        ModelAxis.gather, ModelAxis.sum = counted(gather), counted(total)
        moe_calls, local = [], moe._moe_local

        def moe_local(*a, **kw):
            before = calls[0]
            out = local(*a, **kw)
            moe_calls.append(calls[0] - before)
            return out
        moe._moe_local = moe_local
        mesh = make_serving_mesh(f"1x{world}", "cpu")
        res = {}
        for name, (key, which, kw, preempt, embeds) in \
                family_cases().items():
            cfg, weights = models[key]
            params = weights[which]
            engine = ServingEngine(cfg, params, device="cpu", mesh=mesh,
                                   **F_ENGINE, **kw)
            per_step = []
            mark = [calls[0]]

            def on_step():
                per_step.append(calls[0] - mark[0])
                mark[0] = calls[0]
            del moe_calls[:]
            streams, plans = serve_family(
                engine, family_prompts(cfg.vocab), SamplingParams, preempt,
                embeds, on_step)
            st, sp = engine.stats(), state_pool(engine)
            out = {"streams": streams, "plans": plans, "pool": st["pool"],
                   "placement": st["placement"],
                   "n_preemptions": engine.n_preemptions,
                   "collectives_per_step": per_step,
                   "moe_collectives": list(moe_calls)}
            if sp is not None:
                out["states"] = [[None if a is None else a.clone()
                                  for a in layer] for layer in sp.states]
                out["modes"] = [s.mode for s in sp.shards]
            if cfg.family != "ssm":
                out["arena_heads"] = kv_arena(engine.pool).shape[-2]
            if cfg.family == "encdec":
                ctx = engine.adapter.ctx
                out["ctx_heads"] = (ctx.ck.shape[-2], ctx.cv.shape[-2])
            if cfg.family == "moe":
                out["experts"] = _experts(engine.params, params, rank, world)
            res[name] = out
        torch.save(res, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def family_cfg(key: str):
    """The port's f32 config of a family model."""
    import torch
    from repro_torch import configs
    arch, over = FAMILY_MODELS[key]
    return dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32,
                               remat=False, **over)
