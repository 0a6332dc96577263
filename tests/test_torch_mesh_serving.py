"""Mesh-native serving of the port: ``ServingEngine(mesh=)`` on gloo meshes
of 1x4 and 1x8 ranks against the JAX package's single-device engine.

The property is the reference's (``tests/test_mesh_serving.py``): the
sharded engine's greedy token streams are identical to the single-device
engine's, at f32.  Tolerance: token identity; the pool's stats equal the
JAX engine's (its arrays are global, the port's arenas a rank's heads);
the ranks' step plans equal each other's, step by step.

Each mesh is one spawn of ``torch.multiprocessing`` processes that import
only torch and the port (``tests/torch_mesh_worker.py``), joined through
a ``file://`` store under the test's temporary directory, so test workers
never clash on a port; every case runs in that one spawn.  The parent
computes the JAX engine's streams on the reference's config (8 KV heads)
and on a GQA twin whose 2 KV heads divide neither mesh (arenas
replicated).  Cases: dense and 8:16 + 16:256, slot and paged KV, bf16
and int8 KV (every pair of the three in four runs), prefix-cache hits,
preemption and resume, GQA on both layouts; a seeded-stochastic mix held
against the port's own single-device engine; and ``serve --mesh`` as
``torchrun`` would start it, replaying a Poisson trace.

The same spawns hold speculation and the fleet on meshes (ROADMAP A12b):
``ServingEngine(mesh=, draft=)`` against the JAX single-device
speculative and plain engines (the reference's ``test_mesh_parity``:
streams, drafted and accepted counts; the draft params are each rank's
rows and its arena KV/ranks heads); ``ReplicaSet(meshes=
make_replica_meshes("1xW/2", 2))`` against the JAX one-process fleet on
a trace with steals and a drain (every rank's homes, moves, routing terms
and streams); and ``serve --replicas 2 --mesh 1xW/2``.
Also checked: each rank's arenas hold KV/ranks heads (all KV when they do
not divide), each rank's ``SparseWeight`` buffers are its co-sliced rows
of the whole container, and ``stats()["placement"]``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro import serving as jax_serving  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import poisson_trace, save_trace  # noqa: E402

CASES = worker.cases()
SPEC_CASES = worker.spec_cases()
WORLDS = (4, 8)
# a spawn also serves speculation, a fleet and two CLI replays: the 1x8
# one took 76 s inside a whole six-worker run
SPAWN_DEADLINE_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so several test workers on one machine do not
    oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(key):
    return dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                               name="mesh-serving-test", remat=False,
                               dtype=jnp.float32,
                               n_kv_heads=worker.KV_HEADS[key],
                               **worker.SHAPE)


@pytest.fixture(scope="module")
def models():
    """{key: (JAX cfg, JAX params, port cfg, port params)}."""
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), _jax_cfg("dense"))
    sparse, _ = jax_sparsify(dense, JaxSparsifyConfig(
        weight_pattern="8:16", outlier_pattern="16:256", scorer="magnitude",
        use_smoothquant=False))
    gqa = jax_tfm.init_params(jax.random.PRNGKey(0), _jax_cfg("gqa"))
    other = jax_tfm.init_params(jax.random.PRNGKey(7), _jax_cfg("other"))
    return {key: (_jax_cfg(key), p, worker.port_cfg(key),
                  from_jax_params(p, device="cpu"))
            for key, p in (("dense", dense), ("sparse", sparse),
                           ("gqa", gqa), ("other", other))}


@pytest.fixture(scope="module")
def jax_runs(models):
    """{case: (streams, pool stats, preemptions)} of the JAX single-device
    engine."""
    out = {}
    for name, (key, kw, waves) in CASES.items():
        jcfg, jparams = models[key][:2]
        engine = JaxServingEngine(jcfg, jparams, **kw)
        streams, _ = worker.serve(engine, waves, JaxSamplingParams)
        out[name] = (streams, engine.stats()["pool"], engine.n_preemptions)
    return out


@pytest.fixture(scope="module")
def jax_spec_runs(models):
    """{case: (streams, drafted, accepted)} of the JAX single-device
    speculative engine."""
    out = {}
    for name, (tkey, dkey, kw, waves) in SPEC_CASES.items():
        jcfg, jparams = models[tkey][:2]
        draft = jax_serving.SpeculativeConfig(
            k=worker.SPEC_K, method="model", params=models[dkey][1],
            cfg=models[dkey][0])
        spec = JaxServingEngine(jcfg, jparams, draft=draft, **kw)
        streams, _ = worker.serve(spec, waves, JaxSamplingParams)
        out[name] = (streams, spec.n_drafted, spec.n_accepted)
    return out


@pytest.fixture(scope="module")
def jax_fleet(models):
    """The JAX one-process fleet on the fleet trace (no meshes, the same
    virtual clock): its decisions and streams."""
    jcfg, jparams = models["dense"][:2]
    clock = [0.0]
    rs = jax_serving.ReplicaSet(jcfg, jparams, clock=lambda: clock[0],
                                **worker.FLEET_KW)
    streams = worker.drive_fleet(
        rs, jax_serving.fleet_trace(**worker.FLEET_TRACE), clock)
    return worker.fleet_summary(rs, streams)


def _spawn(world, models, tmp_path_factory):
    """Run ``worker.rank_main`` on ``world`` ranks; returns each rank's
    saved results.  Ranks still running at the deadline are killed and
    the run fails (a lockstep break would otherwise hang)."""
    d = tmp_path_factory.mktemp(f"mesh{world}")
    save_trace(str(d / "trace.json"), poisson_trace(
        n_requests=6, rate_per_s=4, vocab=512, prompt_len=(8, 16),
        max_new_tokens=6, seed=3))
    cfgs = {k: v[2] for k, v in models.items()}
    params = {k: v[3] for k, v in models.items()}
    ctx = tmp.start_processes(
        worker.rank_main, args=(world, str(d / "store"), cfgs, params,
                                str(d)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{SPAWN_DEADLINE_S}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return d, [torch.load(d / f"rank{r}.pt", weights_only=False)
               for r in range(world)]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"1x{w}")
def mesh_run(request, models, tmp_path_factory):
    d, ranks = _spawn(request.param, models, tmp_path_factory)
    return request.param, ranks, d


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_token_identical_to_jax(mesh_run, jax_runs, case):
    """Every rank's greedy streams equal the JAX single-device engine's;
    prefix hits and preemptions happen where the JAX engine's do."""
    world, ranks, _ = mesh_run
    streams, jpool, jpre = jax_runs[case]
    for r, res in enumerate(ranks):
        assert res[case]["streams"] == streams, (world, r)
        assert res[case]["n_preemptions"] == jpre
    if case == "prefix-hits":
        assert jpool["prefix_cache"]["hit_tokens"] >= 2 * 3 * worker.BS
    if case == "preemption":
        assert jpre > 0


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_pool_stats_and_placement(mesh_run, jax_runs, models, case):
    """``stats()["pool"]`` of every rank equals the JAX engine's (whole-
    arena bytes, occupancy, prefix cache), and ``stats()["placement"]``
    describes the mesh."""
    world, ranks, _ = mesh_run
    jpool = jax_runs[case][1]
    for res in ranks:
        assert res[case]["pool"] == jpool
        assert res[case]["placement"] == {
            "devices": world, "mesh": {"data": 1, "model": world}}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_arenas_weights_and_plans(mesh_run, models, case):
    """Each rank's arenas (and int8 scales) hold KV/ranks heads, or all KV
    heads when those do not divide the ranks, and were written in place
    (the contract of the reference's ``step_fn_shardings``: donated arenas
    keep their head-sharded layout); the host vectors the steps ship
    (positions, block tables) are whole and equal on every rank; each
    rank's split leaves are its co-sliced rows (a SparseWeight's five
    buffers together); every rank planned the same steps."""
    world, ranks, _ = mesh_run
    key, kw, _ = CASES[case]
    kv = models[key][2].n_kv_heads
    heads = kv // world if kv % world == 0 else kv
    for res in ranks:
        got = res[case]
        assert got["arena_heads"] == heads
        if kw.get("kv_dtype") == "int8":
            assert got["scale_heads"] == heads
        n_split, coslice = got["coslice"]
        # embed, lm_head and 7 projections a layer split on their rows
        assert n_split == 2 + 7 * 2 and coslice
        assert got["plans"] == ranks[0][case]["plans"]
        assert len(got["plans"]) > 0
        assert got["in_place"]
        assert got["host"] == ranks[0][case]["host"]


def test_mesh_sampled_streams_equal_single_device(mesh_run):
    """A seeded temperature/top-k request beside two greedy ones: the mesh
    engine's streams are the port's single-device engine's."""
    _, ranks, _ = mesh_run
    for res in ranks:
        assert res["sampled"]["streams"] == ranks[0]["sampled_solo"]


def test_serve_cli_on_the_mesh(mesh_run):
    """``serve --mesh 1xW --trace ...`` on every rank, as under torchrun:
    each rank finishes the trace with the same streams (arrivals fall due
    by rank 0's clock), only rank 0 prints and writes ``--trace-out``, and
    a mesh twice the world size raises naming the world size."""
    world, ranks, d = mesh_run
    cli = [res["cli"] for res in ranks]
    assert len(cli[0]["streams"]) == 6
    assert all(c["streams"] == cli[0]["streams"] for c in cli)
    assert "serving mesh: {'data': 1, 'model': %d}" % world in cli[0]["stdout"]
    assert "trace written to" in cli[0]["stdout"]
    assert all(c["stdout"] == "" for c in cli[1:])
    assert (d / "trace_out.json").exists()
    assert all(f"world size {world}" in c["error"] for c in cli)


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_mesh_speculation_token_identical_to_jax(mesh_run, jax_spec_runs,
                                                 jax_runs, models, case):
    """The reference's ``test_mesh_parity`` on 1x4 and 1x8: every rank's
    speculative streams equal the JAX single-device speculative engine's
    and the JAX plain engine's (the "dense-slot-bf16" case's, on the same
    requests), with JAX's drafted and accepted counts; the draft params
    are each rank's co-sliced rows, its arena holds KV/ranks heads, and
    every rank planned the same steps."""
    world, ranks, _ = mesh_run
    streams, drafted, accepted = jax_spec_runs[case]
    assert streams == jax_runs["dense-slot-bf16"][0]
    dkey = SPEC_CASES[case][1]
    for r, res in enumerate(ranks):
        got = res[case]
        assert got["streams"] == streams, (world, r)
        assert (got["drafted"], got["accepted"]) == (drafted, accepted)
        n_split, coslice = got["draft_coslice"]
        assert n_split == 2 + 7 * 2 and coslice
        assert got["draft_arena_heads"] == \
            models[dkey][2].n_kv_heads // world
        assert got["plans"] == ranks[0][case]["plans"]
    if dkey == "dense":                   # a self-draft: all accepted
        assert accepted == drafted > 0
    else:
        assert drafted > accepted


def test_replica_mesh_fleet_decisions_equal_jax(mesh_run, jax_fleet):
    """Two replicas of 1 x W/2 on disjoint slices that cover the world:
    every rank's homes, steals, drains, routing decisions by winning term
    and finished streams are equal, and equal to the JAX one-process
    fleet's on the same trace, with at least one steal and one drain;
    ``critical_path_s`` keeps the reference's formula; a world too small
    for the replicas' meshes raises naming its size."""
    world, ranks, _ = mesh_run
    half = world // 2
    assert jax_fleet["n_steals"] >= 1 and jax_fleet["n_drains"] >= 1
    assert len(jax_fleet["streams"]) == worker.FLEET_TRACE["n_requests"]
    for r, res in enumerate(ranks):
        got = dict(res["fleet"])
        assert got.pop("slices") == [list(range(half)),
                                     list(range(half, world))]
        assert got.pop("own") == r // half
        crit, formula = got.pop("critical_path_s")
        assert crit == pytest.approx(formula)
        assert f"world size {world}" in got.pop("too_large")
        assert got == jax_fleet, (world, r)


def test_serve_cli_fleet_on_replica_meshes(mesh_run):
    """``serve --replicas 2 --mesh 1xW/2 --trace ...`` on every rank, as
    under torchrun: every rank finishes the trace with the same streams,
    only world rank 0 prints (the ``fleet meshes`` line among it) and
    writes ``--trace-out``, and two replicas of a mesh as large as the
    world raise naming its size."""
    world, ranks, d = mesh_run
    cli = [res["cli_fleet"] for res in ranks]
    assert len(cli[0]["streams"]) == 6
    assert all(c["streams"] == cli[0]["streams"] for c in cli)
    assert all(c["streams"] == res["cli"]["streams"]
               for c, res in zip(cli, ranks))
    assert ("fleet meshes: 2 x {'data': 1, 'model': %d}" % (world // 2)
            in cli[0]["stdout"])
    assert "fleet[prefix]: 2 replicas" in cli[0]["stdout"]
    assert "trace written to" in cli[0]["stdout"]
    assert all(c["stdout"] == "" for c in cli[1:])
    assert (d / "fleet_trace_out.json").exists()
    assert all(f"world size {world}" in c["error"] for c in cli)


def test_parse_mesh_spec_and_refusals():
    """The reference's ``test_parse_mesh_spec`` and replica-mesh bounds
    (``tests/test_fleet.py``: ``n_replicas`` below 1; without a launcher,
    a fleet of replica meshes needs one process a rank, as ``--replicas 2
    --mesh 1x2`` does, and the production mesh's 256); and what
    is refused by design: ``--mesh`` with the one-shot loop (``--legacy``,
    the vlm family), which takes no mesh in the reference either."""
    assert tmesh.parse_mesh_spec(None) is None
    assert tmesh.parse_mesh_spec("") is None
    assert tmesh.parse_mesh_spec("1x8") == (1, 8)
    assert tmesh.parse_mesh_spec("8") == (1, 8)
    assert tmesh.parse_mesh_spec("2x4") == (2, 4)
    for bad in ("2x3x4", "banana", "0x8", "-1x8"):
        with pytest.raises(ValueError):
            tmesh.parse_mesh_spec(bad)
    assert tmesh.make_serving_mesh(None) is None
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.make_serving_mesh("4096", "cpu")    # no group, no launcher
    assert tmesh.make_replica_meshes(None, 3) == [None] * 3
    with pytest.raises(ValueError, match="n_replicas"):
        tmesh.make_replica_meshes(None, 0)
    with pytest.raises(ValueError, match="n_replicas"):
        tmesh.make_replica_meshes("1x2", 0)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        tmesh.make_replica_meshes("1x2", 2, "cpu")
    with pytest.raises(ValueError, match="256 ranks.*torchrun"):
        tmesh.make_production_mesh(device="cpu")    # no group, no launcher
    assert not tmesh.dist.is_initialized()
    base = ["--arch", "llama-paper", "--smoke-arch", "--device", "cpu",
            "--mesh", "1x2"]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        serve.main(base + ["--replicas", "2"])
    with pytest.raises(ValueError, match="one-shot loop .* takes no mesh"):
        serve.main(base + ["--legacy"])
    with pytest.raises(ValueError, match="one-shot loop .* takes no mesh"):
        serve.main(["--arch", "qwen2-vl-72b", "--smoke-arch", "--device",
                    "cpu", "--mesh", "1x2"])


def test_engine_without_mesh_and_mesh_refusals(models):
    """``mesh=None`` is the single-device engine and says so in
    ``stats()["placement"]``; on a mesh, a draft whose KV heads cannot
    follow the target's split raises naming both head counts before any
    tensor is placed; a mapping of axis sizes gives specs but places
    nothing, for an engine with or without a draft and for a moe fleet of
    replica meshes (``meshes=``) alike."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import (ReplicaSet, SamplingParams,
                                     ServingEngine, SpeculativeConfig)
    cfg, params = models["dense"][2:]
    engine = ServingEngine(cfg, params, device="cpu", n_slots=2, max_len=32)
    req = engine.submit(list(range(10)), SamplingParams(max_new_tokens=3))
    engine.run()
    assert len(req.tokens) == 3 and not engine.placement.active
    assert engine.stats()["placement"] == {"devices": 1, "mesh": None}
    sizes = {"data": 1, "model": 2}
    gqa_cfg, gqa_params = models["gqa"][2:]
    for model_n in (4, 8):
        with pytest.raises(ValueError, match="draft's 2 KV heads .* "
                           "target's split of its 8 KV heads"):
            ServingEngine(cfg, params, device="cpu",
                          mesh={"data": 1, "model": model_n},
                          draft=SpeculativeConfig(method="model",
                                                  params=gqa_params,
                                                  cfg=gqa_cfg))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServingEngine(cfg, params, device="cpu", mesh=sizes,
                      draft=SpeculativeConfig(method="ngram"))
    moe = dataclasses.replace(configs.get_smoke("mixtral-8x7b"),
                              dtype=torch.float32)
    moe_params = tfm.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ReplicaSet(moe, moe_params, n_replicas=2, meshes=[sizes, sizes],
                   device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServingEngine(cfg, params, device="cpu", mesh=sizes)
