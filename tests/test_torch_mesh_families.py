"""Every engine-served family on a mesh: ``ServingEngine(mesh=)`` serving
the ssm (xlstm-350m), hybrid (zamba2-2.7b and a twin with 64-wide SSM
heads), moe (mixtral-8x7b, llama4-maverick's shared expert) and encdec
(whisper-medium) smoke twins on gloo meshes of 1x2 and 1x4 ranks, against
the JAX package's single-device engine on the same weights.

The properties are the reference's (``tests/test_family_engines.py``'s
``test_mesh_recurrent_state_shardings`` and
``test_mesh_family_engine_token_identical``) and its placement policy's:
  * every rank's greedy streams equal the JAX single-device engine's at
    f32, swap preemptions and encoder features included;
  * every state leaf a rank holds is its block, by the reference's
    ``ServingPlacement.state_spec`` on the whole leaf's shape, of the
    port's single-device engine's final state, and each recurrent family
    splits at least one leaf of ndim >= 4.  The block is the
    single-device one bit for bit where the rank's products have the
    whole products' shapes but fewer of them (zamba2's heads), and to
    f32 rounding (rtol 1e-4, atol 1e-5) in two cases where the CPU's f32
    GEMM sums in another order at the rank's narrower shape: the
    reference's ``w_gate`` pattern also splits xlstm's [2H, di]
    ``w_gates`` (4 rows at the smoke twin's H 2) into 2 or 1 rows a rank,
    and a decode step's one query row against a rank's 16 of 64 SSM value
    columns (the twin on 1x4) takes another kernel than against all 64.
    No partial sum crosses ranks in either; the streams stay identical;
  * expert stacks are split on their last dim (each rank's block of the
    whole stack), and a MoE layer issues two collectives for its routed
    experts on every rank whatever the routing;
  * hybrid KV arenas and the enc-dec context rows hold KV/ranks heads when
    those divide the ranks;
  * the ranks' step plans and collectives a step are equal.
The two worlds reach every branch of ``state_spec`` on these configs:
xlstm's 2 heads split on 1x2 and its value columns on 1x4 (the sLSTM
carries whole), zamba2's 8 heads on both, the twin's 2 heads on 1x2 and
its P columns on 1x4.

Each world is one spawn of ``torch.multiprocessing`` processes importing
only torch and the port (``tests/torch_mesh_worker.py``), with a spawn
deadline and a gloo timeout, so a lockstep break fails instead of hanging.
This file holds the 1x2 world; ``test_torch_mesh_families_1x4.py`` runs
the same tests on 1x4, so ``--dist loadfile`` can put them on two
workers.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.placement import \
    ServingPlacement as JaxPlacement  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.serving import SamplingParams, ServingEngine  # noqa: E402

CASES = worker.family_cases()
SPAWN_DEADLINE_S = 100
# the state split each recurrent model reaches on each world
MODES = {2: {"xlstm": {"heads"}, "zamba2": {"heads"},
             "zamba2-p": {"heads"}},
         4: {"xlstm": {"dv", "whole"}, "zamba2": {"heads"},
             "zamba2-p": {"dv"}}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so several test workers on one machine do not
    oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The mesh's model-axis size (``test_torch_mesh_families_1x4.py``
    overrides it)."""
    return 2


def _jax_cfg(key):
    arch, over = worker.FAMILY_MODELS[key]
    return dataclasses.replace(jax_configs.get_smoke(arch),
                               dtype=jnp.float32, remat=False, **over)


@pytest.fixture(scope="module")
def models():
    """{model: (JAX cfg, port cfg, {weights: (JAX params, port
    params)})}: dense and 8:16 + 16:256 weights from one seed."""
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    used = {(key, which) for key, which, *_ in CASES.values()}
    out = {}
    for i, key in enumerate(worker.FAMILY_MODELS):
        jcfg = _jax_cfg(key)
        dense = jax_get_model(jcfg).init(jax.random.PRNGKey(70 + i))
        weights = {"dense": dense}
        if (key, "sparse") in used:
            weights["sparse"], _ = jax_sparsify(dense, scfg)
        out[key] = (jcfg, worker.family_cfg(key),
                    {w: (p, from_jax_params(p, "cpu"))
                     for w, p in weights.items()})
    return out


def _case_args(models, name):
    key, which, kw, preempt, embeds = CASES[name]
    jcfg, cfg, weights = models[key]
    jparams, params = weights[which]
    return jcfg, jparams, cfg, params, kw, preempt, embeds


@pytest.fixture(scope="module")
def jax_runs(models):
    """{case: (streams, preemptions)} of the JAX single-device engine."""
    out = {}
    for name in CASES:
        jcfg, jparams, cfg, _, kw, preempt, embeds = _case_args(models, name)
        engine = JaxServingEngine(jcfg, jparams, **worker.F_ENGINE, **kw)
        streams, _ = worker.serve_family(
            engine, worker.family_prompts(cfg.vocab), JaxSamplingParams,
            preempt, embeds)
        out[name] = (streams, engine.n_preemptions)
    return out


@pytest.fixture(scope="module")
def solo_states(models):
    """{case: the port's single-device engine's final state arenas} of the
    recurrent cases."""
    out = {}
    for name in CASES:
        _, _, cfg, params, kw, preempt, embeds = _case_args(models, name)
        if cfg.family not in ("ssm", "hybrid"):
            continue
        engine = ServingEngine(cfg, params, device="cpu", **worker.F_ENGINE,
                               **kw)
        worker.serve_family(engine, worker.family_prompts(cfg.vocab),
                            SamplingParams, preempt, embeds)
        out[name] = worker.state_pool(engine).states
    return out


@pytest.fixture(scope="module")
def mesh_spawn(models, world, tmp_path_factory):
    """The 1 x ``world`` ranks, started: (their context, their directory,
    the deadline).  They serve while the parent computes the JAX and
    single-device runs; ranks still alive at teardown are killed."""
    d = tmp_path_factory.mktemp(f"families{world}")
    port = {key: (cfg, {w: p for w, (_, p) in weights.items()})
            for key, (_, cfg, weights) in models.items()}
    ctx = tmp.start_processes(
        worker.family_rank_main,
        args=(world, str(d / "store"), port, str(d)), nprocs=world,
        join=False, start_method="spawn")
    yield ctx, d, time.monotonic() + SPAWN_DEADLINE_S
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join(5)


@pytest.fixture(scope="module")
def mesh_run(mesh_spawn, jax_runs, solo_states, world):
    """Each rank's saved results on the 1 x ``world`` mesh, once the
    reference runs are done; ranks still running at the deadline fail
    the run (a lockstep break would otherwise hang)."""
    ctx, d, deadline = mesh_spawn
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{world} ranks still running after "
                               f"{SPAWN_DEADLINE_S}s")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _jax_placement(cfg, world):
    """The reference's placement on a stand-in 1 x ``world`` mesh (one
    device repeated: its specs need only the axis sizes)."""
    devs = np.array(jax.devices() * world)[:world].reshape(1, world)
    return JaxPlacement(jax.sharding.Mesh(devs, ("data", "model")), cfg)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_family_streams_equal_jax(mesh_run, jax_runs, world, case):
    """Every rank's greedy streams equal the JAX single-device engine's;
    the swap cases preempt where the JAX engine does."""
    streams, jpre = jax_runs[case]
    for r, res in enumerate(mesh_run):
        assert res[case]["streams"] == streams, (world, r)
        assert res[case]["n_preemptions"] == jpre
    if CASES[case][3]:
        assert jpre == 1


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_family_ranks_in_lockstep(mesh_run, world, case):
    """Every rank planned the same steps and issued the same collectives
    each step, and ``stats()["placement"]`` describes the mesh."""
    first = mesh_run[0][case]
    assert len(first["plans"]) > 0
    assert sum(first["collectives_per_step"]) > 0
    for res in mesh_run:
        got = res[case]
        assert got["plans"] == first["plans"]
        assert got["collectives_per_step"] == first["collectives_per_step"]
        assert got["placement"] == {"devices": world,
                                    "mesh": {"data": 1, "model": world}}


@pytest.mark.parametrize("case", [c for c, (key, *_) in CASES.items()
                                  if key in MODES[2]])
def test_mesh_state_leaves_are_blocks_by_reference_spec(mesh_run, models,
                                                        solo_states, world,
                                                        case):
    """Each state leaf a rank holds is its block, by the reference's
    ``state_spec`` on the whole leaf, of the single-device engine's final
    leaf (bit for bit, or to f32 rounding where the module docstring
    says); at least one leaf of ndim >= 4 splits; the layers' splits are
    the ones this world reaches."""
    key = CASES[case][0]
    jpl = _jax_placement(models[key][0], world)
    n_split4 = 0
    for r, res in enumerate(mesh_run):
        got = res[case]
        assert set(got["modes"]) == MODES[world][key]
        exact = key != "xlstm" and "dv" not in got["modes"]
        for layer, whole_layer in zip(got["states"], solo_states[case]):
            for leaf, whole in zip(layer, whole_layer):
                if whole is None:
                    assert leaf is None
                    continue
                spec = tuple(jpl.state_spec(whole.shape))
                want = whole
                for dim, axis in enumerate(spec):
                    if axis is not None:
                        n = whole.shape[dim] // world
                        want = want.narrow(dim, r * n, n)
                        n_split4 += whole.ndim >= 4
                assert leaf.shape == want.shape, (spec, r)
                if exact:
                    assert torch.equal(leaf, want), (spec, r)
                else:
                    torch.testing.assert_close(leaf, want, rtol=1e-4,
                                               atol=1e-5)
    assert n_split4 > 0


@pytest.mark.parametrize("case", [c for c, (key, *_) in CASES.items()
                                  if key in ("mixtral", "maverick")])
def test_mesh_experts_split_on_last_dim(mesh_run, world, case):
    """Each expert stack is the rank's last-dim block of the whole stack,
    the router stays whole, the shared expert splits its rows; every MoE
    layer call issued exactly two collectives for its routed experts on
    every rank, whatever the routing."""
    for res in mesh_run:
        got = res[case]
        names = {name for name, *_ in got["experts"]}
        for name, shape, ok in got["experts"]:
            assert ok, name
            if name.startswith("we_"):
                assert shape is not None and shape[-1] in (
                    128 // world, 64 // world), (name, shape)
            elif name == "router":
                assert shape is None
            else:
                assert shape == "rows", name
        assert ("ws_up" in names) == (case == "maverick-slot")
        assert got["moe_collectives"] and \
            set(got["moe_collectives"]) == {2}
        assert got["moe_collectives"] == mesh_run[0][case]["moe_collectives"]


@pytest.mark.parametrize("case", [c for c, (key, *_) in CASES.items()
                                  if key not in ("xlstm",)])
def test_mesh_arenas_and_context_rows_hold_rank_heads(mesh_run, models,
                                                      world, case):
    """KV arenas (the hybrid's shared attention, moe's, the enc-dec
    decoder's) and the enc-dec context rows hold KV/ranks heads when the
    KV heads divide the ranks, all of them otherwise."""
    cfg = models[CASES[case][0]][1]
    kv = cfg.n_kv_heads
    heads = kv // world if kv % world == 0 else kv
    for res in mesh_run:
        got = res[case]
        assert got["arena_heads"] == heads
        if cfg.family == "encdec":
            assert got["ctx_heads"] == (heads, heads)
