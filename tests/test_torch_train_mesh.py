"""The training half of placement: the port's sharded train step,
expert-parallel MoE and checkpoints on gloo meshes of 2 and 4 ranks,
held against the JAX package's sharded step on meshes of the same shapes.

- The reference runs in one subprocess with 4 forced host devices
  (``tests/jax_train_mesh_reference.py``, ``AxisType.Auto`` meshes); the
  port's ranks run in two spawns (``tests/torch_train_mesh_worker.py``):
  2 ranks (2x1, 1x2) and 4 ranks (2x2, 4x1, 1x4), with a spawn deadline
  and a gloo timeout, so a lockstep break fails instead of hanging.
  Weights and batches are drawn once here and cross as numpy, at f32 on
  smoke twins.
- The sharded step (``launch/train.build(mesh=)``, 2 steps at lr 1e-3,
  one with int8 compression): every step's loss and gradient norm to
  ``LOSS_RTOL``; the gathered params and moments after the first step to
  ``PARAM_TOL`` except where Adam's sign-like first update may flip under
  roundoff, at most ``MAX_FLIP_SHARE`` of them
  (``tests/test_torch_train_driver.py`` sets out why); every block a rank
  holds is its spec's block of the gathered leaf.
- Expert-parallel MoE: the rank's outputs to atol 1e-5 and its dropped
  (token, choice) pairs equal to the reference's per shard.  The
  reference's ``_moe_ep`` reshapes the [D, E/D, C, d] buffers an owner
  receives into [E/D, D C, d] without a transpose, so with E/D > 1 it
  runs shard j's rows of expert i through another expert
  (``test_reference_ep_reshape_mixes_experts``); there the port is held
  to the reference's own dispatch, expert products and combine composed
  shard by shard, and the steps on 2 data shards use a 2-expert twin.
- Checkpoints cross 2x2 -> 1x4, the unplaced port and the JAX package
  bit for bit, and an unplaced save restores onto 2x1 as the blocks.
- ``launch/train.run`` on 2 ranks restarts both at the same step and
  leaves no process group behind.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_train_mesh_worker as worker  # noqa: E402
from repro.parallel import policy as jax_policy  # noqa: E402
from repro.runtime.checkpoint import \
    CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.interchange import from_jax_params, to_jax_layout  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import model_zoo, moe  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.parallel import policy  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.tree import flatten, unflatten, value_and_grad  # noqa: E402
from test_torch_train_driver import (GRAD_TOL, LOSS_RTOL,  # noqa: E402
                                     RECURRENT_GRAD_TOL,
                                     _assert_params_close, _near_half_step,
                                     _near_zero)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_DEADLINE_S = 150
MOE_ATOL = 1e-5
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so several test workers on one machine do not
    oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed) -> dict:
    """A train batch of ``input_specs``' shapes (B 4, S 16), drawn with
    numpy: tokens and labels in the vocab, ``embeds`` N(0, 1), M-RoPE
    positions in [0, 9)."""
    rng = np.random.default_rng(seed)
    out = {}
    specs = model_zoo.input_specs(cfg, ShapeConfig("t", worker.S, worker.B,
                                                   "train"))
    for name, (shape, _) in specs.items():
        if name == "embeds":
            out[name] = rng.standard_normal(shape).astype(np.float32)
        elif name == "positions":
            out[name] = rng.integers(0, 9, shape).astype(np.int32)
        else:
            out[name] = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    return out


def _np_jax_layout(tree):
    return jax.tree.map(lambda t: t.numpy(), to_jax_layout(tree))


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _driver_batches(cfg):
    args = train.parse_args(["--arch", "x"] + worker.DRIVER)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=args.seed)
    return [data.batch_at(i) for i in range(args.steps)]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The inputs both sides take: each step case's initial params (the
    port's draw) and batches, each MoE case's layer and tokens, and an
    unplaced checkpoint for the 2x1 restore."""
    d = tmp_path_factory.mktemp("train_mesh_job")
    out = {"params": {}, "batches": {}, "moe_params": {}, "x2": {},
           "ports": {k: _free_port() for k in worker.DRIVER_ARCHS}}
    for i, (name, (arch, over, *_)) in enumerate(worker.STEP_CASES.items()):
        cfg = worker.port_cfg(arch, over)
        out["params"][name] = model_zoo.get_model(cfg, "cpu").init(
            torch.Generator().manual_seed(10 + i))
        # a compressed case takes one step: its half-step rounding flips
        # move the params a quantization step before any second
        n = 1 if worker.STEP_CASES[name][4] else worker.N_STEPS
        out["batches"][name] = [_batch(cfg, 100 * i + s) for s in range(n)]
    for i, (name, (arch, over, _, T)) in enumerate(worker.MOE_CASES.items()):
        cfg = worker.port_cfg(arch, over)
        out["moe_params"][name] = moe.init_moe(
            cfg, torch.Generator().manual_seed(50 + i), "cpu")
        out["x2"][name] = np.random.default_rng(60 + i).standard_normal(
            (T, cfg.d_model)).astype(np.float32)
    cfg = worker.port_cfg("llama-paper", {})
    params = model_zoo.get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(7))
    opt = adamw_init(params, AdamWConfig())
    opt["m"] = unflatten(params, [p * 0.5 for p in flatten(params)])
    opt["v"] = unflatten(params, [p * p for p in flatten(params)])
    out["unplaced_state"] = {"params": params, "opt": opt}
    out["unplaced_dir"] = str(d / "unplaced")
    CheckpointManager(out["unplaced_dir"]).save(5, out["unplaced_state"])
    return out


@pytest.fixture(scope="module")
def jax_proc(job, tmp_path_factory):
    """The reference's subprocess, started: (process, its output path)."""
    d = tmp_path_factory.mktemp("train_mesh_jax")
    steps_in = {}
    for name, (arch, over, shape, mb, compress) in worker.STEP_CASES.items():
        steps_in[name] = (arch, over, shape, mb, compress, worker.LR,
                          _np_jax_layout(job["params"][name]),
                          job["batches"][name])
    arch, over = worker.DRIVER_ARCHS["mixtral-e2"]
    cfg = worker.port_cfg(arch, over)
    init = model_zoo.get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    steps_in["driver-mixtral-e2"] = (arch, over, (2, 1), 1, False, worker.LR,
                                     _np_jax_layout(init),
                                     _driver_batches(cfg))
    moe_in = {name: (arch, over, shape,
                     jax.tree.map(lambda t: t.numpy(),
                                  job["moe_params"][name]), job["x2"][name])
              for name, (arch, over, shape, _) in worker.MOE_CASES.items()}
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump({"steps": steps_in, "moe": moe_in}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_train_mesh_reference.py"),
         str(d / "cases.pkl"), str(d / "out.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, d / "out.pkl"
    if proc.poll() is None:
        proc.kill()
        proc.wait(5)


@pytest.fixture(scope="module")
def spawns(job, jax_proc, tmp_path_factory):
    """Both worlds' ranks, started: {world: (context, directory)}."""
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"train_mesh{world}")
        wjob = {k: v for k, v in job.items()}
        wjob["params"] = {n: p for n, p in job["params"].items()
                          if worker.world_of(worker.STEP_CASES[n][2]) == world}
        out[world] = (tmp.start_processes(
            worker.rank_main, args=(world, str(d / "store"), wjob, str(d)),
            nprocs=world, join=False, start_method="spawn"), d)
    yield out, time.monotonic() + SPAWN_DEADLINE_S
    for ctx, _ in out.values():
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


@pytest.fixture(scope="module")
def ref(jax_proc):
    proc, path = jax_proc
    log, _ = proc.communicate(timeout=SPAWN_DEADLINE_S)
    assert proc.returncode == 0, log[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(spawns, ref):
    """{world: [each rank's results]}, once the reference is done; ranks
    still running at the deadline fail the run."""
    worlds, deadline = spawns
    out = {}
    for world, (ctx, d) in worlds.items():
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{SPAWN_DEADLINE_S}s")
        out[world] = [dict(torch.load(d / f"rank{r}.pt", weights_only=False),
                           dir=d) for r in range(world)]
    return out


# ---------------------------------------------------------------- policy
def test_policy_nests_and_suspends():
    assert policy._current() is None and policy.n_fsdp() == 1
    with policy.activation_sharding({"data": 2, "model": 4}):
        outer = policy._current()
        assert policy.n_fsdp() == 2
        with policy.activation_sharding({"pod": 2, "data": 2, "model": 1},
                                        seq_shard=True):
            assert policy.n_fsdp() == 4 and policy.seq_sharded()
            with policy.suspended():
                assert policy._current() is None
                assert not policy.divides("model", 8)
            assert policy.seq_sharded()
        assert policy._current() is outer and not policy.seq_sharded()
        with policy.suspended():
            assert policy._current() is None
        assert policy._current() is outer
    assert policy._current() is None
    x = torch.ones(3, 4)
    assert policy.shard(x, ("fsdp", "model")) is x


def test_policy_reduces_over_a_train_mesh_only():
    """A policy over one data shard reduces nothing; over more it reads
    the group from the ``TrainMesh`` it carries, and a mesh without
    groups (a mapping of sizes) raises rather than reducing over no
    group."""
    x = torch.ones(())
    with policy.activation_sharding({"data": 1, "model": 4}):
        assert policy.fsdp_group() is None and policy.global_sum(x) is x
    with policy.activation_sharding({"data": 2, "model": 1}):
        with pytest.raises(TypeError, match="TrainMesh"):
            policy.global_sum(x)


@pytest.mark.parametrize("sizes", [(1, 1), (2, 1), (2, 2), (4, 1), (2, 4),
                                   (2, 2, 2)])
@pytest.mark.parametrize("seq_shard", [False, True])
def test_policy_answers_as_the_reference(sizes, seq_shard):
    """``divides`` and ``seq_sharded`` equal the reference's on a stand-in
    mesh of the same axis sizes (one device repeated: the reference reads
    only its shape), and are False with no policy."""
    names = ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")
    n = int(np.prod(sizes))
    jmesh = jax.sharding.Mesh(np.array(jax.devices() * n)[:n].reshape(sizes),
                              names)
    dims = [1, 2, 3, 4, 6, 8, 12, 16]
    with jax_policy.activation_sharding(jmesh, seq_shard=seq_shard):
        want = ([jax_policy.divides(a, d) for a in ("fsdp", "model")
                 for d in dims], jax_policy.seq_sharded())
    with policy.activation_sharding(dict(zip(names, sizes)),
                                    seq_shard=seq_shard):
        got = ([policy.divides(a, d) for a in ("fsdp", "model")
                for d in dims], policy.seq_sharded())
    assert got == want
    assert not any(policy.divides(a, 4) for a in ("fsdp", "model"))
    assert not policy.seq_sharded()


# ---------------------------------------------------------- EP MoE, plain
@pytest.mark.parametrize("name", list(worker.MOE_CASES))
def test_plain_ep_equals_the_reference_shards(ref, job, name):
    """``_moe_ep_plain`` over the case's data shards, in one process,
    equals the reference's pieces composed shard by shard, with the same
    dropped pairs."""
    arch, over, shape, _ = worker.MOE_CASES[name]
    cfg = worker.port_cfg(arch, over)
    with moe.record_drops() as drops:
        got = moe._moe_ep_plain(job["moe_params"][name],
                                torch.from_numpy(job["x2"][name]), cfg,
                                shape[0])
    want = ref["moe"][name]
    np.testing.assert_allclose(got.numpy(), want["composed"], rtol=0,
                               atol=MOE_ATOL)
    assert [d.tolist() for d in drops] == [d.tolist() for d in want["drops"]]


def test_some_ep_case_drops_pairs(ref):
    """The cases reach the capacity: some shard drops pairs."""
    assert any(len(d) for case in ref["moe"].values() for d in case["drops"])


def test_reference_ep_reshape_mixes_experts(ref):
    """The reference's ``_moe_ep`` equals its own pieces composed shard by
    shard where each owner holds one expert (4 shards of 4 experts) or no
    all-to-all runs (3 experts), and differs where an owner holds 2: the
    [D, E/D, C, d] buffers it receives are reshaped, not transposed, into
    [E/D, D C, d]."""
    for name in ("ep-4x1", "all-experts-2x1", "all-experts-2x2"):
        r = ref["moe"][name]
        np.testing.assert_allclose(r["ref"], r["composed"], rtol=0,
                                   atol=MOE_ATOL)
    for name in ("ep-2x1", "ep-2x2"):
        r = ref["moe"][name]
        assert np.abs(r["ref"] - r["composed"]).max() > 0.1


# -------------------------------------------------------- EP MoE, on mesh
@pytest.mark.parametrize("name", list(worker.MOE_CASES))
def test_ep_moe_on_the_mesh(ranks, ref, name):
    """Each rank's outputs are its data shard's rows of the reference's
    composition (and of ``moe_apply`` where that is right), its dropped
    pairs the reference's for that shard; the ranks of a data shard
    agree."""
    shape = worker.MOE_CASES[name][2]
    want = ref["moe"][name]
    right = want["ref"] if name not in ("ep-2x1", "ep-2x2") else None
    for r in ranks[worker.world_of(shape)]:
        got = r["moe"][name]
        rows = np.split(want["composed"], shape[0])[got["shard"]]
        np.testing.assert_allclose(got["out"].numpy(), rows, rtol=0,
                                   atol=MOE_ATOL)
        if right is not None:
            np.testing.assert_allclose(
                got["out"].numpy(), np.split(right, shape[0])[got["shard"]],
                rtol=0, atol=MOE_ATOL)
        assert [d.tolist() for d in got["drops"]] == \
            [want["drops"][got["shard"]].tolist()]


# ------------------------------------------------------- the sharded step
def _allowed(name, case, job, want):
    """Per leaf: elements whose first update may flip sign under roundoff
    (a first moment near zero; with compression, a microbatch gradient
    near half a quantization step)."""
    arch, over, _, mb, compress = case
    cfg = worker.port_cfg(arch, over)
    tol = RECURRENT_GRAD_TOL if cfg.family in ("ssm", "hybrid") else GRAD_TOL
    allowed = _near_zero(want["first"]["m"], tol)
    if compress:
        zoo = model_zoo.get_model(cfg, "cpu")
        b = job["batches"][name][0]
        micro = [value_and_grad(lambda p, x: zoo.loss(p, x)[0],
                                job["params"][name], _tbatch({
                                    k: np.split(v, mb, axis=1 if k ==
                                                "positions" else 0)[i]
                                    for k, v in b.items()}))[1]
                 for i in range(mb)]
        allowed = [a | c for a, c in zip(allowed, _near_half_step(micro))]
    return allowed


@pytest.mark.parametrize("name", list(worker.STEP_CASES))
def test_sharded_step_matches_the_reference(ranks, ref, job, name):
    """Every step's loss and gradient norm; the state after the first
    step (where Adam's update is sign-like, as the unplaced step is held
    in ``tests/test_torch_train_driver.py``; a later update divides
    moments of gradients whose roundoff differs, and the later steps are
    held through their losses and norms)."""
    case = worker.STEP_CASES[name]
    want = ref["steps"][name]
    results = [r["steps"][name] for r in ranks[worker.world_of(case[2])]]
    assert len(want["loss"]) == len(job["batches"][name])
    for got in results:
        assert got["blocks_ok"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=LOSS_RTOL)
        assert got["loss"] == results[0]["loss"]
    assert results[0]["split"] > 0
    allowed = _allowed(name, case, job, want)
    for key in ("params", "m", "v"):
        _assert_params_close(results[0]["first"][key],
                             from_jax_params(want["first"][key], "cpu"),
                             allowed, f"{name} {key}")


# ------------------------------------------------------------ checkpoints
def test_checkpoint_from_2x2_restores_onto_1x4_unplaced_and_jax(ranks):
    whole = ranks[4][0]["ckpt_whole"]
    for r in ranks[4]:
        got = r["ckpt_1x4"]
        assert got["step"] == 2 and got["latest"] == 2
        assert got["blocks_ok"] and got["equal"]
    d = ranks[4][0]["dir"] / "ck22"
    like = jax.tree.map(torch.zeros_like, whole)
    restored, manifest = CheckpointManager(d).restore(like)
    assert manifest["step"] == 2
    assert all(torch.equal(a, b) for a, b in zip(flatten(restored),
                                                 flatten(whole)))
    jlike = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                         to_jax_layout(whole))
    jrest, _ = JaxCheckpointManager(d).restore(jlike)
    want = flatten(whole["params"]) + flatten(whole["opt"])
    got = flatten(from_jax_params(jrest["params"], "cpu")) + flatten(
        from_jax_params(jrest["opt"], "cpu"))
    assert len(got) == len(want)
    assert all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(got,
                                                                    want))


def test_unplaced_checkpoint_restores_onto_2x1(ranks):
    for r in ranks[2]:
        assert r["restore_2x1"]["blocks_ok"]
        assert r["restore_2x1"]["split"] > 0


# -------------------------------------------------------------- the driver
@pytest.mark.parametrize("key", list(worker.DRIVER_ARCHS))
def test_driver_on_2x1_restarts_every_rank_together(ranks, ref, key,
                                                    tmp_path, monkeypatch):
    results = [r["driver"][key] for r in ranks[2]]
    for got in results:
        assert got["restarts"] == 1 and got["restored_steps"] == [3]
        assert got["steps_run"] == 7 and not got["group_left"]
        assert got["losses"] == results[0]["losses"]
    losses = results[0]["losses"]
    if key == "llama":
        # the 1x1 driver's losses: the same global loss on every split
        arch, over = worker.DRIVER_ARCHS[key]
        monkeypatch.setattr(train, "get_smoke",
                            lambda a: worker.port_cfg(a, over))
        report, _ = train.run(train.parse_args(
            ["--arch", arch, "--ckpt-dir", str(tmp_path)] + worker.DRIVER))
        np.testing.assert_allclose(losses, report.losses, rtol=LOSS_RTOL)
    else:
        want = ref["steps"]["driver-mixtral-e2"]["loss"]
        np.testing.assert_allclose(losses, want[:4] + want[3:],
                                   rtol=LOSS_RTOL)


def test_driver_leaves_no_process_group(tmp_path, monkeypatch):
    monkeypatch.setattr(train, "get_smoke",
                        lambda a: worker.port_cfg(a, {}))
    train.run(train.parse_args(["--arch", "llama-paper", "--ckpt-dir",
                                str(tmp_path)] + worker.DRIVER[:-6]
                               + ["--steps", "1"]))
    assert not dist.is_initialized()


# ----------------------------------------------------- the production mesh
def test_production_mesh_on_fake_worlds():
    code = (
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "import sys\n"
        "n = int(sys.argv[1])\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0, "
        "world_size=n)\n"
        "try:\n"
        "    m = make_production_mesh(multi_pod=n == 512, device='cpu')\n"
        "    print(tuple(m.shape), m.mesh_dim_names)\n"
        "except ValueError as e:\n"
        "    print('ValueError', e)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = {}
    for n in (256, 512, 4):
        p = subprocess.run([sys.executable, "-c", code, str(n)], env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode == 0, p.stderr[-2000:]
        outs[n] = p.stdout.strip().splitlines()[-1]
    assert outs[256] == "(16, 16) ('data', 'model')"
    assert outs[512] == "(2, 16, 16) ('pod', 'data', 'model')"
    assert outs[4].startswith("ValueError") and "256 ranks" in outs[4] \
        and "torchrun" in outs[4]


# ------------------------------------------------------ the serving guard
def test_serving_a_moe_model_ignores_an_active_policy(monkeypatch):
    """A training policy left active must not reach serving: the engine's
    streams equal those of an engine with no policy, and the capacity
    path is never entered."""
    from repro_torch.serving import SamplingParams, ServingEngine
    cfg = worker.port_cfg("mixtral-8x7b", {})
    params = model_zoo.get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(3))
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab, 7).tolist()
               for i in range(3)]

    def serve():
        eng = ServingEngine(cfg, params, device="cpu", n_slots=4, max_len=32)
        reqs = [eng.submit(p, SamplingParams(max_new_tokens=5))
                for p in prompts]
        while eng.has_work:
            eng.step()
        return [list(r.tokens) for r in reqs]
    plain = serve()

    def refuse(*a, **k):
        raise AssertionError("serving took the capacity path")
    monkeypatch.setattr(moe, "_moe_ep", refuse)
    with policy.activation_sharding({"data": 1, "model": 1}):
        assert serve() == plain


def test_remat_recompute_keeps_the_policy_in_another_thread():
    """On the card autograd runs the backward (and remat's recompute) in
    a thread of its own, which has no policy: the recompute must take the
    forward's capacity path, or ``torch.utils.checkpoint`` finds other
    saved tensors.  Here the backward runs in a new thread, as there."""
    import threading
    cfg = dataclasses.replace(worker.port_cfg("mixtral-8x7b", {}),
                              remat=True)
    zoo = model_zoo.get_model(cfg, "cpu")
    params = zoo.init(torch.Generator().manual_seed(4))
    leaves = [p.requires_grad_(True) for p in flatten(params)]
    batch = _tbatch(_batch(cfg, 9))
    with policy.activation_sharding({"data": 1, "model": 1}), \
            moe.record_drops() as drops:
        loss = zoo.loss(unflatten(params, leaves), batch)[0]
        got = {}

        def backward():
            got["grads"] = torch.autograd.grad(loss, leaves,
                                               allow_unused=True)
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    assert "grads" in got
    # each layer's capacity path ran in the forward and in its recompute
    assert len(drops) == 2 * cfg.n_layers
