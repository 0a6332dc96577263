"""The port's training driver against the JAX package's, at f32 on smoke
twins.

- ``launch/steps.make_train_step`` trains every family: one step of the
  port and of JAX's jitted step from the same params (JAX's init carried
  across by ``interchange.from_jax_params``) on the same numpy batch, for
  the ssm, hybrid, encdec, vlm and moe twins (the dense family's is
  ``tests/test_torch_train.py``), with one batch, 2 microbatches, and 2
  microbatches with int8 compression (each per-layer leaf stacked
  [L, ...] first, so its layers share one absmax scale, as the reference's
  stacked leaves do).  The loss and the gradient norm agree to
  ``LOSS_RTOL``; the parameters after Adam's first, sign-like update to
  ``PARAM_TOL``, except elements whose update may flip sign under roundoff
  (a first moment within ``GRAD_TOL`` of its leaf's largest of zero, or
  with compression a microbatch gradient within roundoff of half a
  quantization step), at most ``MAX_FLIP_SHARE`` of them
  (``tests/test_torch_train.py`` sets out why).
- ``launch/train.run`` with a simulated failure against a JAX loop of
  jitted ``make_train_step`` + ``TrainSupervisor`` + ``CheckpointManager``
  run under ``activation_sharding`` on a 1x1 mesh, as the reference's
  ``main`` runs it, on the same f32 config, initial params (the port's
  draw, carried to JAX), data and schedule: losses within ``LOSS_RTOL``
  step by step (measured ~1e-7), the same restarts and restored steps,
  for llama-paper and for mixtral-8x7b, whose MoE takes the capacity path
  under the policy on both sides.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import grad_compress as jax_gc  # noqa: E402
from repro.runtime.checkpoint import \
    CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.runtime.fault_tolerance import HostFailure as JaxHostFailure  # noqa: E402
from repro.runtime.fault_tolerance import \
    TrainSupervisor as JaxTrainSupervisor  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.interchange import (from_jax_layout,  # noqa: E402
                                     from_jax_params, to_jax_layout)
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import flatten, unflatten, value_and_grad  # noqa: E402

FAMILY_ARCHS = ["xlstm-350m", "zamba2-2.7b", "whisper-medium",
                "qwen2-vl-72b", "mixtral-8x7b"]
B, S = 4, 16
GRAD_TOL = 1e-4
# the recurrences' f32 gradients agree with JAX's to ~1e-4 of their scale
# (tests/test_torch_recurrent_models.py), so an update that eps makes
# sensitive may move where the first moment is within 1e-3 of its leaf's
# largest of zero
RECURRENT_GRAD_TOL = 1e-3
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MAX_FLIP_SHARE = 1e-3
STEP_LR = 1e-2
# the driver run: 6 steps, saves at 3 and 6, a failure at step 4
DRIVER = ["--arch", "llama-paper", "--smoke-arch", "--device", "cpu",
          "--steps", "6", "--batch", "4", "--seq", "32", "--save-every", "3",
          "--fail-at-step", "4", "--lr", "1e-3", "--seed", "0"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: several test workers on one machine must
    not oversubscribe its cores (it changes no case and no tolerance);
    restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (dataclasses.replace(jax_configs.get_smoke(arch),
                                dtype=jnp.float32),
            dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32))


def _batch(cfg, seed=3) -> dict:
    """A train batch of ``model_zoo.input_specs``' shapes, drawn with numpy:
    tokens and labels in the vocab, ``embeds`` N(0, 1), M-RoPE positions
    in [0, 9)."""
    rng = np.random.default_rng(seed)
    out = {}
    specs = model_zoo.input_specs(cfg, ShapeConfig("t", S, B, "train"))
    for name, (shape, dtype) in specs.items():
        if name == "embeds":
            out[name] = rng.standard_normal(shape).astype(np.float32)
        elif name == "positions":
            out[name] = rng.integers(0, 9, shape).astype(np.int32)
        else:
            out[name] = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    return out


@functools.cache
def _family(arch):
    jcfg, cfg = _cfgs(arch)
    jparams = jax.jit(jax_get_model(jcfg).init)(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, _batch(cfg)


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _near_zero(tree, tol=GRAD_TOL):
    """Per leaf of the port's tree: elements within ``tol`` of the leaf's
    largest |value| of zero."""
    return [np.abs(g.numpy()) <= tol * float(g.abs().max())
            for g in flatten(from_jax_params(tree, device="cpu"))]


def _near_half_step(micro_grads):
    """Per leaf: elements that some microbatch's int8 compression (one
    scale a stacked leaf) puts within roundoff of half a step, where round
    half to even may go either way.  ``micro_grads`` are the port's
    gradient trees (equal to JAX's within roundoff)."""
    hit = None
    for g in micro_grads:
        stacked = flatten(to_jax_layout(g))
        near = []
        for a in stacked:
            a = a.abs().numpy()
            steps_ = a / (a.max() / 127.0) if a.max() > 0 else a
            near.append(np.abs(steps_ - np.floor(steps_) - 0.5)
                        <= GRAD_TOL * 127)
        hit = near if hit is None else [x | y for x, y in zip(hit, near)]
    return [m.numpy() for m in flatten(from_jax_layout(unflatten(
        to_jax_layout(micro_grads[0]), [torch.from_numpy(h) for h in hit])))]


def _assert_params_close(got_tree, want_tree, allowed, what):
    n_far = n_total = 0
    for k, (got, want) in enumerate(zip(flatten(got_tree),
                                        flatten(want_tree))):
        got, want = got.numpy(), want.numpy()
        far = np.abs(got - want) > (PARAM_TOL["atol"]
                                    + PARAM_TOL["rtol"] * np.abs(want))
        bad = int(np.sum(far & ~allowed[k]))
        assert bad == 0, f"{what} leaf {k}: {bad} elements differ where " \
            f"no roundoff can flip the update"
        n_far += int(np.sum(far))
        n_total += got.size
    assert n_far <= MAX_FLIP_SHARE * n_total, \
        f"{what}: {n_far} of {n_total} elements differ"


def _micro(batch, mb, i):
    """Microbatch i of a numpy batch as the reference splits it: axis 0,
    and axis 1 of M-RoPE positions [3, B, S]."""
    def part(v):
        ax = 0 if v.shape[0] == B else 1
        return np.moveaxis(v.reshape(*v.shape[:ax], mb, -1,
                                     *v.shape[ax + 1:]), ax, 0)[i]
    return {k: part(v) for k, v in batch.items()}


@pytest.mark.parametrize("mb,compress", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_matches_jax_for_every_family(arch, mb, compress):
    jcfg, cfg, jparams, batch = _family(arch)
    jopts = jax_steps.TrainOptions(microbatches=mb, grad_compression=compress)
    topts = steps.TrainOptions(microbatches=mb, grad_compression=compress)
    jocfg, tocfg = JaxAdamWConfig(lr=STEP_LR), AdamWConfig(lr=STEP_LR)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp, jo, jm = jax.jit(jax_steps.make_train_step(jcfg, jocfg, jopts))(
        jparams, jax_adamw_init(jparams, jocfg), jbatch)
    params = from_jax_params(jparams, device="cpu")
    tp, to, tm = steps.make_train_step(cfg, tocfg, topts)(
        params, adamw_init(params, tocfg), _tbatch(batch))
    assert int(to["step"]) == 1
    assert np.isfinite(float(tm["loss"]))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=LOSS_RTOL)
    allowed = _near_zero(jo["m"], RECURRENT_GRAD_TOL if cfg.family in (
        "ssm", "hybrid") else GRAD_TOL)
    if compress:
        zoo = model_zoo.get_model(cfg, "cpu")
        micro = [value_and_grad(lambda p, b: zoo.loss(p, b)[0], params,
                                _tbatch(_micro(batch, mb, i)))[1]
                 for i in range(mb)]
        allowed = [a | b for a, b in zip(allowed, _near_half_step(micro))]
    _assert_params_close(tp, from_jax_params(jp, device="cpu"), allowed,
                         f"{arch} mb={mb} compress={compress}")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_int8_round_trip_matches_jax_on_stacked_leaves(arch):
    """``steps._int8_round_trip`` against JAX's compress/decompress of the
    stacked tree from a zero error: the same bits, each family (the dense
    family's through ``tests/test_torch_train.py``'s steps; each
    stacked leaf one absmax scale; zamba2's ``shared_attn`` and the other
    unstacked leaves one scale each)."""
    jparams = _family(arch)[2]
    grads = jax.tree.map(lambda p: p * 3.7 - 0.1, jparams)
    q, _ = jax_gc.compress_with_feedback(
        grads, jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), grads))
    want = flatten(from_jax_params(jax_gc.decompress(q, grads), "cpu"))
    got = flatten(steps._int8_round_trip(from_jax_params(grads, "cpu")))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


# -------------------------------------------------------------- the driver
def _f32_smoke(monkeypatch):
    real = train.get_smoke
    monkeypatch.setattr(train, "get_smoke", lambda a: dataclasses.replace(
        real(a), dtype=torch.float32))


def _jax_loop(tmp_path, init_params, argv=DRIVER):
    """The reference's driver loop as its ``main`` runs it: every step
    under ``activation_sharding`` on a 1x1 mesh of Auto axes (so a moe
    model takes the capacity path, ``_moe_ep``), a jitted
    ``make_train_step``, JAX's ``TrainSupervisor`` and
    ``CheckpointManager``, starting from ``init_params``."""
    from jax.sharding import AxisType
    from repro.parallel.policy import activation_sharding
    args = train.parse_args(argv)
    jcfg = dataclasses.replace(jax_configs.get_smoke(args.arch),
                               dtype=jnp.float32)
    ocfg = JaxAdamWConfig(lr=args.lr)
    data = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=args.seq,
                          batch=args.batch, seed=args.seed)
    step = jax.jit(jax_steps.make_train_step(jcfg, ocfg,
                                             jax_steps.TrainOptions()))
    sup = JaxTrainSupervisor(JaxCheckpointManager(tmp_path),
                             save_every=args.save_every)
    failed = {"done": False}

    def make_state(restored):
        if restored is None:
            return {"params": init_params,
                    "opt": jax_adamw_init(init_params, ocfg)}
        return restored

    def step_fn(state, i):
        if i == args.fail_at_step and not failed["done"]:
            failed["done"] = True
            raise JaxHostFailure(f"simulated failure at step {i}")
        batch = jax.tree.map(jnp.asarray, data.batch_at(i))
        params, opt, metrics = step(state["params"], state["opt"], batch)
        return ({"params": params, "opt": opt},
                {k: float(v) for k, v in metrics.items()})

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with activation_sharding(mesh):
        return sup.run(make_state, step_fn, args.steps)


def test_driver_with_failure_matches_the_jax_loop(tmp_path, monkeypatch,
                                                  capsys):
    _f32_smoke(monkeypatch)
    report, state = train.run(train.parse_args(
        DRIVER + ["--ckpt-dir", str(tmp_path / "port")]))
    out = capsys.readouterr().out
    # steps 0-2, a save at 3, step 3, the failure at 4, steps 3-5 again
    assert "step     0 loss" in out and "finished: 7 steps, 1 restarts" in out
    assert report.restarts == 1 and report.restored_steps == [3]
    assert report.steps_run == 7 and len(report.losses) == 7
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_000003", "step_000006"]
    # the same initial params in JAX's layout
    cfg = dataclasses.replace(configs.get_smoke("llama-paper"),
                              dtype=torch.float32)
    init = model_zoo.get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    init = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        to_jax_layout(init))
    ref = _jax_loop(tmp_path / "jax", init)
    assert ref.restarts == report.restarts
    assert ref.restored_steps == report.restored_steps
    assert ref.steps_run == report.steps_run
    np.testing.assert_allclose(report.losses, ref.losses, rtol=LOSS_RTOL)
    # the final checkpoint holds the final state, bit for bit
    restored, manifest = train.CheckpointManager(tmp_path / "port").restore(
        state)
    assert manifest["step"] == 6
    assert all(torch.equal(a, b) for a, b in zip(flatten(restored),
                                                 flatten(state)))


def test_driver_trains_moe_on_the_capacity_path(tmp_path, monkeypatch):
    """The reference's driver always trains under a mesh's policy, so a
    moe model takes ``_moe_ep`` (capacity 1.25, overflowing tokens
    dropped); the port's ``train.run`` does too, on its 1x1 host mesh:
    mixtral-8x7b's smoke twin at f32 gives the reference's losses step by
    step, restarts included, and leaves no process group behind."""
    import torch.distributed as dist
    _f32_smoke(monkeypatch)
    argv = ["--arch", "mixtral-8x7b"] + DRIVER[2:]
    report, _ = train.run(train.parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "port")]))
    assert not dist.is_initialized()
    cfg = dataclasses.replace(configs.get_smoke("mixtral-8x7b"),
                              dtype=torch.float32)
    init = model_zoo.get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    init = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        to_jax_layout(init))
    ref = _jax_loop(tmp_path / "jax", init, argv)
    assert ref.restored_steps == report.restored_steps == [3]
    np.testing.assert_allclose(report.losses, ref.losses, rtol=LOSS_RTOL)


def test_driver_resumes_from_a_committed_checkpoint(tmp_path, monkeypatch):
    """A run whose directory holds a checkpoint starts from it: 3 steps,
    then the same command with 5 runs steps 3 and 4 only, with the losses
    of an uninterrupted 5-step run."""
    _f32_smoke(monkeypatch)
    base = ["--arch", "llama-paper", "--smoke-arch", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--save-every", "10"]
    first = train.main(base + ["--steps", "3", "--ckpt-dir",
                               str(tmp_path / "a")])
    second = train.main(base + ["--steps", "5", "--ckpt-dir",
                                str(tmp_path / "a")])
    whole = train.main(base + ["--steps", "5", "--ckpt-dir",
                               str(tmp_path / "b")])
    assert second.restored_steps == [3] and second.steps_run == 2
    np.testing.assert_allclose(first.losses + second.losses, whole.losses,
                               rtol=LOSS_RTOL)


def test_production_mesh_raises_naming_a12(tmp_path):
    """``--production-mesh`` on a world of one raises the mesh's
    ValueError (256 ranks, start them with torchrun) and leaves no
    process group; ``build`` on a 1x1 mesh returns a step and the specs
    of the params and the optimizer state."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(ValueError, match="256 ranks.*torchrun"):
        train.main(DRIVER + ["--production-mesh", "--ckpt-dir",
                             str(tmp_path)])
    assert not dist.is_initialized()
    _, cfg = _cfgs("llama-paper")
    mesh = make_host_mesh("cpu")
    try:
        step, p_sh, o_sh = train.build(cfg, AdamWConfig(),
                                       steps.TrainOptions(), mesh=mesh)
        assert callable(step)
        assert p_sh.specs["embed"] == ("model", "data")
        assert o_sh.specs["step"] == ()
    finally:
        dist.destroy_process_group()


def test_driver_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "llama-paper", "--smoke-arch", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


def test_chunked_gla_gradient_is_finite_where_the_reference_overflows():
    """Mamba2's decays over a chunk overflow exp(F_t - F_s) above the
    diagonal in f32.  The reference masks after the exponent, so its
    gradient with respect to the decays is 0 x inf = NaN there
    (zamba2-2.7b's at 512 tokens); the port masks the gap first: the same
    forward (to f32 roundoff; its bits are those of the unmasked formula
    wherever that is finite), and a gradient equal to its own in f64."""
    from repro.models import linear_attn as jax_la
    from repro_torch.models import linear_attn as la
    rng = np.random.default_rng(5)
    B, S, H, d = 1, 32, 2, 4
    q, k, v = (rng.standard_normal((B, S, H, d)).astype(np.float32)
               for _ in range(3))
    log_f = np.full((B, S, H), -40.0, np.float32)     # 16 steps: e^640

    def jax_loss(lf):
        return jnp.sum(jax_la.chunked_gla(q, k, v, lf, chunk=16)[0])
    jy = jax_la.chunked_gla(q, k, v, log_f, chunk=16)[0]
    jg = jax.grad(jax_loss)(jnp.asarray(log_f))
    assert not bool(jnp.all(jnp.isfinite(jg)))

    def port_grad(dtype):
        lf = torch.tensor(log_f, dtype=dtype, requires_grad=True)
        args = [torch.tensor(a, dtype=dtype) for a in (q, k, v)]
        y = la.chunked_gla(*args, lf, chunk=16)[0]
        y.sum().backward()
        return y.detach(), lf.grad
    y32, g32 = port_grad(torch.float32)
    np.testing.assert_allclose(y32.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    assert bool(torch.isfinite(g32).all())
    _, g64 = port_grad(torch.float64)
    np.testing.assert_allclose(g32.numpy(), g64.numpy(), rtol=1e-5,
                               atol=1e-6)
