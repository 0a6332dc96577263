"""The port's ``optim`` package against the JAX package's: schedules,
AdamW steps and int8 gradient compression on the same numpy inputs, and
the port's versions of ``tests/test_runtime.py``'s optimizer tests.

Tolerances: the schedules are a few f32 operations, held at 1e-6
relative.  AdamW at f32 is held at rtol 1e-6 (a handful of f32 ulps: the
two packages evaluate the same expression, but ``beta ** t``, ``sqrt`` and
the fused multiply-adds XLA may form round in their own way), with an atol
of 1e-7 for first-moment entries where gradients of either sign cancel
over three steps (one such entry sat 9.3e-10 apart, 3.3e-6 relative, for
gradients of order 1); at bf16 every parameter and moment is held
within one bf16 ulp of JAX's (the update is computed in f32 in both and
rounded once, so the f32 difference can flip that rounding at most by one
step).  Compression: int8 payloads and scales bit-identical (one f32
division and a round half to even), the carried error to 1e-7.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_step as jax_adamw_step  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine  # noqa: E402
from repro.optim import global_norm as jax_global_norm  # noqa: E402
from repro.optim import grad_compress as jax_gc  # noqa: E402
from repro_torch.interchange import to_torch  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_step,  # noqa: E402
                               constant, cosine_with_warmup, global_norm,
                               grad_compress)
from repro_torch.tree import flatten, value_and_grad  # noqa: E402

SCHED_RTOL = 1e-6
F32_TOL = dict(rtol=1e-6, atol=1e-7)
ERR_ATOL = 1e-7
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("kw", [
    dict(base_lr=3e-4, warmup=10, total=50),
    dict(base_lr=1e-2, warmup=0, total=20, min_ratio=0.0),
    dict(base_lr=3e-3, warmup=7, total=7, min_ratio=0.3)],
    ids=["warm10", "nowarm", "warm_eq_total"])
def test_cosine_with_warmup_matches_jax(kw):
    steps = np.arange(kw["total"] + 6, dtype=np.int32)
    want = np.asarray(jax_cosine(jnp.asarray(steps), **kw))
    got = cosine_with_warmup(torch.from_numpy(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SCHED_RTOL, atol=0)


@pytest.mark.parametrize("base_lr", [3e-4, 0.1])
def test_constant_matches_jax(base_lr):
    steps = np.arange(12, dtype=np.int32)
    want = np.asarray(jax_constant(jnp.asarray(steps), base_lr=base_lr))
    got = constant(torch.from_numpy(steps), base_lr=base_lr)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SCHED_RTOL, atol=0)


# ----------------------------------------------------------------- AdamW
def _tree(rng, scale=1.0):
    """A nested dict/list tree like the port's params (JAX takes the same
    structure)."""
    return {"embed": rng.standard_normal((6, 8)).astype(np.float32) * scale,
            "layers": [{"w": rng.standard_normal((8, 16)).astype(np.float32)
                        * scale,
                        "norm": rng.standard_normal((16,)).astype(np.float32)
                        * scale} for _ in range(2)],
            "head": rng.standard_normal((4, 8)).astype(np.float32) * scale}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    return flatten(tree)


def _ulp_bf16(x):
    """One bf16 ulp at |x| (the spacing of bf16 values there)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _assert_close(got, want, dtype_name, what):
    got, want = _np(got), _np(want)
    if dtype_name == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL, err_msg=what)
    else:
        bound = _ulp_bf16(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= bound), \
            f"{what}: {np.max(np.abs(got - want) / bound)} bf16 ulps"


VARIANTS = {
    # grads large enough that the global-norm clip scales them
    "clip": dict(cfg=dict(lr=1e-2), grad_scale=10.0),
    "noclip": dict(cfg=dict(lr=1e-2, grad_clip=0.0), grad_scale=0.05),
    "lr_scale": dict(cfg=dict(lr=3e-3), grad_scale=1.0, lr_scale=0.37),
    "lr_schedule": dict(cfg=dict(lr=3e-3), grad_scale=1.0,
                        lr_scale="cosine"),
    "mask": dict(cfg=dict(lr=1e-2, weight_decay=0.0), grad_scale=1.0,
                 mask=True),
    "bf16_state": dict(cfg=dict(lr=1e-2), grad_scale=1.0,
                       state="bf16"),
}


def _mask_tree(params, rng):
    m = _map(params, lambda a: rng.random(a.shape) > 0.4)
    m["head"] = True                  # a fully trainable leaf beside them
    return m


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_adamw_steps_match_jax(variant, dtype_name, n_steps):
    v = VARIANTS[variant]
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(7)
    params_np = _tree(rng)
    grads_np = [_tree(rng, v["grad_scale"]) for _ in range(n_steps)]
    state_kw = {}
    if v.get("state") == "bf16":
        state_kw = dict(jax=dict(state_dtype=jnp.bfloat16),
                        torch=dict(state_dtype=torch.bfloat16))
    jcfg = JaxAdamWConfig(**v["cfg"], **state_kw.get("jax", {}))
    tcfg = AdamWConfig(**v["cfg"], **state_kw.get("torch", {}))
    mask_np = _mask_tree(params_np, rng) if v.get("mask") else None

    def jmask():
        return None if mask_np is None else _map(
            mask_np, lambda a: a if a is True else jnp.asarray(a))

    def tmask():
        return None if mask_np is None else _map(
            mask_np, lambda a: a if a is True else torch.from_numpy(a))

    jp = _map(params_np, lambda a: jnp.asarray(a, jdt))
    tp = _map(params_np, lambda a: to_torch(np.asarray(jnp.asarray(a, jdt))))
    jst, tst = jax_adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for i, g in enumerate(grads_np):
        jg = _map(g, lambda a: jnp.asarray(a, jdt))
        tg = _map(g, lambda a: to_torch(np.asarray(jnp.asarray(a, jdt))))
        if v.get("lr_scale") == "cosine":
            jls = jax_cosine(jnp.asarray(i), base_lr=1.0, warmup=2, total=5)
            tls = cosine_with_warmup(torch.tensor(i), base_lr=1.0, warmup=2,
                                     total=5)
        else:
            jls = tls = v.get("lr_scale", 1.0)
        jp, jst, jm = jax_adamw_step(jp, jg, jst, jcfg, lr_scale=jls,
                                     mask=jmask())
        tp, tst, tm = adamw_step(tp, tg, tst, tcfg, lr_scale=tls,
                                 mask=tmask())
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == n_steps
    for name, got_tree, want_tree in (("param", tp, jp),
                                      ("m", tst["m"], jst["m"]),
                                      ("v", tst["v"], jst["v"])):
        for k, (got, want) in enumerate(zip(_leaves(got_tree),
                                            jax.tree.leaves(want_tree))):
            assert got.dtype == to_torch(np.asarray(want[:0])).dtype
            dtn = dtype_name if name == "param" else (
                "bf16" if v.get("state") == "bf16" else "f32")
            _assert_close(got, want, dtn, f"{name} leaf {k}")
    if mask_np is not None:
        # positions off the mask keep their value exactly
        for got, m, p0 in zip(_leaves(tp), _leaves(mask_np),
                              _leaves(params_np)):
            if m is not True:
                want = _np(to_torch(np.asarray(jnp.asarray(p0, jdt))))
                np.testing.assert_array_equal(_np(got)[~m], want[~m])


def test_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    tree = _tree(rng, 3.0)
    want = float(jax_global_norm(_map(tree, jnp.asarray)))
    got = float(global_norm(_map(tree, torch.from_numpy)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --------------------- the port's versions of test_runtime.py::TestOptim
def test_adamw_reduces_loss():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    w = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(w, cfg)
    for _ in range(50):
        _, g = value_and_grad(lambda p: torch.sum(p["w"] ** 2), w)
        w, opt, _ = adamw_step(w, g, opt, cfg)
    assert float(torch.abs(w["w"]).max()) < 1.0


def test_masked_update_keeps_sparsity():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    w = {"w": torch.tensor([1.0, 0.0, 2.0, 0.0])}
    mask = {"w": torch.tensor([True, False, True, False])}
    opt = adamw_init(w, cfg)
    for _ in range(5):
        _, g = value_and_grad(lambda p: torch.sum((p["w"] - 3.0) ** 2), w)
        w, opt, _ = adamw_step(w, g, opt, cfg, mask=mask)
    assert float(w["w"][1]) == 0.0 and float(w["w"][3]) == 0.0
    assert float(w["w"][0]) != 1.0


def test_grad_clip():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    w = {"w": torch.zeros(3)}
    opt = adamw_init(w, cfg)
    g = {"w": torch.tensor([100.0, 0.0, 0.0])}
    _, _, metrics = adamw_step(w, g, opt, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)


def test_step_leaves_its_arguments_untouched():
    cfg = AdamWConfig(lr=0.1)
    w = {"w": torch.tensor([1.0, -2.0])}
    opt = adamw_init(w, cfg)
    g = {"w": torch.tensor([0.5, 0.5])}
    new_w, new_opt, _ = adamw_step(w, g, opt, cfg)
    assert w["w"].tolist() == [1.0, -2.0] and int(opt["step"]) == 0
    assert float(opt["m"]["w"].abs().sum()) == 0.0
    assert new_w["w"].tolist() != [1.0, -2.0] and int(new_opt["step"]) == 1


# ------------------------------------------------------ grad compression
def _grad_tree(rng, dtype):
    jdt, _ = DTYPES[dtype]
    g = {"a": rng.standard_normal((33, 17)).astype(np.float32) * 1e-3,
         "b": [rng.standard_normal((64,)).astype(np.float32) * 50.0,
               np.zeros((5, 3), np.float32)],          # scale 1.0 branch
         "c": (np.linspace(-1, 1, 255) * 127).astype(np.float32)}  # .5 ties
    return _map(g, lambda a: np.asarray(jnp.asarray(a, jdt)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_error", [False, True])
def test_compress_with_feedback_matches_jax(dtype, with_error):
    rng = np.random.default_rng(11)
    g_np = _grad_tree(rng, dtype)
    jg = _map(g_np, jnp.asarray)
    tg = _map(g_np, to_torch)
    if with_error:
        e_np = _map(g_np, lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * 0.01)
        je, te = _map(e_np, jnp.asarray), _map(e_np, torch.from_numpy)
    else:
        je, te = jax_gc.init_error(jg), grad_compress.init_error(tg)
    jq, jerr = jax_gc.compress_with_feedback(jg, je)
    tq, terr = grad_compress.compress_with_feedback(tg, te)
    for (q, s), jleaf in zip(_leaves(tq), jax.tree.leaves(
            jq, is_leaf=lambda x: isinstance(x, tuple))):
        jqv, js = jleaf
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
        assert np.float32(s.item()) == np.asarray(js)
    for got, want in zip(_leaves(terr), jax.tree.leaves(jerr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ERR_ATOL)
    for got, want in zip(_leaves(grad_compress.decompress(tq, tg)),
                         jax.tree.leaves(jax_gc.decompress(jq, jg))):
        assert got.dtype == to_torch(np.asarray(want[:0])).dtype
        np.testing.assert_array_equal(_np(got), _np(want))


def test_error_feedback_converges():
    """The port's version of ``test_runtime.py``'s: the sum of dequantized
    grads tracks the sum of true grads to within one quantization step."""
    g = {"w": torch.linspace(-1, 1, 512)}
    err = grad_compress.init_error(g)
    total = torch.zeros(512)
    for _ in range(20):
        q, err = grad_compress.compress_with_feedback(g, err)
        total += grad_compress.decompress(q, g)["w"]
    np.testing.assert_allclose(total.numpy(), (20 * g["w"]).numpy(),
                               atol=2e-2)


def test_int8_payload():
    g = {"w": torch.ones((64, 64))}
    q, _ = grad_compress.compress_with_feedback(
        g, grad_compress.init_error(g))
    payload, scale = q["w"]
    assert payload.dtype == torch.int8 and payload.shape == (64, 64)
    assert int(payload.max()) == 127 and scale.shape == ()
