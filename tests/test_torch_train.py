"""The port's training path against the JAX package's, on a 2-layer f32
model (d_model 64, 4 heads over 2 KV heads, so the GQA backward runs,
d_ff 128, vocab 128), SyntheticLM batches of 4 x 16 tokens, from JAX's
init carried across by ``interchange.from_jax_params``: ``loss_fn``'s
gradient (port autograd against ``jax.grad``), ``remat``,
``harness.train_small_lm`` and ``launch/steps.make_train_step``.

Tolerances:
- gradients: each leaf within ``GRAD_TOL`` = 1e-4 of that leaf's largest
  |g| (f32, summation order only; measured ~1.6e-6);
- losses: ``LOSS_RTOL`` = 1e-5 relative, the first and every later one of
  ``train_small_lm`` (measured ~1e-7 after four steps);
- parameters after Adam steps: Adam's first update is sign-like,
  g / (|g| + eps), so an element whose gradient is within roundoff of 0
  may move by +lr in one package and -lr in the other.  Such elements are
  counted, not hidden under a wide bound: after one train step an element
  further than ``PARAM_TOL`` from JAX's must have had, in JAX's step (its
  first moment), a gradient within ``GRAD_TOL`` of its leaf's largest |g|
  of zero (microbatches whose compressed gradients cancel included) or,
  with int8
  compression, a microbatch gradient within roundoff of a half
  quantization step (round half to even gives k steps in one package and
  k + 1 in the other: at k = 0 one update is 0 and the other +-lr, and
  elsewhere g / (|g| + eps) differs by ~eps / |g|, 3.6e-4 relative at
  |g| ~ 1e-5, above PARAM_TOL); after
  ``train_small_lm``'s four steps each such element is bounded by four
  steps' moves (2 lr a step).  At most ``MAX_FLIP_SHARE`` of the
  elements may be such exceptions.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.eval import harness as jax_harness  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import flatten, value_and_grad  # noqa: E402

SHAPE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=128)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-train", dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-train", dtype=torch.float32, **SHAPE)
DATA = dict(vocab=128, seq_len=16, batch=4, seed=0)
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MAX_FLIP_SHARE = 1e-3
STEP_LR = 1e-2


_jax_value_and_grad = jax.jit(jax.value_and_grad(
    lambda p, batch: jax_tfm.loss_fn(p, batch, JCFG)[0]))


@pytest.fixture(scope="module")
def model():
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    batch = JaxSyntheticLM(**DATA).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              for k, v in batch.items()}
    jloss, jgrads = _jax_value_and_grad(jparams, jbatch)
    return dict(jparams=jparams, jbatch=jbatch, tbatch=tbatch,
                jloss=float(jloss),
                jgrads=flatten(from_jax_params(jgrads, device="cpu")))


def _tparams(model):
    return from_jax_params(model["jparams"], device="cpu")


def _loss(cfg):
    return lambda p, batch: tfm.loss_fn(p, batch, cfg)[0]


def _near_zero(grads):
    """Per leaf: elements whose gradient is within GRAD_TOL of the leaf's
    largest |g| of zero, where the two packages' signs may differ."""
    return [np.abs(g.numpy()) <= GRAD_TOL * float(g.abs().max())
            for g in grads]


def _near_half_step(micro_grads):
    """Per leaf of the port's tree: elements that some microbatch's int8
    compression puts within roundoff of a half step (|g| / scale = k + 1/2),
    where round half to even may give k in one package and k + 1 in the
    other.  ``micro_grads`` are JAX's gradient trees, whose stacked [L, ...]
    layer leaves share one scale, as the port's round trip does."""
    hit = None
    for g in micro_grads:
        def near(a):
            steps = np.abs(np.asarray(a, np.float32)) / (
                np.abs(a).max() / 127.0)
            return np.abs(steps - np.floor(steps) - 0.5) <= GRAD_TOL * 127
        h = jax.tree.map(near, g)
        hit = h if hit is None else jax.tree.map(np.logical_or, hit, h)
    return [m.numpy() for m in flatten(from_jax_params(hit, device="cpu"))]


def _assert_adam_params_close(got_tree, want_tree, what, allowed=None,
                              max_move=None):
    """Parameters after Adam steps: each element within PARAM_TOL of
    JAX's, or one of at most MAX_FLIP_SHARE counted exceptions.  With
    ``allowed`` (per leaf), every exception must lie in it; with
    ``max_move``, none may differ by more.  Returns the count."""
    n_far = n_total = 0
    for k, (got, want) in enumerate(zip(flatten(got_tree),
                                        flatten(want_tree))):
        got, want = got.numpy(), want.numpy()
        diff = np.abs(got - want)
        far = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
        if allowed is not None:
            bad = int(np.sum(far & ~allowed[k]))
            assert bad == 0, f"{what} leaf {k}: {bad} elements differ " \
                f"where no roundoff can flip the update"
        if max_move is not None:
            assert float(diff.max()) <= max_move, f"{what} leaf {k}"
        n_far += int(np.sum(far))
        n_total += got.size
    assert n_far <= MAX_FLIP_SHARE * n_total, \
        f"{what}: {n_far} of {n_total} elements differ"
    return n_far


@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_match_jax(model, remat):
    cfg = dataclasses.replace(CFG, remat=remat)
    loss, grads = value_and_grad(_loss(cfg), _tparams(model), model["tbatch"])
    np.testing.assert_allclose(float(loss), model["jloss"], rtol=LOSS_RTOL)
    got = flatten(grads)
    assert len(got) == len(model["jgrads"]) == 3 + 9 * CFG.n_layers
    for k, (g, want) in enumerate(zip(got, model["jgrads"])):
        assert g.shape == want.shape and g.dtype == torch.float32
        scale = float(want.abs().max())
        assert scale > 0, f"leaf {k} has a zero gradient"
        err = float((g - want).abs().max())
        assert err <= GRAD_TOL * scale, f"leaf {k}: {err} > {GRAD_TOL} x {scale}"


def test_remat_changes_no_number(model):
    """remat=True against False on the CPU: loss and every gradient
    bitwise equal (the recomputed forward is the same arithmetic)."""
    params = _tparams(model)
    a = value_and_grad(_loss(dataclasses.replace(CFG, remat=True)), params,
                       model["tbatch"])
    b = value_and_grad(_loss(dataclasses.replace(CFG, remat=False)), params,
                       model["tbatch"])
    assert torch.equal(a[0], b[0])
    for x, y in zip(flatten(a[1]), flatten(b[1])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "collect_kv"])
def test_remat_wraps_blocks_only_under_grad(model, monkeypatch, mode):
    calls = []

    def counting(fn, *args, **kw):
        calls.append(kw)
        return fn(*args)
    monkeypatch.setattr(tfm, "checkpoint", counting)
    params = _tparams(model)
    cfg = dataclasses.replace(CFG, remat=True)
    if mode == "grad":
        value_and_grad(_loss(cfg), params, model["tbatch"])
        # the recompute re-enters the forward's activation policy
        # (``policy.checkpoint_contexts``: on the card it runs in
        # autograd's own thread)
        from repro_torch.parallel import policy
        assert calls == [{"use_reentrant": False,
                          "context_fn": policy.checkpoint_contexts}
                         ] * CFG.n_layers
    elif mode == "no_grad":
        with torch.no_grad():
            tfm.loss_fn(params, model["tbatch"], cfg)
        assert calls == []
    else:
        with torch.enable_grad():
            tfm.forward(params, model["tbatch"], cfg, collect_kv=True)
        assert calls == []


def test_remat_default_matches_reference():
    assert configs.ModelConfig.__dataclass_fields__["remat"].default is True
    assert jax_configs.ModelConfig.__dataclass_fields__["remat"].default \
        is True
    assert configs.get_smoke("llama-paper").remat is \
        jax_configs.get_smoke("llama-paper").remat


def test_train_small_lm_matches_jax(model):
    n_steps, lr = 4, 3e-3
    jparams, jlosses = jax_harness.train_small_lm(
        JCFG, JaxSyntheticLM(**DATA), steps=n_steps, lr=lr, seed=0)
    params, losses = harness.train_small_lm(
        CFG, SyntheticLM(**DATA), steps=n_steps, lr=lr, device="cpu",
        params=_tparams(model))
    assert len(losses) == n_steps and losses[0] == pytest.approx(
        model["jloss"], rel=LOSS_RTOL)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    # after four steps the update is no longer sign-like everywhere: the
    # elements apart are counted and bounded by four steps' moves of lr
    _assert_adam_params_close(params, from_jax_params(jparams, device="cpu"),
                              "train_small_lm", max_move=2 * lr * n_steps)


def test_train_small_lm_draws_its_own_init_from_seed():
    cfg = dataclasses.replace(CFG, n_layers=1)
    a, la = harness.train_small_lm(cfg, SyntheticLM(**DATA), steps=2,
                                   device="cpu", seed=3)
    b, lb = harness.train_small_lm(cfg, SyntheticLM(**DATA), steps=2,
                                   device="cpu", seed=3)
    assert la == lb and all(np.isfinite(la))
    for x, y in zip(flatten(a), flatten(b)):
        assert torch.equal(x, y)


def test_train_small_lm_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        harness.train_small_lm(CFG, SyntheticLM(**DATA), steps=1)


def test_train_options_match_jax():
    jf = {f.name: f.default for f in
          dataclasses.fields(jax_steps.TrainOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(steps.TrainOptions)}
    assert tf == jf


@pytest.mark.parametrize("mb,compress", [(1, False), (2, False), (2, True),
                                         (4, True)])
def test_train_step_matches_jax(model, mb, compress):
    jopts = jax_steps.TrainOptions(microbatches=mb, grad_compression=compress)
    topts = steps.TrainOptions(microbatches=mb, grad_compression=compress)
    jcfg, tcfg = JaxAdamWConfig(lr=STEP_LR), AdamWConfig(lr=STEP_LR)
    jstep = jax.jit(jax_steps.make_train_step(JCFG, jcfg, jopts))
    tstep = steps.make_train_step(CFG, tcfg, topts)
    jp, jo, jm = jstep(model["jparams"], jax_adamw_init(model["jparams"],
                                                        jcfg), model["jbatch"])
    params = _tparams(model)
    tp, to, tm = tstep(params, adamw_init(params, tcfg), model["tbatch"])
    assert int(to["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=LOSS_RTOL)
    if mb == 1 and not compress:
        np.testing.assert_allclose(float(tm["loss"]), model["jloss"],
                                   rtol=LOSS_RTOL)
    # the gradient JAX's step used (its first moment is (1 - beta1) g):
    # with microbatches and compression a sum that cancels to near 0
    allowed = _near_zero(flatten(from_jax_params(jo["m"], device="cpu")))
    if compress:
        micro = []
        for i in range(mb):
            part = {k: v.reshape(mb, -1, *v.shape[1:])[i]
                    for k, v in model["jbatch"].items()}
            micro.append(_jax_value_and_grad(model["jparams"], part)[1])
        allowed = [a | b for a, b in zip(allowed, _near_half_step(micro))]
    _assert_adam_params_close(tp, from_jax_params(jp, device="cpu"),
                              f"train step mb={mb}", allowed=allowed)


def test_microbatches_take_contiguous_rows(model, monkeypatch):
    """Microbatch i is rows i*B/mb .. (i+1)*B/mb of the batch."""
    seen = []
    real = tfm.loss_fn

    def spy(params, batch, cfg):
        seen.append(batch["tokens"].clone())
        return real(params, batch, cfg)
    monkeypatch.setattr(tfm, "loss_fn", spy)
    params = _tparams(model)
    cfg = AdamWConfig()
    step = steps.make_train_step(CFG, cfg, steps.TrainOptions(microbatches=2))
    step(params, adamw_init(params, cfg), model["tbatch"])
    tokens = model["tbatch"]["tokens"]
    assert [s.tolist() for s in seen] == [tokens[:2].tolist(),
                                          tokens[2:].tolist()]
