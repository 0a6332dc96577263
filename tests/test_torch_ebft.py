"""The port's EBFT (``core/ebft.py``, the paper's stage 4) against the JAX
package's: ``make_block_masks`` on a llama block, ``masked_adam_step`` with
every kind of mask, ``ebft_block`` on the reference test's mini block and
on a llama block whose masks come from JAX's ``sparsify_tree`` at 8:16
without outliers; the port's version of ``tests/test_ebft.py``; and a
property of the reference that the port keeps: with structured outliers
the mask projection zeroes the salient weights.

Tolerances (f32): ``masked_adam_step`` at rtol 1e-6 (the same expression
in both packages; ``beta ** t`` and ``sqrt`` may round apart by an ulp),
atol 1e-7 for moments whose gradients cancel; ``ebft_block`` losses at
``LOSS_RTOL`` = 1e-5 relative (measured ~7e-7 over 20 steps), tuned
weights at ``PARAM_TOL`` but for counted exceptions: Adam's first update
is sign-like, so an element whose gradient is within roundoff of 0 may
move by +lr in one package and -lr in the other; at most
``MAX_FLIP_SHARE`` of the elements may differ more, each by at most 2 lr
a step.  Off-mask weights are exactly 0 in both packages.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro import core as jax_core  # noqa: E402
from repro.core import ebft as jax_ebft  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import configs, core  # noqa: E402
from repro_torch.core import ebft  # noqa: E402
from repro_torch.interchange import to_torch  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

SHAPE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=128)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-ebft", dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-ebft", dtype=torch.float32, **SHAPE)
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MAX_FLIP_SHARE = 1e-3
SEQ, N_CALIB = 16, 8
ECFG = dict(steps=20, lr=2e-3, batch_size=4)


def _jax_block(lp, x):
    pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None], x.shape[:2])
    return jax_tfm.block_forward(lp, x, pos, JCFG)[0]


def _block(lp, x, pos):
    return tfm.block_forward(lp, x, pos, CFG)[0]


def _jax_mini(params, x):
    """``tests/test_ebft.py``'s mini block: norm -> linear -> gelu ->
    linear."""
    h = x * (1 + params["norm"])
    h = jax.nn.gelu(h @ params["w1"].T)
    return x + h @ params["w2"].T


def _mini(params, x):
    h = x * (1 + params["norm"])
    h = F.gelu(h @ params["w1"].T, approximate="tanh")
    return x + h @ params["w2"].T


@pytest.fixture(scope="module")
def llama_block():
    """Layer 0 of a JAX smoke model, dense and sparsified to 8:16 without
    outliers by JAX's ``sparsify_tree``, with its records' masks."""
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    scfg = jax_core.SparsifyConfig(weight_pattern="8:16",
                                   outlier_pattern=None, scorer="magnitude",
                                   use_smoothquant=False)
    sparse, records = jax_core.sparsify_tree(jparams, {}, scfg)
    dense0 = jax.tree.map(lambda p: p[0], jparams["layers"])
    sparse0 = jax.tree.map(lambda p: p[0], sparse["layers"])
    masks = {name.split("/")[-1]: sl.nonsalient_kept_mask[0]
             for name, sl in records.items() if name.startswith("layers/")}
    assert sorted(masks) == ["w_down", "w_gate", "w_up", "wk", "wo", "wq",
                             "wv"]
    return dense0, sparse0, masks


def _to_torch_tree(tree):
    return {k: to_torch(v) for k, v in tree.items()}


def _assert_tuned_close(got, want, lr, steps, what):
    n_far = n_total = 0
    for k in sorted(want):
        a, b = got[k].numpy(), np.asarray(want[k])
        diff = np.abs(a - b)
        far = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(b)
        assert float(diff.max()) <= 2 * lr * steps, f"{what} {k}"
        n_far += int(far.sum())
        n_total += a.size
    assert n_far <= MAX_FLIP_SHARE * n_total, \
        f"{what}: {n_far} of {n_total} elements differ"


@pytest.mark.parametrize("train_norms", [True, False])
def test_make_block_masks_matches_jax(llama_block, train_norms):
    _, sparse0, masks = llama_block
    want = jax_ebft.make_block_masks(sparse0, masks, train_norms)
    got = ebft.make_block_masks(_to_torch_tree(sparse0),
                                _to_torch_tree(masks), train_norms)
    assert sorted(got) == sorted(want)
    for name in want:
        if isinstance(want[name], bool):
            assert got[name] is want[name], name
        else:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    assert got["attn_norm"] is got["mlp_norm"] is train_norms


def test_norms_trainable_weights_frozen_without_mask():
    """The port's version of ``tests/test_ebft.py``'s."""
    d = 8
    params = {"norm": torch.zeros(d), "w1": torch.ones(d, d),
              "w2": torch.ones(d, d)}
    masks = ebft.make_block_masks(params, {})
    assert masks["norm"] is True
    assert masks["w1"] is False and masks["w2"] is False


@pytest.mark.parametrize("n_steps", [1, 3])
def test_masked_adam_step_matches_jax(n_steps):
    rng = np.random.default_rng(5)
    shapes = {"free": (6, 8), "true": (8,), "frozen": (4, 8),
              "masked": (8, 16)}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    m_np = rng.random(shapes["masked"]) > 0.5
    p_np["masked"] *= m_np
    jmasks = {"free": None, "true": True, "frozen": False,
              "masked": jnp.asarray(m_np)}
    tmasks = {"free": None, "true": True, "frozen": False,
              "masked": torch.from_numpy(m_np)}
    cfg_kw = dict(lr=1e-2)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v) for k, v in p_np.items()}
    jo, to = jax_ebft.masked_adam_init(jp), ebft.masked_adam_init(tp)
    for _ in range(n_steps):
        g_np = {k: rng.standard_normal(s).astype(np.float32)
                for k, s in shapes.items()}
        jp, jo = jax_ebft.masked_adam_step(
            jp, {k: jnp.asarray(v) for k, v in g_np.items()}, jo, jmasks,
            jax_ebft.EBFTConfig(**cfg_kw))
        tp, to = ebft.masked_adam_step(
            tp, {k: torch.from_numpy(v) for k, v in g_np.items()}, to,
            tmasks, ebft.EBFTConfig(**cfg_kw))
    assert int(to["step"]) == int(jo["step"]) == n_steps
    for tree, jtree in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for k in shapes:
            np.testing.assert_allclose(tree[k].numpy(), np.asarray(jtree[k]),
                                       **ADAM_TOL, err_msg=k)
    np.testing.assert_array_equal(tp["frozen"].numpy(), p_np["frozen"])
    assert float(to["m"]["frozen"].abs().max()) == 0.0
    assert np.all(tp["masked"].numpy()[~m_np] == 0)
    assert not np.allclose(tp["free"].numpy(), p_np["free"])
    assert not np.allclose(tp["true"].numpy(), p_np["true"])


def test_ebft_block_matches_jax_on_llama_block(llama_block):
    dense0, sparse0, masks = llama_block
    x = np.random.default_rng(0).standard_normal(
        (N_CALIB, SEQ, CFG.d_model)).astype(np.float32)
    jmasks = jax_ebft.make_block_masks(sparse0, masks)
    jtuned, jlosses = jax_ebft.ebft_block(
        _jax_block, sparse0, dense0, jmasks, jnp.asarray(x),
        jax_ebft.EBFTConfig(**ECFG))
    tmasks = ebft.make_block_masks(_to_torch_tree(sparse0),
                                   _to_torch_tree(masks))
    tuned, losses = ebft.ebft_block(
        _block, _to_torch_tree(sparse0), _to_torch_tree(dense0), tmasks,
        torch.from_numpy(x), ebft.EBFTConfig(**ECFG),
        extra_inputs=(torch.arange(SEQ)[None],))
    assert len(losses) == ECFG["steps"] and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    _assert_tuned_close(tuned, jtuned, ECFG["lr"], ECFG["steps"], "llama")
    for name, m in masks.items():
        off = ~np.asarray(m)
        assert off.any() and np.all(tuned[name].numpy()[off] == 0), name
        assert np.all(np.asarray(jtuned[name])[off] == 0), name
    for name in ("attn_norm", "mlp_norm"):       # trained
        assert not torch.equal(tuned[name], to_torch(sparse0[name]))


def _mini_setup(pattern="2:4", d=64, ff=128, n=256):
    rng = np.random.default_rng(0)
    dense = {"norm": np.zeros((d,), np.float32),
             "w1": (rng.standard_normal((ff, d)) / np.sqrt(d)).astype(
                 np.float32),
             "w2": (rng.standard_normal((d, ff)) / np.sqrt(ff)).astype(
                 np.float32)}
    x = rng.standard_normal((n, d)).astype(np.float32)
    scfg = core.SparsifyConfig(weight_pattern=pattern, outlier_pattern=None,
                               scorer="magnitude", use_smoothquant=False)
    sparse, masks = dict(dense), {}
    for k in ("w1", "w2"):
        w = torch.from_numpy(dense[k])
        sl = core.sparsify_linear(w, None, scfg)
        sparse[k] = core.dense_effective_weight(w, sl, scfg).numpy()
        masks[k] = sl.nonsalient_kept_mask.numpy()
    return dense, sparse, masks, x


def test_ebft_block_matches_jax_on_mini_block():
    dense, sparse, masks, x = _mini_setup()
    cfg_kw = dict(steps=15, lr=3e-3, batch_size=64)
    jmasks = jax_ebft.make_block_masks(
        {k: jnp.asarray(v) for k, v in sparse.items()},
        {k: jnp.asarray(v) for k, v in masks.items()})
    jtuned, jlosses = jax_ebft.ebft_block(
        _jax_mini, {k: jnp.asarray(v) for k, v in sparse.items()},
        {k: jnp.asarray(v) for k, v in dense.items()}, jmasks,
        jnp.asarray(x), jax_ebft.EBFTConfig(**cfg_kw))
    tsparse = {k: torch.from_numpy(v) for k, v in sparse.items()}
    tmasks = ebft.make_block_masks(
        tsparse, {k: torch.from_numpy(v) for k, v in masks.items()})
    tuned, losses = ebft.ebft_block(
        _mini, tsparse, {k: torch.from_numpy(v) for k, v in dense.items()},
        tmasks, torch.from_numpy(x), ebft.EBFTConfig(**cfg_kw))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    _assert_tuned_close(tuned, jtuned, cfg_kw["lr"], cfg_kw["steps"], "mini")
    for k in ("w1", "w2"):
        off = ~masks[k]
        assert np.all(tuned[k].numpy()[off] == 0)
        assert np.all(np.asarray(jtuned[k])[off] == 0)


def test_ebft_recovers_pruned_block():
    """The port's version of ``tests/test_ebft.py``'s: the reconstruction
    error at least halves and the 2:4 structure is exactly preserved."""
    dense, sparse, masks, x = _mini_setup()
    t = {k: torch.from_numpy(v) for k, v in sparse.items()}
    td = {k: torch.from_numpy(v) for k, v in dense.items()}
    tx = torch.from_numpy(x)
    y_dense = _mini(td, tx)
    err_before = float(torch.mean((_mini(t, tx) - y_dense) ** 2))
    tmasks = ebft.make_block_masks(
        t, {k: torch.from_numpy(v) for k, v in masks.items()})
    tuned, losses = ebft.ebft_block(
        _mini, t, td, tmasks, tx,
        ebft.EBFTConfig(steps=60, lr=3e-3, batch_size=64))
    err_after = float(torch.mean((_mini(tuned, tx) - y_dense) ** 2))
    assert err_after < 0.5 * err_before
    assert losses[-1] < losses[0]
    for k in ("w1", "w2"):
        assert np.all(tuned[k].numpy()[~masks[k]] == 0)


def test_outlier_masks_zero_salient_weights_in_both_packages():
    """A property of the reference, kept by the port: with 16:256 outliers
    ``nonsalient_kept_mask`` is False at the salient positions, so the
    first ``masked_adam_step`` multiplies the dense-effective weight's
    exact salient values by 0, in JAX and in the port alike."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 256)).astype(np.float32)
    g = rng.standard_normal((16, 256)).astype(np.float32)
    kw = dict(weight_pattern="8:16", outlier_pattern="16:256",
              scorer="magnitude", use_smoothquant=False)
    jcfg, tcfg = jax_core.SparsifyConfig(**kw), core.SparsifyConfig(**kw)
    jsl = jax_core.sparsify_linear(jnp.asarray(w), None, jcfg)
    jw = jax_core.dense_effective_weight(jnp.asarray(w), jsl, jcfg)
    tsl = core.sparsify_linear(torch.from_numpy(w), None, tcfg)
    tw = core.dense_effective_weight(torch.from_numpy(w), tsl, tcfg)
    salient = np.asarray(jsl.salient_mask)
    np.testing.assert_array_equal(tsl.salient_mask.numpy(), salient)
    assert salient.sum() == 16 * 16
    np.testing.assert_array_equal(np.asarray(jw)[salient], w[salient])
    np.testing.assert_array_equal(tw.numpy()[salient], w[salient])

    ecfg = dict(lr=1e-4)
    jp, _ = jax_ebft.masked_adam_step(
        {"w": jw}, {"w": jnp.asarray(g)},
        jax_ebft.masked_adam_init({"w": jw}),
        {"w": jsl.nonsalient_kept_mask}, jax_ebft.EBFTConfig(**ecfg))
    tp, _ = ebft.masked_adam_step(
        {"w": tw}, {"w": torch.from_numpy(g)},
        ebft.masked_adam_init({"w": tw}),
        {"w": tsl.nonsalient_kept_mask}, ebft.EBFTConfig(**ecfg))
    assert np.all(np.asarray(jp["w"])[salient] == 0)
    assert np.all(tp["w"].numpy()[salient] == 0)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               **ADAM_TOL)


def test_core_exports_the_reference_names():
    for name in ("EBFTConfig", "ebft_block", "masked_adam_init",
                 "masked_adam_step"):
        assert getattr(core, name) is getattr(ebft, name)
        assert hasattr(jax_core, name)
    jf = {f.name: f.default for f in dataclasses.fields(jax_ebft.EBFTConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ebft.EBFTConfig)}
    assert tf == jf
    assert flatten(ebft.make_block_masks({"a_norm": torch.zeros(2)}, {})) \
        == [True]
