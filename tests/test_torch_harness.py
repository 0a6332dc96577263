"""The port's evaluation harness against the JAX package's, on the
llama-paper smoke model at f32 with JAX's weights carried across:
``SyntheticLM`` batches, ``collect_activation_stats`` (and
``stats_from_jax``), ``forward``/``loss_fn``, ``eval_ppl``,
``sparsify_model`` and ``sparsify_for_serving`` with per-leaf statistics.

Tolerances: statistics are f32 sums of x**2 over every calibration token,
taken after four f32 blocks that the two packages round in another order,
so they are held to ``STATS_RTOL`` = 1e-5 relative (the max-abs too: it
is taken from those activations); logits to ``ATOL`` = 1e-4 (summation
order, as in ``test_torch_model.py``); losses and perplexities to 1e-5
relative.  The pipeline runs on JAX's statistics in both packages; its
scores then differ by at most an f32 ulp or so (``test_torch_pipeline.py``),
which may flip a near-tie, so the share of agreeing indices is held at
``AGREE`` = 0.999 and the values at the agreeing positions to VC's
tolerance (exact for the salient ones).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.eval import harness as jax_harness  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify_for_serving  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import SparsifyConfig  # noqa: E402
from repro_torch.core.outliers import unpack_outlier_meta  # noqa: E402
from repro_torch.core.packing import unpack_metadata  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.interchange import (from_jax_params, stats_from_jax,  # noqa: E402
                                     to_torch)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.sparse_serving import (SparseWeight,  # noqa: E402
                                               sparsify_for_serving)

JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           dtype=jnp.float32)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          dtype=torch.float32)
STATS_RTOL = 1e-5
ATOL = 1e-4
LOSS_RTOL = 1e-5
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
AGREE = 0.999
PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def model():
    """JAX's smoke model and the port's copy, a calibration set of two
    batches, and JAX's statistics over it."""
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    data = JaxSyntheticLM(vocab=JCFG.vocab, seq_len=32, batch=2, seed=0)
    calib = data.calibration(2)
    jstats = jax_harness.collect_activation_stats(JCFG, jparams, calib)
    return jparams, from_jax_params(jparams, device="cpu"), calib, jstats


def _batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in
            batch.items()}


@pytest.mark.parametrize("kw,step,host", [
    (dict(vocab=512, seq_len=32, batch=2), 0, 0),
    (dict(vocab=128256, seq_len=64, batch=4), 10_000, 0),
    (dict(vocab=512, seq_len=16, batch=3, seed=5, stream_seed=7,
          branching=4), 3, 1)])
def test_synthetic_lm_batches_identical(kw, step, host):
    ours, theirs = SyntheticLM(**kw), JaxSyntheticLM(**kw)
    a, b = ours.batch_at(step, host), theirs.batch_at(step, host)
    for key in ("tokens", "labels"):
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])
    for a, b in zip(ours.calibration(2), theirs.calibration(2)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_collect_activation_stats_matches_jax(model):
    jparams, tparams, calib, jstats = model
    stats = harness.collect_activation_stats(CFG, tparams, calib)
    want = stats_from_jax(jstats)
    assert sorted(stats) == sorted(want) == sorted(
        f"layers/{i}/{p}" for i in range(CFG.n_layers) for p in PROJ)
    n_tokens = sum(b["tokens"].size for b in calib)
    for name, st in stats.items():
        assert st.count.ndim == 0 and float(st.count) == n_tokens
        assert float(want[name].count) == n_tokens
        np.testing.assert_allclose(st.sq_sum.numpy(),
                                   want[name].sq_sum.numpy(), rtol=STATS_RTOL)
        np.testing.assert_allclose(st.max_abs.numpy(),
                                   want[name].max_abs.numpy(),
                                   rtol=STATS_RTOL)


def test_stats_from_jax_slices_layers(model):
    """[L, in] leaves and [L] counts become per-layer [in] leaves and
    scalar counts, in f32, each equal to JAX's slice."""
    _, _, _, jstats = model
    stats = stats_from_jax(jstats)
    assert len(stats) == len(PROJ) * CFG.n_layers
    for i in range(CFG.n_layers):
        for p in PROJ:
            st, j = stats[f"layers/{i}/{p}"], jstats[f"layers/{p}"]
            assert st.sq_sum.dtype == torch.float32 and st.count.ndim == 0
            np.testing.assert_array_equal(st.sq_sum.numpy(),
                                          np.asarray(j.sq_sum[i]))
            np.testing.assert_array_equal(st.max_abs.numpy(),
                                          np.asarray(j.max_abs[i]))
            assert float(st.count) == float(j.count[i])


def _jax_serving_layers(model, scfg, quantize=False):
    """JAX's ``sparsify_for_serving`` with statistics, per layer: its
    stacked path cannot take [L, in] statistics (its vmap hands them to
    ``_to_sparse_weight`` positionally, as ``scfg``, and raises TypeError),
    so the JAX tree and statistics are unstacked into the port's layout and
    names first, which its 2-D path takes.  Returns (params with a layer
    list, report)."""
    jparams, _, _, jstats = model
    layers = [jax.tree.map(lambda a, i=i: a[i], jparams["layers"])
              for i in range(JCFG.n_layers)]
    stats = {f"layers/{i}/{p}": jax.tree.map(lambda a, i=i: a[i],
                                             jstats[f"layers/{p}"])
             for i in range(JCFG.n_layers) for p in PROJ}
    return jax_sparsify_for_serving(dict(jparams, layers=layers),
                                    JaxSparsifyConfig(**scfg), stats,
                                    quantize=quantize)


def _sparse_pair(model):
    """Both packages' 8:16+16:256 SparseWeight params from the paper's
    pipeline on JAX's statistics (the port's from JAX's containers)."""
    jsparse, _ = _jax_serving_layers(
        model, dict(weight_pattern="8:16", outlier_pattern="16:256"))
    jsparse["layers"] = jax.tree.map(lambda *a: jnp.stack(a),
                                     *jsparse["layers"])
    return jsparse, from_jax_params(jsparse, device="cpu")


@pytest.mark.parametrize("weights", ["dense", "sparse"])
def test_forward_matches_jax(model, weights):
    """Logits and the collected KV of the full-sequence forward; sparse
    params take the kernels' plain versions through ``layers.linear``."""
    jparams, tparams, calib, _ = model
    if weights == "sparse":
        jparams, tparams = _sparse_pair(model)
        assert isinstance(tparams["layers"][0]["wq"], SparseWeight)
    batch = calib[0]
    jlogits, (jk, jv) = jax_tfm.forward(jparams, jax.tree.map(
        jnp.asarray, batch), JCFG, collect_kv=True)
    with torch.no_grad():
        logits, (k, v) = tfm.forward(tparams, _batch(batch), CFG,
                                     collect_kv=True)
    assert logits.shape == (2, 32, JCFG.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL,
                               rtol=0)
    for ours, theirs in ((k, jk), (v, jv)):
        assert tuple(ours.shape) == tuple(theirs.shape)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=ATOL, rtol=0)


def test_loss_fn_matches_jax(model):
    """Mean cross-entropy over labels >= 0 (a masked label included)."""
    jparams, tparams, calib, _ = model
    batch = {k: np.array(v) for k, v in calib[1].items()}
    batch["labels"][0, :5] = -1
    jloss, _ = jax_tfm.loss_fn(jparams, jax.tree.map(jnp.asarray, batch),
                               JCFG)
    with torch.no_grad():
        loss, aux = tfm.loss_fn(tparams, _batch(batch), CFG)
    assert aux == {} and loss.dtype == torch.float32
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)


@pytest.mark.parametrize("weights", ["dense", "sparsified"])
def test_eval_ppl_matches_jax(model, weights):
    jparams, tparams, _, jstats = model
    if weights == "sparsified":
        scfg = dict(weight_pattern="8:16", outlier_pattern="16:256")
        jparams = jax_harness.sparsify_model(JCFG, jparams, jstats,
                                             JaxSparsifyConfig(**scfg))
        tparams = harness.sparsify_model(CFG, tparams, stats_from_jax(jstats),
                                         SparsifyConfig(**scfg))
    kw = dict(vocab=JCFG.vocab, seq_len=32, batch=2, seed=0)
    want = jax_harness.eval_ppl(JCFG, jparams, JaxSyntheticLM(**kw),
                                n_batches=2)
    got = harness.eval_ppl(CFG, tparams, SyntheticLM(**kw), n_batches=2)
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def _agree(ours, theirs):
    """Share of equal entries; assert >= AGREE and return the mask."""
    same = ours == theirs
    assert same.mean() >= AGREE, same.mean()
    return same


@pytest.mark.parametrize("cfg", [dict(), dict(unstructured_outliers=True),
                                 dict(weight_pattern="2:4",
                                      outlier_pattern="4:256")],
                         ids=["ria+sq+vc", "unstructured", "2:4+4:256"])
def test_sparsify_model_matches_jax(model, cfg):
    """Dense-effective params of every projection on JAX's statistics: the
    kept positions agree, and the values there."""
    jparams, tparams, _, jstats = model
    jnew = jax_harness.sparsify_model(JCFG, jparams, jstats,
                                      JaxSparsifyConfig(**cfg))
    tnew = harness.sparsify_model(CFG, tparams, stats_from_jax(jstats),
                                  SparsifyConfig(**cfg))
    for i in range(CFG.n_layers):
        for p in PROJ:
            ours = tnew["layers"][i][p].numpy()
            theirs = np.asarray(jnew["layers"][p][i])
            same = _agree(ours != 0, theirs != 0)
            np.testing.assert_allclose(ours[same], theirs[same], **VALUE_TOL)
        np.testing.assert_array_equal(tnew["layers"][i]["attn_norm"].numpy(),
                                      np.asarray(jnew["layers"]["attn_norm"][i]))
    np.testing.assert_array_equal(tnew["lm_head"].numpy(),
                                  np.asarray(jparams["lm_head"]))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_sparsify_for_serving_with_stats_matches_jax(model, quantize):
    """Per-leaf statistics (``layers/{i}/wq``) against JAX's stacked ones:
    the same containers, index for index where near-ties do not flip."""
    _, tparams, _, jstats = model
    scfg = dict(weight_pattern="8:16", outlier_pattern="16:256")
    jsparse, jrep = _jax_serving_layers(model, scfg, quantize)
    tsparse, trep = sparsify_for_serving(
        tparams, SparsifyConfig(**scfg), stats_from_jax(jstats),
        quantize=quantize)
    for key in ("n_layers_sparsified", "dense_bytes", "compressed_bytes"):
        assert trep[key] == jrep[key]
    for i in range(CFG.n_layers):
        for p in PROJ:
            sw, jsw = tsparse["layers"][i][p], jsparse["layers"][i][p]
            assert (sw.n, sw.m, sw.o_n, sw.in_dim) == \
                (jsw.n, jsw.m, jsw.o_n, jsw.in_dim)
            nm_same = _agree(unpack_metadata(sw.nm_meta, sw.n).numpy(),
                             unpack_metadata(to_torch(jsw.nm_meta),
                                             sw.n).numpy())
            o_same = _agree(unpack_outlier_meta(sw.o_meta, sw.o_n).numpy(),
                            unpack_outlier_meta(to_torch(jsw.o_meta),
                                                sw.o_n).numpy())
            ov, jov = sw.o_values.numpy(), np.asarray(jsw.o_values)
            np.testing.assert_array_equal(ov[o_same], jov[o_same])
            if quantize:
                np.testing.assert_allclose(sw.v_scale.numpy(),
                                           np.asarray(jsw.v_scale),
                                           **VALUE_TOL)
                continue
            nv = sw.nm_values.numpy().reshape(nm_same.shape)
            jnv = np.asarray(jsw.nm_values).reshape(nm_same.shape)
            np.testing.assert_allclose(nv[nm_same], jnv[nm_same], **VALUE_TOL)


def test_ria_without_stats_raises_in_both(model):
    """The reference's default scorer needs statistics: without them
    ``sparsify_for_serving`` raises in both packages (in ``score``)."""
    jparams, tparams, _, _ = model
    with pytest.raises(ValueError, match="ria requires activation stats"):
        jax_sparsify_for_serving(jparams, JaxSparsifyConfig())
    with pytest.raises(ValueError, match="ria requires activation stats"):
        sparsify_for_serving(tparams, SparsifyConfig())
