"""The port's compression (core/ + sparsify_for_serving) against the JAX
package on the same seeded weights: indices and packed words bit for bit,
values to f32 rounding."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.core import sparsify_linear as jax_sparsify_linear  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify_for_serving  # noqa: E402
from repro_torch.core import SparsifyConfig, sparsify_linear  # noqa: E402
from repro_torch.interchange import to_torch  # noqa: E402
from repro_torch.models.sparse_serving import sparsify_for_serving  # noqa: E402

PATTERNS = [("8:16", "16:256"), ("8:16", None), ("2:4", None)]

# The variance-correction factor is a ratio of two f32 sums over the whole
# matrix.  JAX's XLA-CPU reduction of those sums is itself off by up to
# ~5e-6 relative to a float64 reference on the tie-heavy inputs (by ~2e-7
# on the random ones), while the port's stays within 1e-6; so the port's
# values are held to 1e-6 of the float64 reference and to 1e-5 of JAX's.
# Every index, mask and packed word is compared exactly.
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)


def _weight(seed, shape, ties, dtype):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if ties:
        # few distinct magnitudes: most 16-blocks hold several equal scores,
        # so the selection depends on the lower-index tie rule
        w = np.round(w * 2) / 2
    jw = jnp.asarray(w).astype(dtype)
    return jw, to_torch(np.asarray(jw))


def _cfgs(weight_pattern, outlier_pattern):
    kw = dict(weight_pattern=weight_pattern, outlier_pattern=outlier_pattern,
              scorer="magnitude", use_smoothquant=False)
    return JaxSparsifyConfig(**kw), SparsifyConfig(**kw)


def _corrected_values_f64(w, js):
    """The packed N:M values recomputed in float64 from JAX's masks."""
    w = w.astype(np.float64)
    kept = np.asarray(js.nm_mask) & ~np.asarray(js.salient_mask)
    factor = np.sqrt(w.var() / (w[kept].var() + 1e-12))
    corr = np.where(kept, w * factor, 0.0)
    out, in_dim = w.shape
    idx = np.asarray(js.nm.indices)
    blocks = corr.reshape(out, in_dim // js.nm.m, js.nm.m)
    return np.take_along_axis(blocks, idx, axis=-1).reshape(out, -1)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("weight_pattern,outlier_pattern", PATTERNS)
def test_sparsify_linear_matches_jax(weight_pattern, outlier_pattern, ties):
    jw, tw = _weight(0, (64, 512), ties, jnp.float32)
    jcfg, tcfg = _cfgs(weight_pattern, outlier_pattern)
    js = jax_sparsify_linear(jw, None, jcfg)
    ts = sparsify_linear(tw, None, tcfg)
    np.testing.assert_array_equal(ts.nm.indices.numpy(),
                                  np.asarray(js.nm.indices))
    np.testing.assert_array_equal(ts.nm.packed_metadata().numpy(),
                                  np.asarray(js.nm.packed_metadata()))
    np.testing.assert_array_equal(ts.nm_mask.numpy(), np.asarray(js.nm_mask))
    np.testing.assert_array_equal(ts.salient_mask.numpy(),
                                  np.asarray(js.salient_mask))
    np.testing.assert_allclose(ts.nm.values.numpy(), np.asarray(js.nm.values),
                               **VALUE_TOL)
    np.testing.assert_allclose(ts.nm.values.numpy(),
                               _corrected_values_f64(np.asarray(jw), js),
                               rtol=1e-6, atol=1e-7)
    if outlier_pattern is None:
        assert ts.outliers is None and js.outliers is None
    else:
        np.testing.assert_array_equal(ts.outliers.indices.numpy(),
                                      np.asarray(js.outliers.indices))
        # outliers are copies of the weights: exact
        np.testing.assert_array_equal(ts.outliers.values.numpy(),
                                      np.asarray(js.outliers.values))


def _small_params(seed, dtype):
    """A two-layer params tree with projections of in-dim 128 (too narrow
    for a 256-block: outliers dropped) and 256 (outliers kept)."""
    rng = np.random.default_rng(seed)
    layers = {name: rng.standard_normal((2, out, d_in)).astype(np.float32)
              for name, out, d_in in [("wq", 128, 128), ("wo", 128, 128),
                                      ("w_up", 256, 128),
                                      ("w_down", 128, 256)]}
    layers["attn_norm"] = np.zeros((2, 128), np.float32)
    tree = {"embed": rng.standard_normal((64, 128)).astype(np.float32),
            "layers": layers}
    jtree = {"embed": jnp.asarray(tree["embed"]).astype(dtype),
             "layers": {k: jnp.asarray(v).astype(dtype)
                        for k, v in layers.items()}}
    ttree = {"embed": to_torch(np.asarray(jtree["embed"])),
             "layers": [{k: to_torch(np.asarray(v[i]))
                         for k, v in jtree["layers"].items()}
                        for i in range(2)]}
    return jtree, ttree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_pattern,outlier_pattern", PATTERNS)
def test_sparsify_for_serving_matches_jax(weight_pattern, outlier_pattern,
                                          dtype):
    jdt = getattr(jnp, dtype)
    jtree, ttree = _small_params(1, jdt)
    jcfg, tcfg = _cfgs(weight_pattern, outlier_pattern)
    jparams, jrep = jax_sparsify_for_serving(jtree, jcfg)
    tparams, trep = sparsify_for_serving(ttree, tcfg)
    # JAX counts a stacked [L, out, in] leaf once, the port each layer
    assert trep["n_layers_sparsified"] == 2 * jrep["n_layers_sparsified"]
    for key in ("dense_bytes", "compressed_bytes", "ratio"):
        assert trep[key] == pytest.approx(jrep[key])
    for name in ("wq", "wo", "w_up", "w_down"):
        jsw = jparams["layers"][name]
        for i in range(2):
            tsw = tparams["layers"][i][name]
            assert (tsw.n, tsw.m, tsw.o_n, tsw.in_dim) == \
                (jsw.n, jsw.m, jsw.o_n, jsw.in_dim)
            np.testing.assert_array_equal(tsw.nm_meta.numpy(),
                                          np.asarray(jsw.nm_meta[i]))
            assert (tsw.o_values is None) == (jsw.o_values is None)
            if tsw.o_values is not None:
                np.testing.assert_array_equal(tsw.o_meta.numpy(),
                                              np.asarray(jsw.o_meta[i]))
                np.testing.assert_array_equal(
                    _np(tsw.o_values),
                    np.asarray(jsw.o_values[i]).astype(np.float32))
            jv = np.asarray(jsw.nm_values[i]).astype(np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(_np(tsw.nm_values), jv,
                                           **VALUE_TOL)
            else:
                # a bf16 value is the rounding of (f32 weight x factor); the
                # factors differ in the last f32 bits, which moves a rounding
                # by at most one bf16 ulp (2**-7 relative)
                np.testing.assert_allclose(_np(tsw.nm_values), jv,
                                           rtol=2**-7, atol=0)
    # the in-dim-128 leaves lost their outliers, the in-dim-256 one kept them
    if outlier_pattern is not None:
        assert tparams["layers"][0]["wq"].o_values is None
        assert tparams["layers"][0]["w_down"].o_values is not None
    assert isinstance(tparams["embed"], torch.Tensor)


def test_quantize_raises_naming_roadmap():
    _, ttree = _small_params(2, jnp.bfloat16)
    with pytest.raises(NotImplementedError, match="A6"):
        sparsify_for_serving(ttree, _cfgs("8:16", "16:256")[1], quantize=True)


@pytest.mark.parametrize("scorer", ["wanda", "ria"])
def test_unported_scorers_raise_naming_roadmap(scorer):
    cfg = dataclasses.replace(_cfgs("8:16", None)[1], scorer=scorer)
    with pytest.raises(NotImplementedError, match="A7"):
        sparsify_linear(torch.zeros(16, 32), None, cfg)


@pytest.mark.parametrize("field", ["use_smoothquant", "unstructured_outliers"])
def test_unported_modes_raise_naming_roadmap(field):
    cfg = dataclasses.replace(SparsifyConfig(), **{field: True})
    with pytest.raises(NotImplementedError, match="A7"):
        sparsify_linear(torch.zeros(16, 256), None, cfg)


def test_only_dense_family_projections_are_sparsified():
    """Embed, lm_head, norms and leaves of unported families stay dense."""
    rng = np.random.default_rng(3)
    names = ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
             "lm_head", "in_proj", "ws_up", "attn_norm"]
    tree = {"embed": to_torch(rng.standard_normal((64, 256)).astype(np.float32)),
            "layers": [{k: to_torch(rng.standard_normal((32, 256))
                                    .astype(np.float32)) for k in names}]}
    sparse, report = sparsify_for_serving(tree, SparsifyConfig())
    kept = {k for k, v in sparse["layers"][0].items()
            if isinstance(v, torch.Tensor)}
    assert kept == {"lm_head", "in_proj", "ws_up", "attn_norm"}
    assert isinstance(sparse["embed"], torch.Tensor)
    assert report["n_layers_sparsified"] == 7
