"""The port's offline pipeline (``repro_torch.core``) against the JAX
package's on the same numpy inputs: patterns, packing, variance correction,
scoring, equalization, outliers, ``sparsify_linear`` over the config grid of
the paper's tables, ``dense_effective_weight`` and ``sparsify_tree``.

Tolerances and why:

- Scores (RIA's row and column sums, Wanda, SmoothQuant's alpha form) are
  f32 reductions and powers that torch and XLA round in another order:
  held to ``SCORE_RTOL`` = 1e-6 relative (measured up to 5.4e-7 at
  [1024, 4096]).
- Selection is held bit for bit: masks, indices, packed words and the
  salient values, which are copies of the weights.  Where both packages
  select on one score matrix (JAX's, fed to the port) that holds on any
  input.  End to end it holds on "dyadic" inputs (``_dyadic``): weights
  k/4, squared-activation sums t**4 (so ||x_j|| = t**2 and its square root
  are exact) and max-abs statistics that make every SmoothQuant scale a
  power of two.  Every sum, quotient and product in the scores is then
  exact or one correctly rounded IEEE operation on identical operands, so
  the two packages' scores are identical and only exact ties remain, which
  both break toward the lower index.  On random inputs a one-ulp score
  difference may flip a near-tie: there the share of agreeing indices is
  held at >= 0.999 (``test_random_inputs_agree``).
- Variance-corrected values are held to ``VALUE_TOL`` (the factor is a
  ratio of two f32 sums over the matrix), and to one bf16 ulp for bf16
  weights; without correction they are exact.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import equalize as jeq  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.core import variance as jvar  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import equalize as teq  # noqa: E402
from repro_torch.core import variance as tvar  # noqa: E402
from repro_torch.interchange import sparsified_from_jax, to_torch  # noqa: E402

SCORE_RTOL = 1e-6
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=0)
ALL_PATTERNS = list(jcore.WEIGHT_PATTERNS) + list(jcore.OUTLIER_PATTERNS)
OUT, IN = 64, 512


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _j(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _pair(a, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, to_torch(np.asarray(j))


def _stats_pair(sq_sum, max_abs, count):
    j = jcore.ActStats(sq_sum=jnp.asarray(sq_sum, jnp.float32),
                       max_abs=jnp.asarray(max_abs, jnp.float32),
                       count=jnp.asarray(count, jnp.float32))
    t = tcore.ActStats(sq_sum=torch.tensor(sq_sum, dtype=torch.float32),
                       max_abs=torch.tensor(max_abs, dtype=torch.float32),
                       count=torch.tensor(count, dtype=torch.float32))
    return j, t


def _random(seed=0, shape=(OUT, IN)):
    """The JAX tests' setting: gaussian weights, activations with a few
    outlier channels (x25)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((128, shape[1])).astype(np.float32)
    x[:, :8] *= 25.0
    return w, x


def _dyadic(seed=0, shape=(OUT, IN)):
    """Weights k/4 and statistics under which every score is exact (module
    docstring): (w, sq_sum, max_abs)."""
    rng = np.random.default_rng(seed)
    w = (rng.integers(-8, 9, size=shape) / 4).astype(np.float32)
    w[0] = np.where(w[0] == 0, 0.25, w[0])        # no all-zero column
    t = rng.integers(1, 9, size=shape[1]).astype(np.float32)
    w_max = np.abs(w).max(axis=0)
    max_abs = (w_max * 2.0 ** rng.integers(-2, 3, size=shape[1])
               ).astype(np.float32)
    return w, t ** 4, max_abs


def _stats_of(x):
    """ActStats of x in both packages, and the port's copy of JAX's (so that
    scores see identical statistics)."""
    js = jcore.ActStats.init(x.shape[-1]).update(jnp.asarray(x))
    ts = tcore.ActStats.init(x.shape[-1]).update(torch.from_numpy(x))
    same = tcore.ActStats(sq_sum=to_torch(np.asarray(js.sq_sum)),
                          max_abs=to_torch(np.asarray(js.max_abs)),
                          count=to_torch(np.asarray(js.count)))
    return js, ts, same


# ------------------------------------------------------------------ patterns

@pytest.mark.parametrize("n,m", ALL_PATTERNS)
def test_pattern_accounting_matches_jax(n, m):
    jp, tp = jcore.Pattern(n, m), tcore.Pattern(n, m)
    assert (tp.density, tp.configurations, str(tp)) == \
        (jp.density, jp.configurations, str(jp))
    for kw in ({}, {"pack_blocks": 2}, {"word_align": True}):
        assert tp.bits_per_element(**kw) == jp.bits_per_element(**kw)
    assert tp.paper_bits_per_element() == jp.paper_bits_per_element()


def test_paper_table1_metadata():
    """Paper Table 1: configurations and bits per element."""
    expected = {(2, 4): (6, 0.75), (4, 8): (70, 0.8125),
                (8, 16): (12870, 0.875), (16, 32): (601080390, 1.0)}
    for (n, m), (cfgs, bits) in expected.items():
        p = tcore.Pattern(n, m)
        assert p.configurations == cfgs
        assert p.paper_bits_per_element() == pytest.approx(bits)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n,m", ALL_PATTERNS)
def test_masks_and_indices_match_jax(n, m, ties):
    """nm_mask, block_topn_indices and the N:M invariant on the same scores
    (with ``ties``, a few distinct values: the lower-index rule decides)."""
    s = np.abs(np.random.default_rng(n * m).standard_normal((8, 4 * m)))
    if ties:
        s = np.round(s * 2) / 2
    js_, ts_ = _pair(s.astype(np.float32))
    jm, tm = jcore.nm_mask(js_, (n, m)), tcore.nm_mask(ts_, (n, m))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        tcore.block_topn_indices(ts_, n, m).numpy(),
        np.asarray(jcore.block_topn_indices(js_, n, m)))
    assert tcore.validate_nm_mask(tm, (n, m)) and \
        bool(jcore.validate_nm_mask(jm, (n, m)))
    assert float(tcore.mask_sparsity(tm)) == pytest.approx(1 - n / m)
    assert float(tcore.mask_sparsity(tm)) == float(jcore.mask_sparsity(jm))
    broken = tm.clone()
    broken[0, 0] = ~broken[0, 0]
    assert not tcore.validate_nm_mask(broken, (n, m))
    assert not bool(jcore.validate_nm_mask(jnp.asarray(broken.numpy()),
                                           (n, m)))


def test_mask_keeps_topn():
    scores = torch.tensor([[5.0, 1.0, 4.0, 2.0, 9.0, 8.0, 7.0, 6.0]])
    assert tcore.topn_block_mask(scores, 2, 4).tolist() == \
        [[True, False, True, False, True, True, False, False]]


# ------------------------------------------------------------------- packing

@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (8, 16)])
def test_packed_nm_matches_jax(n, m):
    w, _ = _random(1)
    jw, tw = _pair(w)
    jmask = jcore.nm_mask(jnp.abs(jw), (n, m))
    tmask = tcore.nm_mask(tw.abs(), (n, m))
    jpk = jcore.pack_nm(jnp.where(jmask, jw, 0), jmask, (n, m))
    tpk = tcore.pack_nm(torch.where(tmask, tw, 0.0), tmask, (n, m))
    assert (tpk.out_dim, tpk.n_blocks) == (jpk.out_dim, jpk.n_blocks)
    np.testing.assert_array_equal(tpk.to_dense().numpy(),
                                  np.asarray(jpk.to_dense()))
    np.testing.assert_array_equal(tpk.to_dense().numpy(),
                                  np.where(np.asarray(jmask), w, 0))
    np.testing.assert_array_equal(tpk.packed_metadata().numpy(),
                                  np.asarray(jpk.packed_metadata()))
    np.testing.assert_array_equal(
        tcore.unpack_metadata(tpk.packed_metadata(), n).numpy(),
        tpk.indices.numpy())
    for value_bytes in (1, 2):
        assert tpk.storage_bytes(value_bytes) == \
            jpk.storage_bytes(value_bytes)


@pytest.mark.parametrize("outlier_pattern", [None, "4:256", "16:256"])
@pytest.mark.parametrize("weight_pattern", ["2:4", "4:8", "8:16"])
def test_compression_report_matches_jax(weight_pattern, outlier_pattern):
    for shape in ((4096, 4096), (14336, 4096), (96, 512)):
        assert tcore.compression_report(*shape, weight_pattern,
                                        outlier_pattern) == \
            jcore.compression_report(*shape, weight_pattern, outlier_pattern)
    assert tcore.dense_bytes(7, 9, 4) == jcore.packing.dense_bytes(7, 9, 4)


# ------------------------------------------------------------------ variance

@pytest.mark.parametrize("per_row", [False, True], ids=["matrix", "row"])
@pytest.mark.parametrize("mask_kind", ["nm", "empty_row"])
def test_variance_correction_matches_jax(per_row, mask_kind):
    """Factor and corrected weights, per matrix and per row; a row that
    kept nothing stays zero with a finite factor (``max(n, 1)`` guards its
    mean)."""
    w, _ = _random(2)
    mask = np.array(jcore.nm_mask(jnp.abs(jnp.asarray(w)), (2, 4)))
    if mask_kind == "empty_row":
        mask[3] = False
    jf = jvar.variance_correction_factor(jnp.asarray(w), jnp.asarray(mask),
                                         per_row)
    tf = tvar.variance_correction_factor(torch.from_numpy(w),
                                         torch.from_numpy(mask), per_row)
    assert tuple(tf.shape) == tuple(jf.shape)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)
    jc = np.asarray(jvar.apply_variance_correction(
        jnp.asarray(w), jnp.asarray(mask), per_row))
    tc = tvar.apply_variance_correction(torch.from_numpy(w),
                                        torch.from_numpy(mask), per_row)
    np.testing.assert_allclose(tc.numpy(), jc, **VALUE_TOL)
    assert (tc.numpy()[~mask] == 0).all()
    if per_row:
        kept = tc.numpy()[mask]
        assert np.isfinite(tc.numpy()).all() and kept.size
    else:                       # the kept weights' variance is the dense one
        assert tc.numpy()[mask].var() == pytest.approx(w.var(), rel=1e-3)


# ------------------------------------------------------------------- scoring

def test_act_stats_match_jax():
    _, x = _random(3)
    js = jcore.ActStats.init(IN)
    ts = tcore.ActStats.init(IN)
    for chunk in np.split(x, 4):
        js = js.update(jnp.asarray(chunk))
        ts = ts.update(torch.from_numpy(chunk))
    assert ts.count.dtype == torch.float32 and ts.count.ndim == 0
    assert float(ts.count) == float(js.count) == 128.0
    np.testing.assert_allclose(ts.sq_sum.numpy(), np.asarray(js.sq_sum),
                               rtol=SCORE_RTOL)
    np.testing.assert_array_equal(ts.max_abs.numpy(), np.asarray(js.max_abs))
    np.testing.assert_allclose(ts.l2.numpy(), np.asarray(js.l2),
                               rtol=SCORE_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method,alpha", [("magnitude", 0.5), ("wanda", 0.5),
                                          ("ria", 0.5), ("ria", 1.0)])
def test_scores_match_jax(method, alpha, dtype):
    """Scores on the same weights and statistics; RIA in f32 whatever the
    weights' dtype, Wanda promoted to f32 as JAX promotes."""
    w, x = _random(4)
    jw, tw = _pair(w, dtype)
    js, _, same = _stats_of(x)
    jscore = jcore.score(method, jw, js, alpha)
    tscore = tcore.score(method, tw, same, alpha)
    assert tscore.dtype == to_torch(np.asarray(jscore)).dtype
    np.testing.assert_allclose(_np(tscore), _j(jscore), rtol=SCORE_RTOL)
    if method != "magnitude":       # activation outlier channels score high
        assert float(tscore[:, :8].mean()) > float(tscore[:, 8:].mean())


@pytest.mark.parametrize("method", ["wanda", "ria"])
def test_scores_require_stats(method):
    with pytest.raises(ValueError, match="requires activation stats"):
        jcore.score(method, jnp.ones((4, 16)))
    with pytest.raises(ValueError, match="requires activation stats"):
        tcore.score(method, torch.ones(4, 16))


# ---------------------------------------------------------------- equalize

@pytest.mark.parametrize("alpha", [None, 0.5, 0.8])
def test_smoothquant_scales_match_jax(alpha):
    """Eq. 1's scales and the SmoothQuant interpolation; a dead channel
    (max|x| = 0) gets scale 1 in both."""
    w, x = _random(5)
    js, _, same = _stats_of(x)
    max_abs = np.asarray(js.max_abs).copy()
    max_abs[5] = 0.0
    jsc = jeq.smoothquant_scales(jnp.asarray(w), jnp.asarray(max_abs), alpha)
    tsc = teq.smoothquant_scales(torch.from_numpy(w),
                                 torch.from_numpy(max_abs), alpha)
    assert float(tsc[5]) == 1.0
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=SCORE_RTOL)
    view_j = jeq.equalized_view_for_scoring(jnp.asarray(w),
                                            jnp.asarray(max_abs), alpha)
    view_t = teq.equalized_view_for_scoring(torch.from_numpy(w),
                                            torch.from_numpy(max_abs), alpha)
    np.testing.assert_allclose(view_t.numpy(), np.asarray(view_j),
                               rtol=SCORE_RTOL)


def test_eq1_invariant_matches_jax():
    """(W*s)(x/s) == W x (Eq. 1), in both packages."""
    w, x = _random(6)
    js, _, _ = _stats_of(x)
    scales = np.array(jeq.smoothquant_scales(jnp.asarray(w), js.max_abs))
    lhs, rhs = teq.check_equivalence(torch.from_numpy(w), torch.from_numpy(x),
                                     torch.from_numpy(scales))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-4, atol=1e-3)
    jl, _ = jeq.check_equivalence(jnp.asarray(w), jnp.asarray(x),
                                  jnp.asarray(scales))
    np.testing.assert_allclose(lhs.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_equalized_view_dyadic_is_exact(dtype):
    """Scales that are powers of two: the view (rounded to the weights'
    dtype, as in JAX) is identical."""
    w, _, max_abs = _dyadic(7)
    jw, tw = _pair(w, dtype)
    jv = jeq.equalized_view_for_scoring(jw, jnp.asarray(max_abs))
    tv = teq.equalized_view_for_scoring(tw, torch.from_numpy(max_abs))
    assert tv.dtype == tw.dtype
    np.testing.assert_array_equal(_np(tv), _j(jv))


# ------------------------------------------------------------------ outliers

@pytest.mark.parametrize("pattern", ["4:256", "8:256", "16:256"])
def test_structured_outliers_match_jax(pattern):
    """The port's selection on JAX's RIA scores: indices, values, masks and
    the dense scatter bit for bit."""
    w, x = _random(8)
    js, _, _ = _stats_of(x)
    jscore = jcore.score("ria", jnp.asarray(w), js)
    tscore = to_torch(np.asarray(jscore))
    jo = jcore.extract_structured_outliers(jnp.asarray(w), jscore, pattern)
    to = tcore.extract_structured_outliers(torch.from_numpy(w), tscore,
                                           pattern)
    assert (to.out_dim, to.in_dim, to.n, to.m) == \
        (jo.out_dim, jo.in_dim, jo.n, jo.m)
    np.testing.assert_array_equal(to.indices.numpy(), np.asarray(jo.indices))
    np.testing.assert_array_equal(to.values.numpy(), np.asarray(jo.values))
    np.testing.assert_array_equal(to.mask().numpy(), np.asarray(jo.mask()))
    dense = to.to_dense().numpy()
    np.testing.assert_array_equal(dense, np.asarray(jo.to_dense()))
    mask = to.mask().numpy()
    assert mask.sum() == OUT * (IN // 256) * to.n
    np.testing.assert_array_equal(dense[mask], w[mask])
    assert (dense[~mask] == 0).all()
    np.testing.assert_array_equal(
        tcore.structured_outlier_mask(tscore, pattern).numpy(),
        np.asarray(jcore.outliers.structured_outlier_mask(jscore, pattern)))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("budget", [4 / 256, 8 / 256, 16 / 256])
def test_unstructured_outlier_mask_matches_jax(budget, ties):
    """Global top-k at the budget: "at least the k-th largest" on the same
    scores, ties at the threshold kept in both."""
    w, x = _random(9)
    js, _, _ = _stats_of(x)
    s = np.array(jcore.score("ria", jnp.asarray(w), js))
    if ties:                           # few distinct values
        s = np.round(s * 4 / s.max(), 1).astype(np.float32)
    jm = np.asarray(jcore.unstructured_outlier_mask(jnp.asarray(s), budget))
    tm = tcore.unstructured_outlier_mask(torch.from_numpy(s), budget).numpy()
    np.testing.assert_array_equal(tm, jm)
    k = max(1, int(round(budget * s.size)))
    if ties:
        assert tm.sum() > k            # the threshold's ties are all in
    else:
        assert tm.mean() == pytest.approx(budget, rel=0.05)


# ------------------------------------------------------------------ pipeline

def _assert_sparsified_equal(t, j, values_tol):
    """A port SparsifiedLinear against a JAX one (carried across): selection
    bit for bit, corrected values to ``values_tol``."""
    jt = sparsified_from_jax(j)
    for name in ("nm_mask", "salient_mask", "effective_mask",
                 "nonsalient_kept_mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(jt, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(t.nm.indices.numpy(), jt.nm.indices.numpy())
    np.testing.assert_array_equal(t.nm.packed_metadata().numpy(),
                                  np.asarray(j.nm.packed_metadata()))
    assert (t.nm.n, t.nm.m, t.nm.in_dim) == (jt.nm.n, jt.nm.m, jt.nm.in_dim)
    assert (t.outliers is None) == (jt.outliers is None)
    if t.outliers is not None:
        np.testing.assert_array_equal(t.outliers.indices.numpy(),
                                      jt.outliers.indices.numpy())
        np.testing.assert_array_equal(_np(t.outliers.values),
                                      _np(jt.outliers.values))
        np.testing.assert_array_equal(
            tcore.pack_outlier_meta(t.outliers.indices).numpy(),
            tcore.pack_outlier_meta(jt.outliers.indices).numpy())
    if values_tol is None:
        np.testing.assert_array_equal(_np(t.nm.values), _np(jt.nm.values))
    else:
        np.testing.assert_allclose(_np(t.nm.values), _np(jt.nm.values),
                                   **values_tol)
        np.testing.assert_allclose(_np(t.to_dense()), _j(j.to_dense()),
                                   **values_tol)


GRID = [dict(weight_pattern=wp, outlier_pattern=op, use_smoothquant=sq,
             use_variance_correction=vc, unstructured_outliers=un)
        for wp in ("2:4", "8:16")
        for op in (None, "4:256", "16:256")
        for sq in (True, False)
        for vc in (True, False)
        for un in ((False, True) if op else (False,))]


def _grid_id(c):
    return (f"{c['weight_pattern']}+{c['outlier_pattern']}"
            f"{'+sq' if c['use_smoothquant'] else ''}"
            f"{'+vc' if c['use_variance_correction'] else ''}"
            f"{'+unstructured' if c['unstructured_outliers'] else ''}")


@pytest.mark.parametrize("cfg", GRID, ids=[_grid_id(c) for c in GRID])
def test_sparsify_linear_grid_matches_jax(cfg):
    """RIA (the default scorer) over patterns {2:4, 8:16} x outliers {None,
    4:256, 16:256} x SmoothQuant x variance correction x unstructured, on
    dyadic inputs: end to end bit for bit, as is
    ``dense_effective_weight``."""
    w, sq_sum, max_abs = _dyadic(10)
    jst, tst = _stats_pair(sq_sum, max_abs, 128.0)
    jw, tw = _pair(w)
    jcfg, tcfg = jcore.SparsifyConfig(**cfg), tcore.SparsifyConfig(**cfg)
    j = jcore.sparsify_linear(jw, jst, jcfg)
    t = tcore.sparsify_linear(tw, tst, tcfg)
    tol = VALUE_TOL if cfg["use_variance_correction"] else None
    _assert_sparsified_equal(t, j, tol)
    if cfg["unstructured_outliers"]:
        assert t.outliers is None and bool(t.salient_mask.any())
    te = tcore.dense_effective_weight(tw, t, tcfg).numpy()
    je = np.asarray(jcore.dense_effective_weight(jw, j, jcfg))
    if tol is None:
        np.testing.assert_array_equal(te, je)
    else:
        np.testing.assert_allclose(te, je, **tol)
    salient = t.salient_mask.numpy()
    np.testing.assert_array_equal(te[salient], w[salient])   # exact


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", [
    dict(scorer="magnitude"), dict(scorer="wanda"),
    dict(scorer="wanda", use_smoothquant=False), dict(ria_alpha=1.0),
    dict(vc_per_row=True), dict(weight_pattern="4:8", outlier_pattern="8:256"),
], ids=["magnitude", "wanda+sq", "wanda", "ria_alpha1", "vc_per_row",
        "4:8+8:256"])
def test_sparsify_linear_variants_match_jax(variant, dtype):
    """The other scorers, RIA's alpha, per-row correction and the 4:8
    pattern, on dyadic weights in f32 and bf16 (exact in both)."""
    w, sq_sum, max_abs = _dyadic(11)
    jst, tst = _stats_pair(sq_sum, max_abs, 64.0)
    jw, tw = _pair(w, dtype)
    j = jcore.sparsify_linear(jw, jst, jcore.SparsifyConfig(**variant))
    t = tcore.sparsify_linear(tw, tst, tcore.SparsifyConfig(**variant))
    _assert_sparsified_equal(t, j, VALUE_TOL if dtype == "float32"
                             else BF16_TOL)


@pytest.mark.parametrize("cfg", [dict(), dict(weight_pattern="2:4",
                                              outlier_pattern="4:256"),
                                 dict(sq_alpha=0.5)],
                         ids=["ria+sq+vc", "2:4+4:256", "sq_alpha"])
def test_random_inputs_agree(cfg):
    """Random weights and calibration statistics computed by each package:
    scores to SCORE_RTOL and selection agreeing on >= 0.999 of the
    indices (near-ties may flip on a one-ulp score difference)."""
    w, x = _random(12, (128, 1024))
    js, ts, _ = _stats_of(x)
    jcfg, tcfg = jcore.SparsifyConfig(**cfg), tcore.SparsifyConfig(**cfg)
    j = jcore.sparsify_linear(jnp.asarray(w), js, jcfg)
    t = tcore.sparsify_linear(torch.from_numpy(w), ts, tcfg)
    for tv, jv in ((t.nm.indices, j.nm.indices),
                   (t.outliers.indices, j.outliers.indices)):
        assert (tv.numpy() == np.asarray(jv)).mean() >= 0.999


def test_pipeline_properties():
    """The JAX package's pipeline properties, held by the port: the N:M
    invariant, density, exact salient values, outliers reducing the
    layer's output error (paper Table 5), and stored weights untouched by
    the equalized view."""
    w, x = _random(13)
    _, ts, _ = _stats_of(x)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    cfg = tcore.SparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256")
    sl = tcore.sparsify_linear(tw, ts, cfg)
    assert tcore.validate_nm_mask(sl.nm_mask, "8:16")
    eff = tcore.dense_effective_weight(tw, sl, cfg)
    assert 0.45 <= float((eff != 0).float().mean()) <= 0.57
    sm = sl.salient_mask
    assert torch.equal(eff[sm], tw[sm])
    y_ref = tx @ tw.T
    errs = {}
    for op in (None, "4:256", "16:256"):
        c = tcore.SparsifyConfig(weight_pattern="2:4", outlier_pattern=op)
        e = tcore.dense_effective_weight(tw, tcore.sparsify_linear(tw, ts, c),
                                         c)
        errs[op] = float(((tx @ e.T - y_ref) ** 2).mean())
    assert errs["16:256"] < errs["4:256"] < errs[None]
    c = dataclasses.replace(cfg, outlier_pattern=None,
                            use_variance_correction=False)
    e = tcore.dense_effective_weight(tw, tcore.sparsify_linear(tw, ts, c), c)
    kept = e != 0
    assert torch.equal(e[kept], tw[kept])


def test_config_matches_jax_field_by_field():
    """``SparsifyConfig()`` means the same in both packages: the fields, in
    the same order, with the same defaults."""
    jf = dataclasses.fields(jcore.SparsifyConfig)
    tf = dataclasses.fields(tcore.SparsifyConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert dataclasses.asdict(tcore.SparsifyConfig()) == \
        dataclasses.asdict(jcore.SparsifyConfig())


# -------------------------------------------------------------------- trees

def _tree_pair(seed):
    """A 2-layer JAX params tree (stacked [L, ...]) and the port's layer
    list: in-dim 256 (N:M + outliers), 64 (N:M only), 24 (left dense at
    8:16), plus leaves the walk skips."""
    rng = np.random.default_rng(seed)
    shapes = {"wq": (32, 256), "w_up": (64, 256), "w_down": (32, 64),
              "w_odd": (16, 24)}
    layers = {k: (rng.integers(-8, 9, size=(2, *s)) / 4).astype(np.float32)
              for k, s in shapes.items()}
    layers["attn_norm"] = np.zeros((2, 256), np.float32)
    embed = rng.standard_normal((32, 256)).astype(np.float32)
    jtree = {"embed": jnp.asarray(embed),
             "layers": {k: jnp.asarray(v) for k, v in layers.items()}}
    ttree = {"embed": torch.from_numpy(embed),
             "layers": [{k: torch.from_numpy(v[i].copy())
                         for k, v in layers.items()} for i in range(2)]}
    stats = {}
    for name in ("wq", "w_up"):             # w_down has none: magnitude
        in_dim = shapes[name][1]
        t = rng.integers(1, 9, size=(2, in_dim)).astype(np.float32)
        w_max = np.abs(layers[name]).max(axis=1)
        max_abs = w_max * 2.0 ** rng.integers(-2, 3, size=(2, in_dim))
        stats[name] = (t ** 4, max_abs.astype(np.float32),
                       np.array([64.0, 96.0], np.float32))
    jstats = {f"layers/{k}": jcore.ActStats(*map(jnp.asarray, v))
              for k, v in stats.items()}
    return jtree, ttree, jstats


@pytest.mark.parametrize("cfg", [dict(), dict(unstructured_outliers=True),
                                 dict(scorer="magnitude")],
                         ids=["ria+sq+vc", "unstructured", "magnitude"])
def test_sparsify_tree_stacked_vs_listed(cfg):
    """JAX vmaps over the stacked [L, out, in] leaves with [L, in] stats;
    the port loops over its layer list with each layer's slice of them
    (``stats_from_jax``, count included).  Fallbacks as in JAX: magnitude
    without stats, dense where in_dim % 16, no outliers where in_dim %
    256."""
    from repro_torch.interchange import stats_from_jax
    jtree, ttree, jstats = _tree_pair(14)
    tstats = stats_from_jax(jstats)
    assert float(tstats["layers/1/wq"].count) == 96.0
    jcfg, tcfg = jcore.SparsifyConfig(**cfg), tcore.SparsifyConfig(**cfg)
    jnew, jrec = jcore.sparsify_tree(jtree, jstats, jcfg)
    tnew, trec = tcore.sparsify_tree(ttree, tstats, tcfg)
    assert sorted(trec) == sorted(f"layers/{i}/{k}" for i in range(2)
                                  for k in ("wq", "w_up", "w_down"))
    assert sorted(jrec) == ["layers/w_down", "layers/w_up", "layers/wq"]
    for i in range(2):
        for name in ("wq", "w_up", "w_down", "w_odd", "attn_norm"):
            np.testing.assert_allclose(tnew["layers"][i][name].numpy(),
                                       np.asarray(jnew["layers"][name][i]),
                                       **VALUE_TOL)
        np.testing.assert_array_equal(tnew["layers"][i]["w_odd"].numpy(),
                                      np.asarray(jtree["layers"]["w_odd"][i]))
        for name in ("wq", "w_up", "w_down"):
            jl = _slice_record(jrec[f"layers/{name}"], i)
            _assert_sparsified_equal(trec[f"layers/{i}/{name}"], jl,
                                     VALUE_TOL)
        assert trec[f"layers/{i}/w_down"].outliers is None
    np.testing.assert_array_equal(tnew["embed"].numpy(),
                                  np.asarray(jtree["embed"]))


def _slice_record(sl, i):
    """Layer ``i`` of a vmapped JAX SparsifiedLinear."""
    import jax
    return jax.tree.map(lambda a: a[i], sl)


@pytest.mark.parametrize("path,prunable", [
    ("layers/0/wq", True), ("layers/wq", True), ("embed", False),
    ("layers/0/attn_norm", False), ("lm_head", False), ("router/w", False),
    ("layers/0/pos_emb", False)])
def test_default_prunable_matches_jax(path, prunable):
    leaf = np.zeros((4, 8), np.float32)
    assert tcore.default_prunable(path, torch.from_numpy(leaf)) == prunable
    assert jpipeline.default_prunable(path, jnp.asarray(leaf)) == prunable
    assert not tcore.default_prunable(path, torch.zeros(8))
