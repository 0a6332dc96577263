"""The port's int8 N:M weights against the JAX package's, on the CPU.

- Quantization: the port's rule (``kernels/ref.quantize_int8``) on the N:M
  values of JAX ``_to_sparse_weight(quantize=False)`` gives the int8 bytes
  and ``v_scale`` of JAX ``_to_sparse_weight(quantize=True)`` on the same
  weights, bit for bit, with an all-zero row (scale 1) and rows of exact
  .5 ties (half to even).  The port's whole ``to_sparse_weight(quantize=
  True)`` also recomputes the variance-correction factor, which differs
  from JAX's in the last f32 bits (``test_torch_compress.py``); its int8
  values are held to JAX's within one step, its scales to 1e-6.
- ``sparse_apply`` (the kernels' plain versions, dequantizing as JAX's
  ``sparse_apply`` does) against JAX ``sparse_apply`` at 1e-5 and against
  the Pallas int8 kernels in interpret mode at rtol 2e-5 / atol 2e-4 (the
  tolerance of ``test_kv_quantization.py``'s kernel test), f32, with and
  without outliers.
- At bf16 the plain versions round the dequantized weight to bf16 exactly
  as JAX ``sparse_apply`` does.
- ``sparsify_for_serving(quantize=True)`` reports what JAX's reports, and
  ``from_jax_params`` carries int8 containers across unchanged.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.kernels.fused_sparse_linear import \
    fused_sparse_linear as jax_fused  # noqa: E402
from repro.kernels.nm_spmm import nm_spmm as jax_nm_spmm  # noqa: E402
from repro.models.sparse_serving import _to_sparse_weight  # noqa: E402
from repro.models.sparse_serving import sparse_apply as jax_sparse_apply  # noqa: E402
from repro.models.sparse_serving import \
    sparse_apply_pallas as jax_sparse_apply_pallas  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify_for_serving  # noqa: E402
from repro_torch.core import SparsifyConfig  # noqa: E402
from repro_torch.interchange import (_sparse_weight,  # noqa: E402
                                     from_jax_params, to_torch)
from repro_torch.kernels import fused_sparse_linear as port_fused  # noqa: E402
from repro_torch.kernels import nm_spmm as port_nm  # noqa: E402
from repro_torch.kernels.ref import dequantize, quantize_int8  # noqa: E402
from repro_torch.models.sparse_serving import (SparseWeight,  # noqa: E402
                                               sparse_apply,
                                               sparsify_for_serving,
                                               to_sparse_weight)

OUT, IN = 96, 512
TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TOL = dict(rtol=2e-5, atol=2e-4)
TIES = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                np.float32)


def _jcfg(outlier_pattern, vc=True):
    return JaxSparsifyConfig(weight_pattern="8:16",
                             outlier_pattern=outlier_pattern,
                             scorer="magnitude", use_smoothquant=False,
                             use_variance_correction=vc)


def _weight(seed, dtype="float32"):
    w = np.random.default_rng(seed).standard_normal((OUT, IN)).astype(
        np.float32) / np.sqrt(IN)
    return jnp.asarray(w).astype(getattr(jnp, dtype))


def _tie_weight():
    """Random rows, one all-zero row, and rows whose 16-blocks hold the
    eight values of ``TIES`` and eight zeros: without variance correction
    and outliers the N:M step keeps exactly ``TIES``, whose absmax 127
    makes the scale 1, so each .5 lands on a rounding tie."""
    w = np.array(_weight(5))
    w[7] = 0.0
    block = np.concatenate([TIES, np.zeros(8, np.float32)])
    w[10:14] = np.tile(block, IN // 16)
    return jnp.asarray(w)


def _assert_quantized_like(jsw, q, scale):
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jsw.nm_values))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jsw.v_scale))


@pytest.mark.parametrize("case", ["ties", "f32", "bf16", "f32_outliers"])
def test_quantized_values_bit_identical_to_jax(case):
    if case == "ties":
        w, cfg = _tie_weight(), _jcfg(None, vc=False)
    else:
        w = _weight(1, "bfloat16" if case == "bf16" else "float32")
        cfg = _jcfg("16:256" if case == "f32_outliers" else None)
    jq = _to_sparse_weight(w, cfg, quantize=True)
    values = _to_sparse_weight(w, cfg).nm_values      # the same N:M values
    q, scale = quantize_int8(to_torch(np.asarray(values)))
    _assert_quantized_like(jq, q, scale)
    if case == "ties":
        assert float(scale[7]) == 1.0 and not q[7].any()
        assert (scale[10:14] == 1.0).all()
        assert q[10, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("outlier_pattern", ["16:256", None])
def test_to_sparse_weight_quantized_matches_jax(outlier_pattern, dtype):
    w = _weight(2, dtype)
    jsw = _to_sparse_weight(w, _jcfg(outlier_pattern), quantize=True)
    tsw = to_sparse_weight(to_torch(np.asarray(w)),
                           SparsifyConfig(outlier_pattern=outlier_pattern,
                                          scorer="magnitude",
                                          use_smoothquant=False),
                           quantize=True)
    assert tsw.nm_values.dtype == torch.int8 and tsw.nm_values.is_contiguous()
    np.testing.assert_array_equal(tsw.nm_meta.numpy(), np.asarray(jsw.nm_meta))
    assert (tsw.o_values is None) == (outlier_pattern is None)
    if tsw.o_values is not None:           # the outliers stay exact
        assert tsw.o_values.dtype == to_torch(np.asarray(jsw.o_values)).dtype
        np.testing.assert_array_equal(
            tsw.o_values.float().numpy(),
            np.asarray(jsw.o_values.astype(jnp.float32)))
    np.testing.assert_allclose(tsw.v_scale.numpy(), np.asarray(jsw.v_scale),
                               rtol=1e-6, atol=0)
    step = np.abs(tsw.nm_values.numpy().astype(np.int32)
                  - np.asarray(jsw.nm_values).astype(np.int32))
    assert step.max() <= 1 and step.mean() < 1e-3


def _pair(outlier_pattern, seed=0):
    jsw = _to_sparse_weight(_weight(seed), _jcfg(outlier_pattern),
                            quantize=True)
    tsw = _sparse_weight(jsw, "cpu")
    assert tsw.nm_values.dtype == torch.int8
    return jsw, tsw


def _x(M, seed=1):
    x = np.random.default_rng(seed).standard_normal((M, IN)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("outlier_pattern", ["16:256", None])
@pytest.mark.parametrize("M", [1, 8, 37])
def test_sparse_apply_matches_jax(M, outlier_pattern):
    jsw, tsw = _pair(outlier_pattern)
    jx, tx = _x(M, seed=M)
    before = (port_nm.launches_int8, port_fused.launches_int8)
    y = sparse_apply(tsw, tx.reshape(1, M, IN))
    assert y.shape == (1, M, OUT)
    np.testing.assert_allclose(y[0].numpy(),
                               np.asarray(jax_sparse_apply(jsw, jx)), **TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (port_nm.launches_int8, port_fused.launches_int8) == before


@pytest.mark.parametrize("outlier_pattern", ["16:256", None])
def test_sparse_apply_matches_pallas_int8_kernels(outlier_pattern):
    jsw, tsw = _pair(outlier_pattern, seed=3)
    jx, tx = _x(8)
    y = sparse_apply(tsw, tx).numpy()
    np.testing.assert_allclose(y, np.asarray(jax_sparse_apply_pallas(jsw, jx)),
                               **PALLAS_TOL)
    # the kernels themselves, with small tiles so the grid walks K
    kw = dict(n=jsw.n, m=jsw.m, scale=jsw.v_scale, block_b=8, block_o=32,
              block_k=256, interpret=True)
    if outlier_pattern is None:
        want = jax_nm_spmm(jx, jsw.nm_values, jsw.nm_meta, **kw)
        got = port_nm.nm_spmm(tx, tsw.nm_values, tsw.nm_meta, n=tsw.n,
                              m=tsw.m, scale=tsw.v_scale)
    else:
        want = jax_fused(jx, jsw.nm_values, jsw.nm_meta, jsw.o_values,
                         jsw.o_meta, o_n=jsw.o_n, **kw)
        got = port_fused.fused_sparse_linear(
            tx, tsw.nm_values, tsw.nm_meta, tsw.o_values, tsw.o_meta,
            n=tsw.n, m=tsw.m, o_n=tsw.o_n, scale=tsw.v_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_dequantization_rounds_as_jax():
    """At bf16 the plain versions (and the CUDA kernel) round int8 x scale
    once to bf16: the weights JAX ``sparse_apply`` builds at bf16."""
    jsw, tsw = _pair("16:256", seed=4)
    want = (jsw.nm_values.astype(jnp.float32)
            * jsw.v_scale[..., None].astype(jnp.float32)).astype(jnp.bfloat16)
    got = dequantize(tsw.nm_values, tsw.v_scale, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _trees(dtype):
    rng = np.random.default_rng(6)
    names = {"wq": (128, 128), "wo": (128, 128), "w_up": (256, 128),
             "w_down": (128, 256)}
    layers = {k: rng.standard_normal((2, *s)).astype(np.float32) / 16
              for k, s in names.items()}
    jtree = {"embed": jnp.asarray(rng.standard_normal((64, 128))
                                  .astype(np.float32)).astype(dtype),
             "layers": {k: jnp.asarray(v).astype(dtype)
                        for k, v in layers.items()}}
    ttree = {"embed": to_torch(np.asarray(jtree["embed"])),
             "layers": [{k: to_torch(np.asarray(v[i]))
                         for k, v in jtree["layers"].items()}
                        for i in range(2)]}
    return jtree, ttree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparsify_for_serving_quantized_report_matches_jax(dtype):
    jtree, ttree = _trees(getattr(jnp, dtype))
    jparams, jrep = jax_sparsify_for_serving(jtree, _jcfg("16:256"),
                                             quantize=True)
    tparams, trep = sparsify_for_serving(
        ttree, SparsifyConfig(scorer="magnitude", use_smoothquant=False),
        quantize=True)
    assert trep["n_layers_sparsified"] == 2 * jrep["n_layers_sparsified"]
    for key in ("dense_bytes", "compressed_bytes", "ratio"):
        assert trep[key] == pytest.approx(jrep[key])
    for lp in tparams["layers"]:
        for name in ("wq", "wo", "w_up", "w_down"):
            sw = lp[name]
            assert isinstance(sw, SparseWeight)
            assert sw.nm_values.dtype == torch.int8
            assert sw.v_scale.shape == (sw.nm_values.shape[0],)
            assert sw.v_scale.dtype == torch.float32


def test_from_jax_params_carries_int8_containers():
    jtree, _ = _trees(jnp.bfloat16)
    jparams, _ = jax_sparsify_for_serving(jtree, _jcfg("16:256"),
                                          quantize=True)
    tparams = from_jax_params(jparams, device="cpu")
    for name in ("wq", "wo", "w_up", "w_down"):
        jsw = jparams["layers"][name]
        for i, lp in enumerate(tparams["layers"]):
            tsw = lp[name]
            assert tsw.nm_values.dtype == torch.int8
            np.testing.assert_array_equal(tsw.nm_values.numpy(),
                                          np.asarray(jsw.nm_values[i]))
            assert tsw.v_scale.dtype == torch.float32
            np.testing.assert_array_equal(tsw.v_scale.numpy(),
                                          np.asarray(jsw.v_scale[i]))
            assert (tsw.n, tsw.m, tsw.o_n, tsw.in_dim) == \
                (jsw.n, jsw.m, jsw.o_n, jsw.in_dim)
