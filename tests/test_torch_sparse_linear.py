"""The port's sparse linear (plain versions of the two kernels, and the
``sparse_apply`` dispatch) on JAX ``SparseWeight``s carried across, held
against the JAX package's Pallas kernels (interpret mode), its ``ref``
oracles and its ``sparse_apply``.  f32 throughout: the two packages then
differ only in summation order, so rtol = atol = 1e-5."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.fused_sparse_linear import \
    fused_sparse_linear as jax_fused  # noqa: E402
from repro.kernels.nm_spmm import nm_spmm as jax_nm_spmm  # noqa: E402
from repro.kernels.outlier_spmm import unpack_outlier_meta  # noqa: E402
from repro.core.packing import unpack_metadata  # noqa: E402
from repro.models.sparse_serving import _to_sparse_weight  # noqa: E402
from repro.models.sparse_serving import sparse_apply as jax_sparse_apply  # noqa: E402
from repro_torch.interchange import _sparse_weight, to_torch  # noqa: E402
from repro_torch.kernels import fused_sparse_linear as port_fused  # noqa: E402
from repro_torch.kernels import nm_spmm as port_nm  # noqa: E402
from repro_torch.models.sparse_serving import sparse_apply  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
OUT, IN = 96, 512


def _sparse_weight_pair(outlier_pattern, weight_pattern="8:16", seed=0):
    w = np.random.default_rng(seed).standard_normal((OUT, IN)).astype(
        np.float32) / np.sqrt(IN)
    cfg = JaxSparsifyConfig(weight_pattern=weight_pattern,
                            outlier_pattern=outlier_pattern,
                            scorer="magnitude", use_smoothquant=False)
    jsw = _to_sparse_weight(jnp.asarray(w), cfg)
    return jsw, _sparse_weight(jsw, "cpu")


def _x(M, seed=1):
    x = np.random.default_rng(seed).standard_normal((M, IN)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("weight_pattern", ["8:16", "2:4"])
@pytest.mark.parametrize("M", [8, 16])
def test_nm_spmm_matches_jax(M, weight_pattern):
    jsw, tsw = _sparse_weight_pair(None, weight_pattern)
    jx, tx = _x(M)
    n, m = jsw.n, jsw.m
    y = port_nm.nm_spmm(tx, tsw.nm_values, tsw.nm_meta, n=n, m=m).numpy()
    pallas = jax_nm_spmm(jx, jsw.nm_values, jsw.nm_meta, n=n, m=m,
                         block_b=8, block_o=32, block_k=256, interpret=True)
    oracle = jax_ref.nm_spmm_ref(jx, jsw.nm_values,
                                 unpack_metadata(jsw.nm_meta, n), m)
    for want in (pallas, oracle, jax_sparse_apply(jsw, jx)):
        np.testing.assert_allclose(y, np.asarray(want), **TOL)


@pytest.mark.parametrize("o_n", [16, 4])
@pytest.mark.parametrize("M", [8, 16])
def test_fused_sparse_linear_matches_jax(M, o_n):
    jsw, tsw = _sparse_weight_pair(f"{o_n}:256")
    jx, tx = _x(M)
    kw = dict(n=jsw.n, m=jsw.m, o_n=jsw.o_n)
    y = port_fused.fused_sparse_linear(tx, tsw.nm_values, tsw.nm_meta,
                                       tsw.o_values, tsw.o_meta, **kw).numpy()
    pallas = jax_fused(jx, jsw.nm_values, jsw.nm_meta, jsw.o_values,
                       jsw.o_meta, block_b=8, block_o=32, block_k=256,
                       interpret=True, **kw)
    oracle = jax_ref.fused_sparse_linear_ref(
        jx, jsw.nm_values, unpack_metadata(jsw.nm_meta, jsw.n), jsw.m,
        jsw.o_values, unpack_outlier_meta(jsw.o_meta, jsw.o_n))
    for want in (pallas, oracle, jax_sparse_apply(jsw, jx)):
        np.testing.assert_allclose(y, np.asarray(want), **TOL)


@pytest.mark.parametrize("outlier_pattern", ["16:256", None])
@pytest.mark.parametrize("M", [1, 3, 37])
def test_sparse_apply_ragged_m(M, outlier_pattern):
    """Decode batches and padded chunks give any M: the port takes it (the
    Pallas wrappers need M % block_b == 0), here against JAX's oracle."""
    jsw, tsw = _sparse_weight_pair(outlier_pattern)
    jx, tx = _x(M, seed=M)
    before = (port_nm.launches, port_fused.launches)
    y = sparse_apply(tsw, tx.reshape(1, M, IN))
    assert y.shape == (1, M, OUT)
    np.testing.assert_allclose(y[0].numpy(),
                               np.asarray(jax_sparse_apply(jsw, jx)), **TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (port_nm.launches, port_fused.launches) == before


def test_bf16_buffers_cross_exactly():
    """bf16 leaves cross the interchange as their 16-bit patterns."""
    jsw, _ = _sparse_weight_pair("16:256")
    jv = jsw.nm_values.astype(jnp.bfloat16)
    t = to_torch(np.asarray(jv))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))


def test_int8_weights_raise_naming_roadmap():
    _, tsw = _sparse_weight_pair("16:256")
    tsw.v_scale = torch.ones(OUT)
    with pytest.raises(NotImplementedError, match="A6"):
        sparse_apply(tsw, torch.zeros(2, IN))
