"""The port's ``outlier_spmm`` (plain version of kernel B4) and ``kernels/ops``
on the CPU, against the JAX package: its Pallas ``outlier_spmm`` in
interpret mode, its ``outlier_spmm_ref`` oracle and its ``ops`` entry points
(both backends), on containers the JAX pipeline built and carried across.

Tolerances: at f32 the two packages differ only in summation order,
rtol = atol = 1e-5.  In bf16 (x and values) every product is exact in f32
and the sums are rounded once to bf16, so outputs may differ by one bf16
ulp (``_assert_within_one_ulp``).  Meta words are compared bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ActStats as JaxActStats  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.core import sparsify_linear as jax_sparsify_linear  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.outlier_spmm import outlier_spmm as jax_outlier_spmm  # noqa: E402
from repro.kernels.outlier_spmm import pack_outlier_meta as jax_pack  # noqa: E402
from repro_torch.core import pack_outlier_meta, unpack_outlier_meta  # noqa: E402
from repro_torch.interchange import sparsified_from_jax, to_torch  # noqa: E402
from repro_torch.kernels import fused_sparse_linear as port_fused  # noqa: E402
from repro_torch.kernels import nm_spmm as port_nm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import outlier_spmm as port_osp  # noqa: E402
from repro_torch.kernels.ref import outlier_spmm_ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TILES = dict(block_b=8, block_o=64, block_k=256)


def _sparsified(o_n, out, kdim, seed=0, weight_pattern="8:16"):
    """JAX's pipeline (RIA + SmoothQuant + VC, the defaults) on gaussian
    weights with calibration statistics, as ``tests/test_kernels.py`` builds
    them; returns (JAX SparsifiedLinear, the port's copy, x as numpy)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out, kdim)).astype(np.float32)
    x = rng.standard_normal((16, kdim)).astype(np.float32)
    st = JaxActStats.init(kdim).update(jnp.asarray(x))
    cfg = JaxSparsifyConfig(weight_pattern=weight_pattern,
                            outlier_pattern=None if o_n is None
                            else f"{o_n}:256")
    sl = jax_sparsify_linear(jnp.asarray(w), st, cfg)
    return sl, sparsified_from_jax(sl), x


def _x(b, kdim, seed, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((b, kdim))
    jx = jnp.asarray(x.astype(np.float32)).astype(dtype)
    return jx, to_torch(np.asarray(jx))


def _assert_within_one_ulp(y, want):
    """|y - want| <= one bf16 ulp of the larger of the two, elementwise."""
    y = y.float().numpy()
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(y), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30)))
                                    - 7), 0.0)
    assert (np.abs(y - want) <= ulp).all(), np.abs(y - want).max()


@pytest.mark.parametrize("b,out,kdim", [(8, 64, 256), (16, 128, 512)])
@pytest.mark.parametrize("o_n", [4, 8, 16])
def test_plain_matches_jax_f32(o_n, b, out, kdim):
    jsl, tsl, _ = _sparsified(o_n, out, kdim)
    jx, tx = _x(b, kdim, 1)
    meta = pack_outlier_meta(tsl.outliers.indices)
    y = port_osp.outlier_spmm(tx, tsl.outliers.values, meta, n=o_n)
    assert y.dtype == torch.float32 and y.shape == (b, out)
    pallas = jax_outlier_spmm(jx, jsl.outliers.values,
                              jax_pack(jsl.outliers.indices), n=o_n,
                              interpret=True, **TILES)
    oracle = jax_ref.outlier_spmm_ref(jx, jsl.outliers.values,
                                      jsl.outliers.indices)
    for want in (pallas, oracle):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        outlier_spmm_ref(tx, tsl.outliers.values, tsl.outliers.indices)
        .numpy(), y.numpy())


@pytest.mark.parametrize("b,out,kdim", [(8, 64, 256), (16, 128, 512)])
@pytest.mark.parametrize("o_n", [4, 8, 16])
def test_plain_matches_jax_bf16(o_n, b, out, kdim):
    jsl, _, _ = _sparsified(o_n, out, kdim, seed=2)
    jvals = jsl.outliers.values.astype(jnp.bfloat16)
    jx, tx = _x(b, kdim, 3, jnp.bfloat16)
    tvals = to_torch(np.asarray(jvals))
    meta = to_torch(np.asarray(jax_pack(jsl.outliers.indices)))
    y = port_osp.plain(tx, tvals, meta, n=o_n)
    assert y.dtype == torch.bfloat16
    pallas = jax_outlier_spmm(jx, jvals, jax_pack(jsl.outliers.indices),
                              n=o_n, interpret=True, **TILES)
    oracle = jax_ref.outlier_spmm_ref(jx, jvals, jsl.outliers.indices)
    for want in (pallas, oracle):
        _assert_within_one_ulp(y, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("n", [4, 8, 16])
def test_meta_packing_matches_jax(n):
    """Four 8-bit indices per int32 word, bit for bit; index 255 in the top
    byte makes the word negative in both packages."""
    rng = np.random.default_rng(n)
    idx = np.sort(np.stack([np.stack([rng.choice(256, n, replace=False)
                                      for _ in range(3)]) for _ in range(5)]),
                  axis=-1).astype(np.int32)
    idx[:, 0, -1] = 255                # the top byte of the last word
    words = pack_outlier_meta(torch.from_numpy(idx))
    jwords = np.asarray(jax_pack(jnp.asarray(idx)))
    assert words.dtype == torch.int32 and words.shape == (5, 3, n // 4)
    np.testing.assert_array_equal(words.numpy(), jwords)
    assert (words[:, 0, -1] < 0).all()
    np.testing.assert_array_equal(
        unpack_outlier_meta(to_torch(jwords), n).numpy(), idx)


def test_cpu_tensors_launch_nothing():
    """On a CPU tensor each wrapper runs its plain version, counting no
    launch."""
    _, tsl, x = _sparsified(16, 64, 256)
    tx = torch.from_numpy(x)
    before = (port_osp.launches, port_nm.launches, port_fused.launches)
    ops.outlier_matmul(tx, tsl.outliers)
    ops.nm_matmul(tx, tsl.nm)
    ops.sparse_linear_apply(tx, tsl.nm, tsl.outliers)
    assert (port_osp.launches, port_nm.launches, port_fused.launches) == \
        before


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("case", ["nm_matmul", "outlier_matmul",
                                  "sparse_linear_apply",
                                  "sparse_linear_apply_no_outliers",
                                  "sparse_linear_apply_leading_dims"])
def test_ops_match_jax(case, backend):
    """The three entry points on the CPU against JAX's ``ops`` on the same
    containers, with both of its backends (Pallas in interpret mode)."""
    o_n = None if case == "sparse_linear_apply_no_outliers" else 8
    jsl, tsl, x = _sparsified(o_n, 64, 512, seed=4)
    jx, tx = _x(16, 512, 5)
    if case == "sparse_linear_apply_leading_dims":
        jx, tx = jx.reshape(2, 8, 512), tx.reshape(2, 8, 512)
    kw = dict(backend=backend, **(TILES if backend == "pallas" else {}))
    if case == "nm_matmul":
        y = ops.nm_matmul(tx, tsl.nm)
        want = jax_ops.nm_matmul(jx, jsl.nm, **kw)
    elif case == "outlier_matmul":
        y = ops.outlier_matmul(tx, tsl.outliers)
        want = jax_ops.outlier_matmul(jx, jsl.outliers, **kw)
    else:
        y = ops.sparse_linear_apply(tx, tsl.nm, tsl.outliers)
        want = jax_ops.sparse_linear_apply(jx, jsl.nm, jsl.outliers, **kw)
    assert tuple(y.shape) == tuple(want.shape)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


def test_unfused_pair_equals_fused_on_cpu():
    """W_nm holds exact zeros at the salient slots, so nm_matmul +
    outlier_matmul is the fused product up to f32 summation order."""
    _, tsl, _ = _sparsified(16, 64, 512, seed=6)
    _, tx = _x(8, 512, 7)
    fused = ops.sparse_linear_apply(tx, tsl.nm, tsl.outliers)
    pair = ops.nm_matmul(tx, tsl.nm) + ops.outlier_matmul(tx, tsl.outliers)
    np.testing.assert_allclose(pair.numpy(), fused.numpy(), **TOL)
    dense = tsl.to_dense()
    np.testing.assert_allclose(fused.numpy(), (tx @ dense.T).numpy(), **TOL)
