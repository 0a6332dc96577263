"""The prefill path of the port's fused kernel
(``csrc/fused_sparse_linear_prefill.cu``, M > T) on the CPU, where the
kernel cannot run.

- ``plan``: the tiles and the split of K that the wrapper hands the kernel,
  for llama3-8b's four projection shapes and for ragged ones: BM and BN
  tiles cover M and N, the slices cover K exactly on multiples of 256 with
  none empty, the workspace is S x M x N f32 (none for one slice), the
  grid and the counters agree with the tiles and the split, and at M = 37
  every llama3-8b projection fills a 132-SM card.
- ``kernel_model``: the kernel's arithmetic in f32 on the CPU.  Each
  16-column block of weights is built as the kernel builds it (the kept
  N:M values, int8 ones scaled and rounded once to bf16, plus the outliers
  whose index falls in the block, the sum rounded to the bf16 of the B
  tile), then each split sums its 16-wide K steps in order and the splits
  are summed in order.  It is held to ``fused_sparse_linear_ref`` and to
  the JAX package's Pallas kernel in interpret mode on the same bf16
  inputs, at M not a multiple of BM.  W_nm is an exact zero at every
  salient slot, so the bf16 B tile holds the reference's weights exactly;
  the products are exact in f32, so only the order of the sums differs:
  rtol = atol = 1e-5.  Against JAX's int8 kernel, which keeps the
  dequantized weight in f32 where the port rounds it once to bf16 (as
  JAX's ``sparse_apply`` does), the bound is that rounding: 2**-8 of
  |x| @ |W|^T, plus 1e-5.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.kernels.fused_sparse_linear import \
    fused_sparse_linear as jax_fused  # noqa: E402
from repro.models.sparse_serving import _to_sparse_weight  # noqa: E402
from repro_torch.core import unpack_metadata, unpack_outlier_meta  # noqa: E402
from repro_torch.interchange import _sparse_weight  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import fused_sparse_linear as fsl  # noqa: E402
from repro_torch.kernels.ref import (decompress_nm,  # noqa: E402
                                     dequantize, fused_sparse_linear_ref)

T = fsl.DECODE_MAX_M
SMS = 132                                      # an H100 SXM
LLAMA = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]  # (N, K)
RAGGED = [(N, K) for N in (96, 200) for K in (256, 768, 14336)]
TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- plan
@pytest.mark.parametrize("N,K", LLAMA + RAGGED)
@pytest.mark.parametrize("M", [T + 1, 37, 64, 65, 128, 512, 1000])
def test_prefill_plan_covers_m_n_and_k(M, N, K):
    p = fsl.plan(M, K, N, 8, 16, 16, SMS)
    assert p.path == "prefill"
    assert p.rows == 64 if M <= 64 else p.rows in ((128,) if M <= 128
                                                   else (128, 256))
    assert p.cols in (64, 128) and (p.rows < 256 or p.cols == 128)
    m_tiles, n_tiles = -(-M // p.rows), -(-N // p.cols)
    assert (m_tiles - 1) * p.rows < M <= m_tiles * p.rows
    assert (n_tiles - 1) * p.cols < N <= n_tiles * p.cols
    S, kps = p.splits, p.k_per_split
    assert S >= 1 and kps % 256 == 0
    edges = [min(s * kps, K) for s in range(S + 1)]
    assert edges[-1] == K and (S - 1) * kps < K       # no empty slice
    assert all(e % 256 == 0 for e in edges)
    if K == 256:
        assert S == 1
    assert p.workspace_bytes == (S * M * N * 4 if S > 1 else 0)
    assert p.blocks == m_tiles * n_tiles * S
    assert p.counters == (m_tiles * n_tiles if S > 1 else 0)


@pytest.mark.parametrize("N,K", LLAMA)
def test_prefill_plan_fills_the_card_at_37_rows(N, K):
    """At M = 37 the weights are read once and bytes set the pace: every
    llama3-8b projection, wk/wv's 1024 rows included, gets at least one
    block per SM."""
    p = fsl.plan(37, K, N, 8, 16, 16, SMS)
    assert p.path == "prefill" and p.blocks >= SMS


@pytest.mark.parametrize("N,K", LLAMA)
def test_prefill_plan_decompresses_the_weight_twice_at_512_rows(N, K):
    """At M = 512 the tiles are 256 rows tall, so each weight element is
    decompressed ceil(512 / 256) = 2 times, once per row tile; but wk/wv's
    1024 rows keep 128-row tiles, since 16 tiles of 256 rows would leave
    the card to an 8-way split of K."""
    p = fsl.plan(512, K, N, 8, 16, 16, SMS)
    assert p.rows == (128 if N == 1024 else 256)


@pytest.mark.parametrize("tiles,groups,wave,want", [
    (448, 16, 132, 1),      # the tiles fill the card: no split
    (112, 16, 264, 2),      # w_gate at M = 37: 224 blocks in one wave
    (32, 56, 264, 8),       # w_down at M = 37: 256 blocks, 7 groups each
    (64, 56, 132, 2),       # w_down at M = 512 (BM 256): 128 blocks
    (16, 16, 264, 16),      # wk at M = 37 (BN 64): one group each
    (2, 2, 264, 2)])
def test_prefill_splits_count_waves(tiles, groups, wave, want):
    assert common.prefill_splits(tiles, groups, wave) == want


def test_tile_plan_is_only_forced():
    """``plan`` never returns the old tile kernel; ``tile_plan`` builds its
    plan for ``force_plan``."""
    assert all(fsl.plan(M, 4096, 1024, 8, 16, 16, SMS, decode_max_m=d).path
               != "tile" for M in (1, 8, 37, 512) for d in (0, T, 64))
    p = fsl.tile_plan(37, 4096, 1024)
    assert (p.path, p.rows, p.cols, p.splits, p.workspace_bytes) == (
        "tile", 64, 64, 1, 0)


# ------------------------------------------------- the kernel's arithmetic
def kernel_weights(values, meta, o_values, o_meta, *, n, m, o_n, scale):
    """The B tiles the kernel builds, as one [N, K] f32 matrix: the kept
    values (int8 ones scaled and rounded once to bf16) plus the outliers in
    f32, rounded to bf16 by the store into the tile."""
    N = values.shape[0]
    w_nm = decompress_nm(dequantize(values, scale, torch.bfloat16),
                         unpack_metadata(meta, n), m, dtype=torch.float32)
    w_o = decompress_nm(o_values.reshape(N, -1),
                        unpack_outlier_meta(o_meta, o_n), 256,
                        dtype=torch.float32)
    return (w_nm + w_o).to(torch.bfloat16).float()


def kernel_model(x, values, meta, o_values, o_meta, *, n, m, o_n, scale,
                 p):
    """What ``csrc/fused_sparse_linear_prefill.cu`` computes for ``p``,
    before the final rounding to bf16: f32 [M, N].  Each split accumulates
    its 16-wide K steps (one ``wgmma`` k-step each) in order; with
    several splits the last block sums them in split order, 0 + p0 + p1."""
    M, K = x.shape
    xf = x.float()
    w = kernel_weights(values, meta, o_values, o_meta, n=n, m=m, o_n=o_n,
                       scale=scale)
    total = torch.zeros((M, w.shape[0]))
    for s in range(p.splits):
        k0 = s * p.k_per_split
        acc = torch.zeros_like(total)
        for kk in range(k0, min(k0 + p.k_per_split, K), 16):
            acc = acc + xf[:, kk:kk + 16] @ w[:, kk:kk + 16].T
        total = acc if p.splits == 1 else total + acc
    return total


OUT, IN = 96, 512


def _weights(weight_pattern, o_n, quantize, seed):
    """JAX's SparseWeight on bf16-valued weights (magnitude, no SmoothQuant)
    and the port's copy with bf16 N:M values (or int8 with scales) and bf16
    outliers; the JAX arrays hold exactly what the port holds."""
    w = np.random.default_rng(seed).standard_normal((OUT, IN)).astype(
        np.float32) / np.sqrt(IN)
    w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    cfg = JaxSparsifyConfig(weight_pattern=weight_pattern,
                            outlier_pattern=f"{o_n}:256", scorer="magnitude",
                            use_smoothquant=False)
    jsw = _to_sparse_weight(jnp.asarray(w), cfg, quantize=quantize)
    tsw = _sparse_weight(jsw, "cpu")
    if not quantize:
        tsw = tsw.map(lambda t: t.to(torch.bfloat16)
                      if t.is_floating_point() else t)
    else:
        tsw = dataclasses.replace(tsw, o_values=tsw.o_values.to(
            torch.bfloat16))
    jsw = dataclasses.replace(
        jsw, nm_values=jnp.asarray(tsw.nm_values.float().numpy()
                                   if not quantize else
                                   tsw.nm_values.numpy()),
        o_values=jnp.asarray(tsw.o_values.float().numpy()))
    return jsw, tsw


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("weight_pattern,o_n", [("8:16", 4), ("8:16", 16),
                                                ("4:8", 8)])
@pytest.mark.parametrize("M", [37, 130])
def test_kernel_model_matches_ref_and_jax(M, weight_pattern, o_n, quantize):
    jsw, tsw = _weights(weight_pattern, o_n, quantize, seed=o_n + M)
    x = torch.from_numpy(np.random.default_rng(M).standard_normal(
        (M, IN)).astype(np.float32)).to(torch.bfloat16)
    p = fsl.plan(M, IN, OUT, tsw.n, tsw.m, o_n, SMS)
    assert p.path == "prefill" and M % p.rows and p.splits == 2
    kw = dict(n=tsw.n, m=tsw.m, o_n=o_n, scale=tsw.v_scale)
    args = (tsw.nm_values, tsw.nm_meta, tsw.o_values, tsw.o_meta)
    # the contract the bf16 B tile rests on: W_nm is zero at salient slots
    w_nm = dequantize(tsw.nm_values, tsw.v_scale, torch.bfloat16).float()
    idx, oidx = (unpack_metadata(tsw.nm_meta, tsw.n),
                 unpack_outlier_meta(tsw.o_meta, o_n))
    dense_nm = decompress_nm(w_nm, idx, tsw.m)
    salient = decompress_nm(torch.ones(OUT, IN // 256 * o_n), oidx, 256)
    assert not (dense_nm * salient).any()
    got = kernel_model(x, *args, p=p, **kw)
    ref = fused_sparse_linear_ref(x.float(), w_nm, idx, tsw.m,
                                  tsw.o_values.float(), oidx)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    # rounded to bf16, within one bf16 ulp of the wrapper's plain version
    y = fsl.fused_sparse_linear(x, *args, **kw)
    err = float((got.to(torch.bfloat16).float() - y.float()).abs().max())
    assert err <= 2.0 ** -7 * float(y.float().abs().max())
    # JAX's Pallas kernel in interpret mode, small tiles so its grid walks K
    jx = jnp.asarray(x.float().numpy())
    tiles = dict(block_b=M, block_o=32, block_k=256, interpret=True)
    pallas_bf16 = jax_fused(jx, jnp.asarray(w_nm.numpy()), jsw.nm_meta,
                            jsw.o_values, jsw.o_meta, n=jsw.n, m=jsw.m,
                            o_n=o_n, **tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas_bf16), **TOL)
    if quantize:
        pallas_int8 = np.asarray(jax_fused(
            jx, jsw.nm_values, jsw.nm_meta, jsw.o_values, jsw.o_meta,
            n=jsw.n, m=jsw.m, o_n=o_n, scale=jsw.v_scale, **tiles))
        w_abs = fused_sparse_linear_ref(
            x.float().abs(), w_nm.abs(), idx, tsw.m,
            tsw.o_values.float().abs(), oidx).numpy()
        assert (np.abs(got.numpy() - pallas_int8)
                <= 2.0 ** -8 * w_abs + 1e-5).all()


@pytest.mark.parametrize("M", [37, 130])
def test_kernel_model_is_the_same_for_every_split(M):
    """One slice or several: the same sum to f32 rounding, so the split is
    a schedule, not a different function."""
    _, tsw = _weights("8:16", 16, False, seed=9)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (M, IN)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(n=tsw.n, m=tsw.m, o_n=16, scale=None)
    args = (x, tsw.nm_values, tsw.nm_meta, tsw.o_values, tsw.o_meta)
    two = fsl.plan(M, IN, OUT, 8, 16, 16, SMS)
    one = dataclasses.replace(two, splits=1, k_per_split=IN,
                              workspace_bytes=0, counters=0)
    assert two.splits == 2
    np.testing.assert_allclose(kernel_model(*args, p=one, **kw).numpy(),
                               kernel_model(*args, p=two, **kw).numpy(),
                               **TOL)
