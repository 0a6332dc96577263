"""``nm_spmm``'s two paths on the CPU, where the kernels cannot run: the
decode body (``csrc/fused_sparse_linear.cu``) and the prefill body
(``csrc/fused_sparse_linear_prefill.cu``) instantiated without an outlier
stream, as ``kernels/fused_sparse_linear.plan`` drives them at ``o_n = 0``.

- ``plan``: the slices cover K on multiples of 256 but for a ragged last
  one, K a multiple of m and of 8 only (272, 400, 784, ... and K % 64 != 0,
  where the prefill kernel's last stage is cut at K); the workspace is
  S x M x N f32; at M = 37 every llama3-8b projection fills a 132-SM card;
  at M = 512 the tiles are 256 rows tall but for wk/wv's.  Without the
  outlier bytes two prefill blocks of 128 rows fit an SM, and the fused
  kernel's blocks per SM stay as they were.
- ``decode_model`` and ``prefill_model``: each body's arithmetic in f32 on
  the CPU, in the order the kernel sums.  Decode: each lane's partial sum
  over its N:M blocks (kept values in order), the warp's shuffle butterfly,
  the splits in order.  Prefill: the weights of each 16-column block as
  the B tile holds them (int8 values scaled and rounded once to bf16),
  16-wide K steps in order within a split, the splits in order; columns
  past K are zero in x and in the tile.  Both are held to ``nm_spmm_ref``
  and to the JAX package's Pallas ``nm_spmm`` in interpret mode (with a
  ``block_k`` that divides K) on the same bf16 inputs, at 8:16, 4:8 and
  2:4, bf16 and int8 values, M not a multiple of the tile and ragged K.

Tolerances.  The products are exact in f32, so the model and the
references differ only in summation order: elementwise
|y - want| <= 1e-5 |want| + sqrt(K) eps_f32 (|x| @ |W|^T), the usual
probabilistic bound of recursive summation (a wrong index or value gives
errors of the order of |x| @ |W|^T itself).  Against JAX's int8 kernel,
which keeps the dequantized weight in f32 where the port rounds it once to
bf16 (as JAX's ``sparse_apply`` does), the bound is that rounding: 2**-8 of
|x| @ |W|^T, plus 1e-5.  Rounded to bf16, the model is within one bf16 ulp
of the largest output (2**-7 of it) of the wrapper's plain version.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.kernels.nm_spmm import nm_spmm as jax_nm_spmm  # noqa: E402
from repro.models.sparse_serving import _to_sparse_weight  # noqa: E402
from repro_torch.core import unpack_metadata  # noqa: E402
from repro_torch.interchange import _sparse_weight  # noqa: E402
from repro_torch.kernels import fused_sparse_linear as fsl  # noqa: E402
from repro_torch.kernels import nm_spmm as nms  # noqa: E402
from repro_torch.kernels.ref import (decompress_nm,  # noqa: E402
                                     dequantize, nm_spmm_ref)

T = fsl.DECODE_MAX_M
SMS = 132                                      # an H100 SXM
LLAMA = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]  # (N, K)
RAGGED_K = [136, 272, 392, 400, 784, 14336]    # K % 8 == 0, K % 256 != 0
EPS_F32 = float(np.finfo(np.float32).eps)


def _slices(p, K):
    """The slices' edges: multiples of 256 but for the last, which is K."""
    edges = [min(s * p.k_per_split, K) for s in range(p.splits + 1)]
    assert p.k_per_split % 256 == 0 and edges[-1] == K
    assert (p.splits - 1) * p.k_per_split < K          # no empty slice
    assert all(e % 256 == 0 for e in edges[:-1])
    return edges


# ------------------------------------------------------------------- plan
@pytest.mark.parametrize("N", [96, 200, 4096])
@pytest.mark.parametrize("K", RAGGED_K + [256, 4096])
@pytest.mark.parametrize("M", [1, 3, T, T + 1, 37, 64, 65, 129, 512, 1000])
def test_plan_without_outliers_covers_ragged_k(M, K, N):
    p = fsl.plan(M, K, N, 8, 16, 0, SMS)
    assert p.path == ("decode" if M <= T else "prefill")
    edges = _slices(p, K)
    assert p.workspace_bytes == (p.splits * M * N * 4 if p.splits > 1 else 0)
    if p.path == "decode":
        assert p.k_per_split * p.rows * 2 <= fsl.X_SLICE_BYTES
        assert p.blocks == -(-N // fsl.BLOCK_ROWS) * -(-M // p.rows) * \
            p.splits
    else:
        tiles = -(-M // p.rows) * -(-N // p.cols)
        assert p.blocks == tiles * p.splits
        assert p.counters == (tiles if p.splits > 1 else 0)
        # the prefill kernel walks a slice in 64-column stages: where K % 64
        # != 0 only the last stage of the last slice is cut at K (the tail)
        assert all((b - a) % 64 == 0 for a, b in zip(edges[:-2], edges[1:-1]))
        assert (edges[-1] - edges[-2]) % 64 == K % 64


@pytest.mark.parametrize("N,K", LLAMA)
def test_plan_without_outliers_fills_the_card_at_37_rows(N, K):
    p = fsl.plan(37, K, N, 8, 16, 0, SMS)
    assert p.path == "prefill" and p.blocks >= SMS


@pytest.mark.parametrize("N,K", LLAMA)
def test_plan_without_outliers_tiles_at_512_rows(N, K):
    """256-row tiles (each weight element decompressed twice) but for
    wk/wv, whose 1024 rows keep 128-row tiles."""
    p = fsl.plan(512, K, N, 8, 16, 0, SMS)
    assert (p.rows, p.cols) == ((128, 128) if N == 1024 else (256, 128))


def test_blocks_per_sm_follow_shared_memory():
    """The fused kernel's prefill blocks per SM are as they were (2 at BM =
    64, 1 at 128 and 256); without the outlier bytes a 128-row block takes
    111 KB, and two fit an SM."""
    assert {bm: fsl.prefill_blocks_per_sm(bm, 16) for bm in (64, 128, 256)} \
        == {64: 2, 128: 1, 256: 1}
    assert {bm: fsl.prefill_blocks_per_sm(bm, 0) for bm in (64, 128, 256)} \
        == {64: 2, 128: 2, 256: 1}
    assert fsl.prefill_smem_bytes(128, 16) == 132096
    assert fsl.prefill_smem_bytes(128, 0) == 113664


def test_plan_needs_whole_groups_only_with_outliers():
    with pytest.raises(ValueError):
        fsl.plan(8, 400, 96, 8, 16, 16, SMS)
    with pytest.raises(ValueError):
        fsl.plan(37, 400, 96, 8, 16, 16, SMS)
    assert fsl.plan(8, 400, 96, 8, 16, 0, SMS).splits == 2
    with pytest.raises(ValueError):
        fsl.plan(0, 400, 96, 8, 16, 0, SMS)


def test_plan_never_picks_the_tile_without_outliers():
    assert all(fsl.plan(M, K, 1024, 8, 16, 0, SMS, decode_max_m=d).path
               != "tile" for M in (1, 8, 37, 512) for K in (400, 4096)
               for d in (0, T, 64))


# ------------------------------------------------- the kernels' arithmetic
def _dense(values, meta, *, n, m, scale):
    """The weight the kernels multiply by: int8 values scaled and rounded
    once to bf16, scattered to their slots, f32 [N, K]."""
    return decompress_nm(dequantize(values, scale, torch.bfloat16).float(),
                         unpack_metadata(meta, n), m, dtype=torch.float32)


def decode_model(x, values, meta, *, n, m, scale, p):
    """What the decode body without outliers computes for ``p``, before the
    final rounding to bf16: f32 [M, N]."""
    M, K = x.shape
    N = values.shape[0]
    xf = x.float()
    vals = dequantize(values, scale, torch.bfloat16).float().reshape(
        N, K // m, n)
    idx = unpack_metadata(meta, n).long()
    lanes = torch.arange(32)
    total = torch.zeros((M, N))
    for s in range(p.splits):
        k0 = s * p.k_per_split
        cols = min(p.k_per_split, K - k0)
        b0, nb = k0 // m, cols // m
        acc = torch.zeros((M, N, 32))
        for step in range(-(-nb // 32)):
            e = step * 32 + lanes
            live = e < nb                     # lane e takes N:M block e
            b = b0 + torch.where(live, e, 0)
            for k in range(n):                # kept values in order
                col = b * m + idx[:, b, k]
                acc = torch.where(live, acc + vals[:, b, k] * xf[:, col], acc)
        for off in (16, 8, 4, 2, 1):          # lane l adds lane l ^ off
            acc = acc + acc[..., lanes ^ off]
        total = total + acc[..., 0]           # 0 + p0 + p1 + ...
    return total


def prefill_model(x, values, meta, *, n, m, scale, p):
    """What the prefill body without outliers computes for ``p``, before
    the final rounding to bf16: f32 [M, N].  Each split accumulates its
    16-wide K steps (one ``wgmma`` k-step each) in order, the last one cut
    at K; with several splits the last block sums them in split order."""
    M, K = x.shape
    xf = x.float()
    w = _dense(values, meta, n=n, m=m, scale=scale).to(torch.bfloat16).float()
    total = torch.zeros((M, w.shape[0]))
    for s in range(p.splits):
        k0 = s * p.k_per_split
        acc = torch.zeros_like(total)
        for kk in range(k0, min(k0 + p.k_per_split, K), 16):
            acc = acc + xf[:, kk:kk + 16] @ w[:, kk:kk + 16].T
        total = acc if p.splits == 1 else total + acc
    return total


OUT = 96


def _weights(weight_pattern, K, quantize, seed):
    """JAX's SparseWeight without outliers on bf16-valued weights
    (magnitude, no SmoothQuant) and the port's copy with bf16 (or int8)
    values; the JAX arrays hold exactly what the port holds."""
    w = np.random.default_rng(seed).standard_normal((OUT, K)).astype(
        np.float32) / np.sqrt(K)
    w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    cfg = JaxSparsifyConfig(weight_pattern=weight_pattern,
                            outlier_pattern=None, scorer="magnitude",
                            use_smoothquant=False)
    jsw = _to_sparse_weight(jnp.asarray(w), cfg, quantize=quantize)
    tsw = _sparse_weight(jsw, "cpu")
    if not quantize:
        tsw = tsw.map(lambda t: t.to(torch.bfloat16)
                      if t.is_floating_point() else t)
    jsw = dataclasses.replace(
        jsw, nm_values=jnp.asarray(tsw.nm_values.float().numpy()
                                   if not quantize else
                                   tsw.nm_values.numpy()))
    return jsw, tsw


def _assert_summation_order(got, want, x, w):
    """|got - want| <= 1e-5 |want| + sqrt(K) eps_f32 (|x| @ |w|^T)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.abs(np.asarray(x, np.float64)) @ np.abs(
        np.asarray(w, np.float64)).T
    bound = 1e-5 * np.abs(want) + np.sqrt(x.shape[-1]) * EPS_F32 * mag
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
    return mag


# (pattern, K): 8:16 needs K % 16 == 0 (400: K % 64 != 0, so the generic
# prefill instance and a cut last stage); 4:8 and 2:4 take K = 392, where
# the last 16-column block holds blocks past K
SHAPES = [("8:16", 400), ("4:8", 392), ("2:4", 392)]


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("weight_pattern,K", SHAPES)
@pytest.mark.parametrize("M", [1, 3, 8, 37, 130])
def test_kernel_models_match_ref_and_jax(M, weight_pattern, K, quantize):
    jsw, tsw = _weights(weight_pattern, K, quantize, seed=M + K)
    x = torch.from_numpy(np.random.default_rng(M).standard_normal(
        (M, K)).astype(np.float32)).to(torch.bfloat16)
    p = fsl.plan(M, K, OUT, tsw.n, tsw.m, 0, SMS)
    assert p.splits == 2 and p.path == ("decode" if M <= T else "prefill")
    if p.path == "prefill":
        assert M % p.rows
    model = decode_model if p.path == "decode" else prefill_model
    kw = dict(n=tsw.n, m=tsw.m, scale=tsw.v_scale)
    got = model(x, tsw.nm_values, tsw.nm_meta, p=p, **kw)
    w = _dense(tsw.nm_values, tsw.nm_meta, **kw)
    # the port's plain f32 product on the same (dequantized, bf16) weights
    w_nm = dequantize(tsw.nm_values, tsw.v_scale, torch.bfloat16).float()
    ref = nm_spmm_ref(x.float(), w_nm, unpack_metadata(tsw.nm_meta, tsw.n),
                      tsw.m)
    _assert_summation_order(got, ref, x.float(), w)
    # rounded to bf16, within one bf16 ulp of the wrapper's plain version
    y = nms.nm_spmm(x, tsw.nm_values, tsw.nm_meta, **kw)
    err = float((got.to(torch.bfloat16).float() - y.float()).abs().max())
    assert err <= 2.0 ** -7 * float(y.float().abs().max())
    # JAX's Pallas kernel in interpret mode, small tiles so its grid walks K
    jx = jnp.asarray(x.float().numpy())
    tiles = dict(block_b=M, block_o=32, block_k=8 if K % 16 else 16,
                 interpret=True)
    pallas_bf16 = jax_nm_spmm(jx, jnp.asarray(w_nm.numpy()), jsw.nm_meta,
                              n=jsw.n, m=jsw.m, **tiles)
    mag = _assert_summation_order(got, pallas_bf16, x.float(), w)
    if quantize:
        pallas_int8 = np.asarray(jax_nm_spmm(
            jx, jsw.nm_values, jsw.nm_meta, n=jsw.n, m=jsw.m,
            scale=jsw.v_scale, **tiles))
        assert (np.abs(got.numpy() - pallas_int8)
                <= 2.0 ** -8 * mag + 1e-5).all()


@pytest.mark.parametrize("weight_pattern,K", SHAPES)
@pytest.mark.parametrize("M", [8, 37])
def test_kernel_models_are_the_same_for_every_split(M, weight_pattern, K):
    """One slice or two: the same sum to f32 rounding, so the split of a
    ragged K is a schedule, not a different function."""
    _, tsw = _weights(weight_pattern, K, False, seed=9)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (M, K)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(n=tsw.n, m=tsw.m, scale=None)
    two = fsl.plan(M, K, OUT, tsw.n, tsw.m, 0, SMS)
    one = dataclasses.replace(two, splits=1, k_per_split=-(-K // 256) * 256,
                              workspace_bytes=0, counters=0)
    assert two.splits == 2
    model = decode_model if two.path == "decode" else prefill_model
    w = _dense(tsw.nm_values, tsw.nm_meta, **kw)
    _assert_summation_order(
        model(x, tsw.nm_values, tsw.nm_meta, p=one, **kw),
        model(x, tsw.nm_values, tsw.nm_meta, p=two, **kw), x.float(), w)


def test_cpu_tensors_launch_nothing():
    """On a CPU tensor ``nm_spmm`` runs its plain version and counts no
    launch on any path."""
    _, tsw = _weights("8:16", 400, True, seed=3)
    x = torch.randn((37, 400)).to(torch.bfloat16)
    names = ("launches", "launches_int8", "launches_decode",
             "launches_decode_int8", "launches_prefill",
             "launches_prefill_int8")
    before = [getattr(nms, k) for k in names]
    y = nms.nm_spmm(x, tsw.nm_values, tsw.nm_meta, n=8, m=16,
                    scale=tsw.v_scale)
    assert y.shape == (37, OUT) and y.dtype == torch.bfloat16
    assert [getattr(nms, k) for k in names] == before
