"""The port's ``outlier_spmm`` (plain version of kernel B4) and ``kernels/ops``
on the CPU, against the JAX package: its Pallas ``outlier_spmm`` in
interpret mode, its ``outlier_spmm_ref`` oracle and its ``ops`` entry points
(both backends), on containers the JAX pipeline built and carried across.

Tolerances: at f32 the two packages differ only in summation order.  In
``test_plain_matches_jax_f32`` rtol = atol = 1e-5.  The ``ops`` comparisons
(``test_ops_match_jax``, ``test_unfused_pair_equals_fused_on_cpu``) hold
each output to a bound on two summation orders instead,
|y - want| <= 1e-5 |want| + sqrt(K) eps_f32 (|x| @ |W|^T), W the dense
effective weight (``_assert_within_summation_order``): a flat 1e-5 is no
bound on the order of a sum that cancels to near zero (one output of 0.059
over a sum |x||w| of 220.6 differed by 1.24e-5, 0.47 eps of that sum, and
which CPU ran the test decided the verdict).  sqrt(K) eps |x||w| is the
usual probabilistic bound of recursive summation; a wrong index or value
gives errors of the order of |x||w| itself, ~1e7 eps.  In bf16 (x and values) every product is exact in f32
and the sums are rounded once to bf16, so outputs may differ by one bf16
ulp (``_assert_within_one_ulp``).  Meta words are compared bit for bit."""
import dataclasses

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module's many small CPU ops run, so
    that several test workers on one machine do not oversubscribe its
    cores (it changes no case and no tolerance); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = dict(rtol=1e-5, atol=1e-5)
EPS_F32 = float(np.finfo(np.float32).eps)
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


def _assert_within_summation_order(y, want, x, w):
    """|y - want| <= 1e-5 |want| + sqrt(K) eps_f32 (|x| @ |w|^T),
    elementwise, for f32 outputs of x [..., K] times the dense w [N, K]^T
    summed in two orders."""
    y = np.asarray(y, np.float64)
    want = np.asarray(want, np.float64)
    x = np.abs(np.asarray(x, np.float64))
    w = np.abs(np.asarray(w, np.float64))
    k = x.shape[-1]
    bound = 1e-5 * np.abs(want) + np.sqrt(k) * EPS_F32 * (x @ w.T)
    gap = np.abs(y - want)
    assert y.shape == want.shape and (gap <= bound).all(), \
        (gap.max(), (gap / bound).max())


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
        dense = tsl.nm.to_dense()
    elif case == "outlier_matmul":
        y = ops.outlier_matmul(tx, tsl.outliers)
        want = jax_ops.outlier_matmul(jx, jsl.outliers, **kw)
        dense = tsl.outliers.to_dense()
    else:
        y = ops.sparse_linear_apply(tx, tsl.nm, tsl.outliers)
        want = jax_ops.sparse_linear_apply(jx, jsl.nm, jsl.outliers, **kw)
        dense = tsl.to_dense()
    assert tuple(y.shape) == tuple(want.shape)
    _assert_within_summation_order(y.numpy(), want, tx.numpy(), dense.numpy())


def test_unfused_pair_equals_fused_on_cpu():
    """W_nm holds exact zeros at the salient slots, so nm_matmul +
    outlier_matmul is the fused product up to f32 summation order."""
    _, tsl, _ = _sparsified(16, 64, 512, seed=6)
    _, tx = _x(8, 512, 7)
    fused = ops.sparse_linear_apply(tx, tsl.nm, tsl.outliers)
    pair = ops.nm_matmul(tx, tsl.nm) + ops.outlier_matmul(tx, tsl.outliers)
    dense = tsl.to_dense()
    _assert_within_summation_order(pair.numpy(), fused.numpy(), tx.numpy(),
                                   dense.numpy())
    _assert_within_summation_order(fused.numpy(), (tx @ dense.T).numpy(),
                                   tx.numpy(), dense.numpy())


# ------------------------------------------ the CUDA bodies' plan, on the CPU
# ``plan`` picks the decode body (``csrc/outlier_spmm.cu``,
# ``outlier_decode_kernel``) at M <= T and the prefill body
# (``outlier_prefill_kernel``) above, and the split of K each runs; the
# kernels themselves run only on the card (``tests/test_torch_cuda.py``).
SMS = 132                                      # an H100 SXM
T = port_osp.DECODE_MAX_M
LLAMA = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]  # (N, K)
RAGGED = [(N, K) for N in (37, 70, 300) for K in (256, 768, 4096)]
SWEEP = [(14336, 4096), (4096, 14336)]        # w_gate, w_down
SWEEP_MS = [1, 2, 4, 8, 12, 16, 24, 37, 64]


def _forced(path, M, K, N, n, sms=SMS):
    """``plan``'s choice for ``path`` at this M, whatever T is."""
    p = port_osp.plan(M, K, N, n, sms,
                      decode_max_m=M if path == "decode" else 0)
    assert p.path == path
    return p


def _one_group_a_slice(p, M, K, N):
    """``p`` with K split one 256-wide group a slice."""
    S = K // 256
    tiles = p.counters if p.splits > 1 else p.blocks
    return dataclasses.replace(
        p, splits=S, k_per_split=256,
        workspace_bytes=S * M * N * 4 if S > 1 else 0, blocks=tiles * S,
        counters=tiles if S > 1 else 0)


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("M", [1, 2, 4, T, T + 1, 37, 64, 65, 512])
def test_plan_routes_by_t(M, n):
    """M <= T takes the decode body, M > T the prefill body."""
    for N, K in LLAMA:
        p = port_osp.plan(M, K, N, n, SMS)
        assert p.path == ("decode" if M <= T else "prefill")


@pytest.mark.parametrize("n", [12, 20, 64, 256])
@pytest.mark.parametrize("M", [1, 37, 512])
def test_plan_takes_the_decode_body_for_other_n(M, n):
    """The prefill body is compiled for n = 4, 8, 16 only."""
    assert port_osp.plan(M, 4096, 4096, n, SMS).path == "decode"


@pytest.mark.parametrize("N,K", LLAMA + RAGGED)
@pytest.mark.parametrize("M", [1, 3, 8, 9, 37, 64, 65, 130, 512])
@pytest.mark.parametrize("path", ["decode", "prefill"])
@pytest.mark.parametrize("n", [4, 16])
def test_plan_splits_cover_k(n, path, M, N, K):
    """The slices cover K on multiples of 256, the last one ragged but
    never cut inside a group; the grid, the workspace (S x M x N f32, none
    for one slice), the counters (one per output tile) and the shared
    memory match what the bodies take."""
    p = _forced(path, M, K, N, n)
    S, kps = p.splits, p.k_per_split
    assert S >= 1 and kps % 256 == 0
    edges = [min(s * kps, K) for s in range(S + 1)]
    assert edges[-1] == K and (S - 1) * kps < K          # no empty slice
    assert all(e % 256 == 0 for e in edges)
    assert all(b - a == kps for a, b in zip(edges[:-2], edges[1:-1]))
    if path == "decode":
        assert p.rows in (2, 4, 8) and p.rows >= min(M, 8)
        assert p.cols in (32, 64, 128)
        assert kps * p.rows * 2 <= port_osp.X_SLICE_BYTES
    else:
        assert p.rows == (64 if M <= 64 else 128) and p.cols == 2 * p.rows
        smem = port_osp.prefill_smem_bytes(p.rows, n)
        assert smem <= 232448                       # a block's limit
        assert port_osp.prefill_blocks_per_sm(p.rows, n) * (smem + 1024) \
            <= port_osp.SM_SHARED_BYTES
    tiles = -(-N // p.cols) * -(-M // p.rows)
    assert p.blocks == tiles * S
    assert p.counters == (tiles if S > 1 else 0)
    assert p.workspace_bytes == (S * M * N * 4 if S > 1 else 0)


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("N,K", SWEEP)
@pytest.mark.parametrize("M", SWEEP_MS)
@pytest.mark.parametrize("path", ["decode", "prefill"])
def test_plan_fills_the_card_at_the_sweeps_shapes(path, M, N, K, n):
    """Either body, forced at any M of the T sweep, launches at least one
    block per SM at w_gate and w_down."""
    assert _forced(path, M, K, N, n).blocks >= SMS


def test_plan_prefill_splits_only_short_grids():
    """The prefill body splits K where its tiles leave SMs idle (wk at M =
    37: 4 tiles) and not where they fill the card (w_gate at M = 512)."""
    assert port_osp.plan(37, 4096, 1024, 16, SMS).splits == 16
    assert port_osp.plan(512, 4096, 14336, 16, SMS).splits == 1


def test_plan_rejects_what_the_kernels_do_not_take():
    for args in ((8, 384, 96, 16), (0, 256, 96, 16), (8, 256, 96, 6),
                 (8, 256, 0, 16)):
        with pytest.raises(ValueError):
            port_osp.plan(*args, SMS)


def test_gather8_plan_is_never_picked():
    assert all(port_osp.plan(M, K, N, 16, SMS).path != "gather8"
               for M in (1, 8, 9, 512) for N, K in LLAMA)
    p = port_osp.gather8_plan(37, 4096, 1000)
    assert (p.path, p.splits, p.workspace_bytes, p.blocks) == \
        ("gather8", 1, 0, 63 * 5)


# ------------------------------------------------- the bodies' arithmetic
def decode_model(x, values, meta, n, p):
    """What the decode body computes for plan ``p``, in f32 before the
    final rounding to bf16: in each split, lane l of a warp takes index
    words l, l + 32, ... of the slice and adds value x x for the word's
    four outliers in byte order; the warp's 32 partial sums are added in
    pairs l, l ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1; the splits are summed in
    order, 0 + p0 + p1 + ....  [M, N]."""
    M, K = x.shape
    N, G = values.shape[:2]
    xf, vf = x.float(), values.float()
    idx = unpack_outlier_meta(meta, n).long()
    wpg = n // 4
    lanes = torch.arange(32)
    total = torch.zeros((M, N))
    for s in range(p.splits):
        g0 = s * p.k_per_split // 256
        g1 = min(G, g0 + p.k_per_split // 256)
        words = (g1 - g0) * wpg
        v = vf[:, g0:g1].reshape(N, words, 4)
        col = (idx[:, g0:g1] + 256 * torch.arange(g0, g1)[None, :, None]
               ).reshape(N, words, 4)
        acc = torch.zeros((N, M, 32))
        for t in range(-(-words // 32)):
            w = t * 32 + lanes
            live = w < words
            wc = torch.where(live, w, 0)
            for q in range(4):
                vq = torch.where(live, v[:, wc, q], 0.0)           # [N, 32]
                xq = xf[:, col[:, wc, q]].permute(1, 0, 2)      # [N, M, 32]
                acc = acc + vq[:, None, :] * xq
        for _ in range(5):                      # offsets 16, 8, 4, 2, 1
            half = acc.shape[-1] // 2
            acc = acc[..., :half] + acc[..., half:]
        total = total + acc[..., 0].T
    return total


def prefill_model(x, values, meta, n, p):
    """What the prefill body computes for plan ``p``, in f32 before the
    final rounding to bf16: each (x row, output row) sum runs in one lane
    over the slice's groups in order and each group's outliers in order;
    the splits are summed in order, 0 + p0 + p1 + ....  [M, N]."""
    M, K = x.shape
    N, G = values.shape[:2]
    xf, vf = x.float(), values.float()
    idx = unpack_outlier_meta(meta, n).long()
    total = torch.zeros((M, N))
    for s in range(p.splits):
        g0 = s * p.k_per_split // 256
        acc = torch.zeros((M, N))
        for g in range(g0, min(G, g0 + p.k_per_split // 256)):
            for j in range(n):
                acc = acc + xf[:, 256 * g + idx[:, g, j]] * vf[:, g, j]
        total = total + acc
    return total


def _bf16_outliers(N, K, n, seed):
    """Random N:256 outliers and x, bf16 in both packages: distinct
    ascending indices per group, index 255 in the last slot of every
    seventh row (the top byte of a word, which makes it negative)."""
    rng = np.random.default_rng(seed)
    G = K // 256
    idx = np.sort(np.stack([np.stack([rng.choice(256, n, replace=False)
                                      for _ in range(G)]) for _ in range(N)]),
                  axis=-1).astype(np.int32)
    idx[::7, :, -1] = 255
    vals = jnp.asarray(rng.standard_normal((N, G, n)).astype(np.float32)
                       ).astype(jnp.bfloat16)
    return vals, idx


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("K", [256, 768, 4096])
@pytest.mark.parametrize("N", [37, 70, 300])
@pytest.mark.parametrize("M", [1, 8, 9, 37])
def test_body_models_match_reference_and_pallas(M, N, K, n):
    """Both bodies' summation orders, each with its plan's split and with
    one group a slice, against the port's ``outlier_spmm_ref`` and JAX's
    Pallas ``outlier_spmm`` in interpret mode on the same bf16 inputs
    (products exact in f32, so the sums differ in order only: the
    summation-order bound), and rounded to bf16 against the port's plain
    version to one bf16 ulp."""
    jvals, idx = _bf16_outliers(N, K, n, seed=M * N + K + n)
    assert (idx == 255).any()
    jx, _ = _x(M, K, n, jnp.bfloat16)
    x = to_torch(np.asarray(jx))
    vals = to_torch(np.asarray(jvals))
    meta = pack_outlier_meta(torch.from_numpy(idx))
    assert bool((meta < 0).any())
    pallas = jax_outlier_spmm(jx.astype(jnp.float32),
                              jvals.astype(jnp.float32), jax_pack(idx), n=n,
                              interpret=True, block_b=M, block_o=N,
                              block_k=K)
    oracle = outlier_spmm_ref(x.float(), vals.float(), torch.from_numpy(idx))
    dense = torch.zeros((N, K))
    dense.scatter_(1, torch.from_numpy(
        (idx + 256 * np.arange(K // 256)[None, :, None]).reshape(N, -1)
    ).long(), vals.float().reshape(N, -1))
    plain = port_osp.plain(x, vals, meta, n=n)
    for path, model in (("decode", decode_model),
                        ("prefill", prefill_model)):
        p = _forced(path, M, K, N, n)
        for q in (p, _one_group_a_slice(p, M, K, N)):
            y = model(x, vals, meta, n, q)
            for want in (np.asarray(pallas), oracle.numpy()):
                _assert_within_summation_order(y.numpy(), want,
                                               x.float().numpy(),
                                               dense.numpy())
            _assert_within_one_ulp(plain, y.to(torch.bfloat16).float())
