"""The decode path of the port's fused kernel (``csrc/fused_sparse_linear.cu``)
on the CPU, where the kernel cannot run, and a windowed model held against
the JAX package.

- ``plan``: the split of K that the wrapper hands the kernel, for llama3-8b's
  four projection shapes and for ragged ones: the slices cover K exactly on
  multiples of 256, the workspace is S x M x N f32 (none for one slice), the
  decode grid fills a 132-SM card at M = 8, and M > T takes the prefill
  kernel.
- ``kernel_model``: the kernel's arithmetic, step by step, in f32 on the
  CPU: each lane's partial sum over its N:M blocks (kept values in order)
  and its outlier entries, the warp's shuffle butterfly, and the splits
  summed in order.  It is held to ``fused_sparse_linear_ref`` and to the
  JAX package's Pallas kernels in interpret mode on the same bf16 inputs:
  the products are exact in f32, so only the order of the sums differs,
  rtol = atol = 1e-5.  Against JAX's int8 kernel, which keeps the
  dequantized weight in f32 where the port rounds it once to bf16 (as JAX's
  ``sparse_apply`` does), the bound is that rounding: 2**-8 of
  |x| @ |W|^T, plus 1e-5.
- A 2-layer mistral-shaped model (GQA, sliding window 10) at f32: the
  full-sequence ``forward`` against JAX's (atol 1e-4, summation order only)
  and greedy streams identical to the JAX engine's on the slot, paged and
  chunked (token budget 16) engines, with prompts longer than the window.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.kernels.fused_sparse_linear import \
    fused_sparse_linear as jax_fused  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models.sparse_serving import _to_sparse_weight  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import unpack_metadata, unpack_outlier_meta  # noqa: E402
from repro_torch.interchange import _sparse_weight, from_jax_params  # noqa: E402
from repro_torch.kernels import fused_sparse_linear as fsl  # noqa: E402
from repro_torch.kernels.ref import (dequantize,  # noqa: E402
                                     fused_sparse_linear_ref)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import (SamplingParams, ServingEngine,  # noqa: E402
                                 Status)

T = fsl.DECODE_MAX_M
SMS = 132                                      # an H100 SXM
LLAMA = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]  # (N, K)
RAGGED = [(N, K) for N in (96, 200) for K in (256, 768, 14336)]
TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- plan
@pytest.mark.parametrize("N,K", LLAMA + RAGGED)
@pytest.mark.parametrize("M", [1, 8, T])
@pytest.mark.parametrize("n,m,o_n", [(8, 16, 16), (4, 8, 4)])
def test_plan_splits_cover_k(M, N, K, n, m, o_n):
    p = fsl.plan(M, K, N, n, m, o_n, SMS)
    assert p.path == "decode" and p.rows in (2, 4, 8) and p.rows >= min(M, 8)
    S, kps = p.splits, p.k_per_split
    assert S >= 1 and kps % 256 == 0
    edges = [min(s * kps, K) for s in range(S + 1)]
    assert edges[-1] == K and (S - 1) * kps < K       # no empty slice
    assert all(e % 256 == 0 for e in edges)
    if K == 256:
        assert S == 1
    assert p.workspace_bytes == (S * M * N * 4 if S > 1 else 0)
    assert kps * p.rows * 2 <= fsl.X_SLICE_BYTES       # the staged x slice
    tiles = -(-M // p.rows)
    assert p.blocks == -(-N // fsl.BLOCK_ROWS) * tiles * S
    assert p.counters == (p.blocks // S if S > 1 else 0)


@pytest.mark.parametrize("N,K", LLAMA)
def test_plan_fills_the_card_at_decode(N, K):
    """At 8 lanes every llama3-8b projection, wk/wv's 1024 rows included,
    gets at least one block per SM."""
    p = fsl.plan(8, K, N, 8, 16, 16, SMS)
    assert p.path == "decode" and p.blocks >= SMS


@pytest.mark.parametrize("N,K", LLAMA + RAGGED)
@pytest.mark.parametrize("M", [T + 1, 37, 512])
def test_plan_takes_the_tile_kernel_above_t(M, N, K):
    """Above T the plan takes the prefill kernel
    (``csrc/fused_sparse_linear_prefill.cu``), which replaced the tile
    kernel there; the tile kernel is reachable only through
    ``force_plan=tile_plan(...)``."""
    p = fsl.plan(M, K, N, 8, 16, 16, SMS)
    assert p.path == "prefill" and p.rows in (64, 128, 256)
    assert p.splits * p.k_per_split >= K > (p.splits - 1) * p.k_per_split
    assert p.workspace_bytes == (p.splits * M * N * 4 if p.splits > 1 else 0)


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        fsl.plan(8, 384, 96, 8, 16, 16, SMS)             # in % 256
    with pytest.raises(ValueError):
        fsl.plan(0, 256, 96, 8, 16, 16, SMS)


# ------------------------------------------------- the kernel's arithmetic
def kernel_model(x, values, meta, o_values, o_meta, *, n, m, o_n, scale,
                 p):
    """What ``csrc/fused_sparse_linear.cu`` computes for ``p``, before the
    final rounding to bf16: f32 [M, N].  ``x`` bf16; ``values`` bf16, or
    int8 with ``scale`` (rounded to bf16 after the scale, as the kernel
    does); the outliers bf16."""
    M, K = x.shape
    N = values.shape[0]
    xf = x.float()
    vals = dequantize(values, scale, torch.bfloat16).float().reshape(
        N, K // m, n)
    idx = unpack_metadata(meta, n).long()
    ov = o_values.float()
    oidx = unpack_outlier_meta(o_meta, o_n).long()
    lanes = torch.arange(32)
    total = torch.zeros((M, N))
    for s in range(p.splits):
        k0 = s * p.k_per_split
        cols = min(p.k_per_split, K - k0)
        b0, nb = k0 // m, cols // m
        g0, ne = k0 // 256, cols // 256 * o_n
        acc = torch.zeros((M, N, 32))
        for step in range(max(-(-nb // 32), -(-ne // 32))):
            e = step * 32 + lanes
            live = e < nb                     # lane e takes N:M block e
            b = b0 + torch.where(live, e, 0)
            for k in range(n):                # kept values in order
                col = b * m + idx[:, b, k]
                acc = torch.where(live, acc + vals[:, b, k] * xf[:, col], acc)
            live = e < ne                     # and outlier entry e
            eo = torch.where(live, e, 0)
            g, j = g0 + eo // o_n, eo % o_n
            col = g * 256 + oidx[:, g, j]
            acc = torch.where(live, acc + ov[:, g, j] * xf[:, col], acc)
        for off in (16, 8, 4, 2, 1):          # lane l adds lane l ^ off
            acc = acc + acc[..., lanes ^ off]
        total = total + acc[..., 0]           # 0 + p0 + p1 + ...
    return total


OUT, IN = 96, 512


def _weights(o_n, quantize, seed):
    """JAX's SparseWeight on bf16-valued weights (magnitude, no SmoothQuant)
    and the port's copy with bf16 N:M values (or int8 with scales) and bf16
    outliers; the JAX arrays hold exactly what the port holds."""
    w = np.random.default_rng(seed).standard_normal((OUT, IN)).astype(
        np.float32) / np.sqrt(IN)
    w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    cfg = JaxSparsifyConfig(weight_pattern="8:16",
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
@pytest.mark.parametrize("o_n", [4, 16])
@pytest.mark.parametrize("M", [1, 8])
def test_kernel_model_matches_ref_and_jax(M, o_n, quantize):
    jsw, tsw = _weights(o_n, quantize, seed=o_n + M)
    x = torch.from_numpy(np.random.default_rng(M).standard_normal(
        (M, IN)).astype(np.float32)).to(torch.bfloat16)
    p = fsl.plan(M, IN, OUT, tsw.n, tsw.m, o_n, SMS)
    assert p.path == "decode" and p.splits == 2     # the split is exercised
    kw = dict(n=tsw.n, m=tsw.m, o_n=o_n, scale=tsw.v_scale)
    got = kernel_model(x, tsw.nm_values, tsw.nm_meta, tsw.o_values,
                       tsw.o_meta, p=p, **kw)
    # the port's plain f32 product on the same (dequantized, bf16) weights
    w_nm = dequantize(tsw.nm_values, tsw.v_scale, torch.bfloat16).float()
    idx, oidx = (unpack_metadata(tsw.nm_meta, tsw.n),
                 unpack_outlier_meta(tsw.o_meta, o_n))
    ref = fused_sparse_linear_ref(x.float(), w_nm, idx, tsw.m,
                                  tsw.o_values.float(), oidx)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    # rounded to bf16, within one bf16 ulp of the wrapper's plain version
    y = fsl.fused_sparse_linear(x, tsw.nm_values, tsw.nm_meta, tsw.o_values,
                                tsw.o_meta, **kw)
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


def test_kernel_model_is_the_same_for_every_split():
    """One slice or several: the same sum to f32 rounding, so the split is
    a schedule, not a different function."""
    jsw, tsw = _weights(16, False, seed=9)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (8, IN)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(n=tsw.n, m=tsw.m, o_n=16, scale=None)
    args = (x, tsw.nm_values, tsw.nm_meta, tsw.o_values, tsw.o_meta)
    one = fsl.Plan("decode", 8, 1, IN, 0, 3, 0)
    two = fsl.plan(8, IN, OUT, 8, 16, 16, SMS)
    assert two.splits == 2
    np.testing.assert_allclose(kernel_model(*args, p=one, **kw).numpy(),
                               kernel_model(*args, p=two, **kw).numpy(),
                               **TOL)


# ------------------------------------------------ the windowed model, pinned
SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=256, vocab=512, window=10)
JCFG = dataclasses.replace(jax_configs.get("mistral-7b"),
                           name="torch-window", remat=False,
                           dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get("mistral-7b"), name="torch-window",
                          dtype=torch.float32, **SHAPE)
PROMPT_LENS = [5, 23, 12, 40, 9, 17]
ENGINES = {"slot": dict(n_slots=4, max_len=64, token_budget=256),
           "paged": dict(n_slots=4, max_len=64, token_budget=256,
                         kv_layout="paged", block_size=8),
           "chunked": dict(n_slots=4, max_len=64, token_budget=16)}


@pytest.fixture(scope="module")
def window_params():
    jparams = jax_tfm.init_params(jax.random.PRNGKey(3), JCFG)
    return jparams, from_jax_params(jparams, device="cpu")


def test_windowed_forward_matches_jax(window_params):
    jparams, tparams = window_params
    tokens = np.random.default_rng(4).integers(0, CFG.vocab, (2, 32))
    jlogits, _ = jax_tfm.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                 JCFG)
    with torch.no_grad():
        logits, _ = tfm.forward(tparams, {"tokens": torch.from_numpy(tokens)},
                                CFG)
    assert logits.shape == (2, 32, CFG.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_windowed_streams_identical_to_jax_engine(window_params, engine):
    jparams, tparams = window_params
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, CFG.vocab, n).tolist() for n in PROMPT_LENS]
    jengine = JaxServingEngine(JCFG, jparams, **ENGINES[engine])
    jreqs = [jengine.submit(p, JaxSamplingParams(max_new_tokens=6))
             for p in prompts]
    jengine.run(max_steps=200)
    tengine = ServingEngine(CFG, tparams, device="cpu", **ENGINES[engine])
    treqs = [tengine.submit(p, SamplingParams(max_new_tokens=6))
             for p in prompts]
    tengine.run(max_steps=200)
    for j, t in zip(jreqs, treqs):
        assert t.status is Status.FINISHED and len(t.tokens) == 6
        assert t.tokens == j.tokens, f"request {t.request_id} diverged"
        assert t.metrics.prefill_chunks == j.metrics.prefill_chunks
    if engine == "chunked":
        assert max(t.metrics.prefill_chunks for t in treqs) > 1
    assert max(PROMPT_LENS) > CFG.window
