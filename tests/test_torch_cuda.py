"""The port's CUDA kernels on the card, bf16 and int8 variants and
``outlier_spmm``: each against its plain version at small and ragged shapes
(M, N and K not multiples of the tiles), ``kernels/ops`` and the paper's
pipeline on the card, and the wrappers' refusals — a CUDA tensor reaching
a wrapper launches the kernel or raises, it never falls back to the plain
version.

Needs a card and nvcc; skips elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import contextlib
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SparsifyConfig  # noqa: E402
from repro_torch.kernels import fused_sparse_linear as fsl  # noqa: E402
from repro_torch.kernels import nm_spmm as nms  # noqa: E402
from repro_torch.models.sparse_serving import (sparse_apply,  # noqa: E402
                                               to_sparse_weight)

pytestmark = pytest.mark.cuda

# bf16 inputs, exact products, f32 sums in another order, one final rounding:
# at most one bf16 ulp of the largest output, 2**-7 of its magnitude
TOL_REL = 2.0 ** -7


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _sparse(N, K, weight_pattern, outlier_pattern, seed, device,
            quantize=False):
    g = torch.Generator(device=device).manual_seed(seed)
    w = (torch.randn((N, K), generator=g, device=device)
         / math.sqrt(K)).to(torch.bfloat16)
    cfg = SparsifyConfig(weight_pattern=weight_pattern,
                         outlier_pattern=outlier_pattern, scorer="magnitude",
                         use_smoothquant=False)
    return to_sparse_weight(w, cfg, quantize=quantize), g


def _close(y, y_plain):
    err = float((y.float() - y_plain.float()).abs().max())
    assert err <= TOL_REL * float(y_plain.float().abs().max()), err


def _close_rows(y, y_plain):
    """Row by row, for paged_attention's decode body: each output row (a
    lane's query and q head) within TOL_REL of that row's largest output,
    so a long lane's small outputs are held at their own scale."""
    err = (y.float() - y_plain.float()).abs().amax(-1)
    tol = TOL_REL * y_plain.float().abs().amax(-1)
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("weight_pattern", ["8:16", "4:8", "2:4"])
@pytest.mark.parametrize("N,K", [(96, 128), (200, 512), (64, 768)])
@pytest.mark.parametrize("M", [1, 3, 17, 64, 130])
def test_nm_spmm_matches_plain(cuda, M, N, K, weight_pattern):
    sw, g = _sparse(N, K, weight_pattern, None, M, cuda)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    before = nms.launches
    y = nms.nm_spmm(x, sw.nm_values, sw.nm_meta, n=sw.n, m=sw.m)
    assert nms.launches == before + 1
    torch.cuda.synchronize()
    _close(y, nms.plain(x, sw.nm_values, sw.nm_meta, n=sw.n, m=sw.m))


@pytest.mark.parametrize("o_n", [4, 8, 16])
@pytest.mark.parametrize("N,K", [(96, 256), (200, 768)])
@pytest.mark.parametrize("M", [1, 5, 37, 130])
def test_fused_matches_plain(cuda, M, N, K, o_n):
    sw, g = _sparse(N, K, "8:16", f"{o_n}:256", M, cuda)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args = (x, sw.nm_values, sw.nm_meta, sw.o_values, sw.o_meta)
    kw = dict(n=sw.n, m=sw.m, o_n=sw.o_n)
    before = fsl.launches
    y = fsl.fused_sparse_linear(*args, **kw)
    assert fsl.launches == before + 1
    torch.cuda.synchronize()
    _close(y, fsl.plain(*args, **kw))


@pytest.mark.parametrize("weight_pattern", ["8:16", "4:8", "2:4"])
@pytest.mark.parametrize("N,K", [(96, 128), (200, 512)])
@pytest.mark.parametrize("M", [1, 17, 130])
def test_nm_spmm_int8_matches_plain(cuda, M, N, K, weight_pattern):
    sw, g = _sparse(N, K, weight_pattern, None, M, cuda, quantize=True)
    assert sw.nm_values.dtype == torch.int8
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args = (x, sw.nm_values, sw.nm_meta)
    kw = dict(n=sw.n, m=sw.m, scale=sw.v_scale)
    before = (nms.launches, nms.launches_int8)
    y = nms.nm_spmm(*args, **kw)
    assert (nms.launches, nms.launches_int8) == (before[0], before[1] + 1)
    torch.cuda.synchronize()
    _close(y, nms.plain(*args, **kw))


@pytest.mark.parametrize("o_n", [4, 16])
@pytest.mark.parametrize("N,K", [(96, 256), (200, 768)])
@pytest.mark.parametrize("M", [1, 37, 130])
def test_fused_int8_matches_plain(cuda, M, N, K, o_n):
    sw, g = _sparse(N, K, "8:16", f"{o_n}:256", M, cuda, quantize=True)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args = (x, sw.nm_values, sw.nm_meta, sw.o_values, sw.o_meta)
    kw = dict(n=sw.n, m=sw.m, o_n=sw.o_n, scale=sw.v_scale)
    before = (fsl.launches, fsl.launches_int8)
    y = fsl.fused_sparse_linear(*args, **kw)
    assert (fsl.launches, fsl.launches_int8) == (before[0], before[1] + 1)
    torch.cuda.synchronize()
    _close(y, fsl.plain(*args, **kw))


def test_int8_zero_row_and_exact_outliers(cuda):
    """An all-zero row (scale 1) gives zeros; the outliers of a row are
    added unscaled on top of its dequantized N:M values."""
    sw, g = _sparse(64, 256, "8:16", "16:256", 5, cuda, quantize=True)
    sw.nm_values[3] = 0
    sw.v_scale[3] = 1.0
    sw.o_values[3] = 0
    x = torch.randn((4, 256), generator=g, device=cuda).to(torch.bfloat16)
    args = (x, sw.nm_values, sw.nm_meta, sw.o_values, sw.o_meta)
    kw = dict(n=sw.n, m=sw.m, o_n=sw.o_n, scale=sw.v_scale)
    y = fsl.fused_sparse_linear(*args, **kw)
    torch.cuda.synchronize()
    assert not y[:, 3].any()
    _close(y, fsl.plain(*args, **kw))


# ------------------------------------- the fused kernel's decode path (M <= T)
T = fsl.DECODE_MAX_M


def _fused_args(sw, x):
    return ((x, sw.nm_values, sw.nm_meta, sw.o_values, sw.o_meta),
            dict(n=sw.n, m=sw.m, o_n=sw.o_n, scale=sw.v_scale))


def _sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("o_n", [4, 8, 16])
@pytest.mark.parametrize("K", [256, 768, 14336])
@pytest.mark.parametrize("N", [96, 200, 1024])
@pytest.mark.parametrize("M", [1, 3, 8, T, T + 1])
def test_fused_decode_matches_plain(cuda, M, N, K, o_n, quantize):
    """At M <= T the decode kernel (``csrc/fused_sparse_linear.cu``), at
    T + 1 the prefill kernel; one launch counted per call either way."""
    sw, g = _sparse(N, K, "8:16", f"{o_n}:256", M * 7 + N + K, cuda,
                    quantize=quantize)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    p = fsl.plan(M, K, N, sw.n, sw.m, o_n, _sm_count())
    assert p.path == ("decode" if M <= T else "prefill")
    before = (fsl.launches, fsl.launches_int8, fsl.launches_decode,
              fsl.launches_decode_int8, fsl.launches_prefill,
              fsl.launches_prefill_int8)
    y = fsl.fused_sparse_linear(*args, **kw)
    decode = int(p.path == "decode")
    assert (fsl.launches, fsl.launches_int8, fsl.launches_decode,
            fsl.launches_decode_int8, fsl.launches_prefill,
            fsl.launches_prefill_int8) == (
        before[0] + (not quantize), before[1] + quantize,
        before[2] + decode * (not quantize), before[3] + decode * quantize,
        before[4] + (1 - decode) * (not quantize),
        before[5] + (1 - decode) * quantize)
    torch.cuda.synchronize()
    assert y.shape == (M, N) and y.dtype == torch.bfloat16
    _close(y, fsl.plain(*args, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("weight_pattern,o_n", [("4:8", 16), ("2:4", 4),
                                                ("8:16", 32)])
@pytest.mark.parametrize("M", [1, 8])
def test_fused_decode_other_shapes_match_plain(cuda, M, weight_pattern, o_n,
                                               quantize):
    """Shapes other than 8:16 + 16:256 take the same kernel body with
    runtime n, m and o_n (no plain fallback)."""
    sw, g = _sparse(200, 1024, weight_pattern, f"{o_n}:256", M, cuda,
                    quantize=quantize)
    x = torch.randn((M, 1024), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    before = fsl.launches_decode + fsl.launches_decode_int8
    y = fsl.fused_sparse_linear(*args, **kw)
    assert fsl.launches_decode + fsl.launches_decode_int8 == before + 1
    torch.cuda.synchronize()
    _close(y, fsl.plain(*args, **kw))


def _with_index_255(sw, g):
    """Outlier indices with 255 in the last slot of every seventh row's
    groups: the top byte of a meta word, which makes the int32 negative."""
    from repro_torch.core import pack_outlier_meta
    N, G, o_n = sw.o_values.shape
    fresh = torch.rand((N, G, 256), generator=g, device=sw.o_values.device)
    idx = torch.sort(fresh.argsort(-1)[..., :o_n], dim=-1).values.int()
    idx[::7, :, -1] = 255
    idx = torch.sort(idx, dim=-1).values
    meta = pack_outlier_meta(idx)
    assert bool((meta < 0).any())
    return meta


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("M", [1, 8])
def test_fused_decode_index_255(cuda, M, quantize):
    sw, g = _sparse(200, 768, "8:16", "16:256", 11 + M, cuda,
                    quantize=quantize)
    sw = dataclasses.replace(sw, o_meta=_with_index_255(sw, g))
    x = torch.randn((M, 768), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    y = fsl.fused_sparse_linear(*args, **kw)
    torch.cuda.synchronize()
    _close(y, fsl.plain(*args, **kw))


@pytest.mark.parametrize("M", [1, 8])
def test_fused_decode_int8_zero_row(cuda, M):
    sw, g = _sparse(96, 768, "8:16", "16:256", 12 + M, cuda, quantize=True)
    sw.nm_values[3] = 0
    sw.v_scale[3] = 1.0
    sw.o_values[3] = 0
    x = torch.randn((M, 768), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    assert fsl.plan(M, 768, 96, 8, 16, 16, _sm_count()).path == "decode"
    y = fsl.fused_sparse_linear(*args, **kw)
    torch.cuda.synchronize()
    assert not y[:, 3].any()
    _close(y, fsl.plain(*args, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("M,N,K", [(8, 4096, 14336), (1, 1024, 4096),
                                   (T, 200, 768)])
def test_fused_decode_is_deterministic(cuda, M, N, K, quantize):
    """Split-K partials are summed in split order by the last block: two
    calls give the same bits (and leave the counters ready for a third)."""
    sw, g = _sparse(N, K, "8:16", "16:256", 13, cuda, quantize=quantize)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    assert fsl.plan(M, K, N, 8, 16, 16, _sm_count()).path == "decode"
    ys = [fsl.fused_sparse_linear(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[1], ys[2])
    _close(ys[0], fsl.plain(*args, **kw))


def test_fused_decode_never_reaches_plain(cuda, monkeypatch):
    """On a CUDA tensor at M <= T the wrapper launches the decode kernel;
    the plain version is not called."""
    cases = []
    for quantize in (False, True):
        sw, g = _sparse(200, 768, "8:16", "16:256", 14, cuda,
                        quantize=quantize)
        for M in (1, 8, T):
            x = torch.randn((M, 768), generator=g, device=cuda).to(
                torch.bfloat16)
            args, kw = _fused_args(sw, x)
            cases.append((args, kw, fsl.plain(*args, **kw)))

    def refuse(*a, **k):
        raise AssertionError("the plain version was called on CUDA tensors")
    monkeypatch.setattr(fsl, "plain", refuse)
    monkeypatch.setattr(fsl, "fused_sparse_linear_ref", refuse)
    before = fsl.launches_decode + fsl.launches_decode_int8
    for args, kw, want in cases:
        y = fsl.fused_sparse_linear(*args, **kw)
        torch.cuda.synchronize()
        _close(y, want)
    assert fsl.launches_decode + fsl.launches_decode_int8 == before + 6


# ------------------------------------ the fused kernel's prefill path (M > T)
def _prefill_counts():
    return (fsl.launches, fsl.launches_int8, fsl.launches_prefill,
            fsl.launches_prefill_int8)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("o_n", [4, 8, 16])
@pytest.mark.parametrize("K", [256, 768, 14336])
@pytest.mark.parametrize("N", [96, 200, 1024])
@pytest.mark.parametrize("M", [T + 1, 37, 64, 65, 129, 512])
def test_fused_prefill_matches_plain(cuda, M, N, K, o_n, quantize):
    """At M > T the prefill kernel (``csrc/fused_sparse_linear_prefill.cu``)
    against the plain version, ragged M and N included; one launch counted
    per call, as a prefill launch."""
    sw, g = _sparse(N, K, "8:16", f"{o_n}:256", M * 7 + N + K + 1, cuda,
                    quantize=quantize)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    assert fsl.plan(M, K, N, sw.n, sw.m, o_n, _sm_count()).path == "prefill"
    before = _prefill_counts()
    y = fsl.fused_sparse_linear(*args, **kw)
    assert _prefill_counts() == (
        before[0] + (not quantize), before[1] + quantize,
        before[2] + (not quantize), before[3] + quantize)
    torch.cuda.synchronize()
    assert y.shape == (M, N) and y.dtype == torch.bfloat16
    _close(y, fsl.plain(*args, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("weight_pattern,o_n", [("4:8", 16), ("2:4", 4),
                                                ("8:16", 32), ("1:4", 8)])
@pytest.mark.parametrize("M", [37, 130])
def test_fused_prefill_other_shapes_match_plain(cuda, M, weight_pattern, o_n,
                                                quantize):
    """Shapes other than 8:16 + 16:256 take the prefill kernel's generic
    instance (runtime n, m and o_n), never the plain version."""
    sw, g = _sparse(200, 1024, weight_pattern, f"{o_n}:256", M, cuda,
                    quantize=quantize)
    x = torch.randn((M, 1024), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    before = fsl.launches_prefill + fsl.launches_prefill_int8
    y = fsl.fused_sparse_linear(*args, **kw)
    assert fsl.launches_prefill + fsl.launches_prefill_int8 == before + 1
    torch.cuda.synchronize()
    _close(y, fsl.plain(*args, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_fused_prefill_unaligned_meta_takes_the_generic_instance(cuda,
                                                                 quantize):
    """Meta words 4 bytes off a 16-byte boundary cannot be staged with
    16-byte copies: the same kernel body reads them from device memory."""
    sw, g = _sparse(200, 768, "8:16", "16:256", 21, cuda, quantize=quantize)
    flat = torch.zeros(sw.nm_meta.numel() + 1, dtype=torch.int32,
                       device=cuda)
    meta = flat[1:].view(sw.nm_meta.shape)
    meta.copy_(sw.nm_meta)
    assert meta.data_ptr() % 16
    sw = dataclasses.replace(sw, nm_meta=meta)
    x = torch.randn((37, 768), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    y = fsl.fused_sparse_linear(*args, **kw)
    torch.cuda.synchronize()
    _close(y, fsl.plain(*args, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("M", [37, 512])
def test_fused_prefill_index_255(cuda, M, quantize):
    sw, g = _sparse(200, 768, "8:16", "16:256", 31 + M, cuda,
                    quantize=quantize)
    sw = dataclasses.replace(sw, o_meta=_with_index_255(sw, g))
    x = torch.randn((M, 768), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    y = fsl.fused_sparse_linear(*args, **kw)
    torch.cuda.synchronize()
    _close(y, fsl.plain(*args, **kw))


@pytest.mark.parametrize("M", [37, 512])
def test_fused_prefill_int8_zero_row(cuda, M):
    sw, g = _sparse(96, 768, "8:16", "16:256", 32 + M, cuda, quantize=True)
    sw.nm_values[3] = 0
    sw.v_scale[3] = 1.0
    sw.o_values[3] = 0
    x = torch.randn((M, 768), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    assert fsl.plan(M, 768, 96, 8, 16, 16, _sm_count()).path == "prefill"
    y = fsl.fused_sparse_linear(*args, **kw)
    torch.cuda.synchronize()
    assert not y[:, 3].any()
    _close(y, fsl.plain(*args, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("M,N,K", [(37, 4096, 14336), (37, 1024, 4096),
                                   (512, 4096, 4096), (T + 1, 200, 768)])
def test_fused_prefill_is_deterministic(cuda, M, N, K, quantize):
    """Split-K partials are summed in split order by the last block: two
    calls give the same bits (and leave the counters ready for a third)."""
    sw, g = _sparse(N, K, "8:16", "16:256", 33, cuda, quantize=quantize)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    p = fsl.plan(M, K, N, 8, 16, 16, _sm_count())
    assert p.path == "prefill"
    ys = [fsl.fused_sparse_linear(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[1], ys[2])
    _close(ys[0], fsl.plain(*args, **kw))


def test_fused_prefill_never_reaches_plain_or_the_tile(cuda, monkeypatch):
    """On a CUDA tensor at M > T the wrapper launches the prefill kernel;
    neither the plain version nor the old tile kernel is called."""
    from repro_torch.kernels import build
    cases = []
    for quantize in (False, True):
        sw, g = _sparse(200, 768, "8:16", "16:256", 34, cuda,
                        quantize=quantize)
        for M in (T + 1, 37, 130):
            x = torch.randn((M, 768), generator=g, device=cuda).to(
                torch.bfloat16)
            args, kw = _fused_args(sw, x)
            cases.append((args, kw, fsl.plain(*args, **kw)))

    def refuse(*a, **k):
        raise AssertionError("the plain version or the tile kernel was "
                             "called on CUDA tensors")
    monkeypatch.setattr(fsl, "plain", refuse)
    monkeypatch.setattr(fsl, "fused_sparse_linear_ref", refuse)
    lib = build.library()
    for name in ("fused_sparse_linear_bf16", "fused_sparse_linear_int8"):
        monkeypatch.setattr(lib, name, refuse)
    before = fsl.launches_prefill + fsl.launches_prefill_int8
    for args, kw, want in cases:
        y = fsl.fused_sparse_linear(*args, **kw)
        torch.cuda.synchronize()
        _close(y, want)
    assert fsl.launches_prefill + fsl.launches_prefill_int8 == before + 6


def test_fused_tile_kernel_still_forced(cuda):
    """The old tile kernel stays callable through ``force_plan`` (to be
    timed beside the prefill kernel) and agrees with the plain version."""
    sw, g = _sparse(200, 768, "8:16", "16:256", 35, cuda)
    x = torch.randn((37, 768), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _fused_args(sw, x)
    before = (fsl.launches, fsl.launches_decode, fsl.launches_prefill)
    y = fsl.fused_sparse_linear(*args, force_plan=fsl.tile_plan(37, 768, 200),
                                **kw)
    assert (fsl.launches, fsl.launches_decode, fsl.launches_prefill) == (
        before[0] + 1, before[1], before[2])
    torch.cuda.synchronize()
    _close(y, fsl.plain(*args, **kw))


def test_fused_raises_on_misaligned_bf16_values(cuda):
    sw, g = _sparse(64, 256, "8:16", "16:256", 15, cuda)
    x = torch.randn((4, 256), generator=g, device=cuda).to(torch.bfloat16)
    flat = torch.zeros(sw.nm_values.numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    values = flat[1:].view(sw.nm_values.shape)          # 2-byte offset
    values.copy_(sw.nm_values)
    before = (fsl.launches, fsl.launches_decode)
    with pytest.raises(ValueError):
        fsl.fused_sparse_linear(x, values, sw.nm_meta, sw.o_values,
                                sw.o_meta, n=8, m=16, o_n=16)
    assert (fsl.launches, fsl.launches_decode) == before


def test_sparse_apply_routes_to_the_kernels(cuda):
    with_o, g = _sparse(128, 512, "8:16", "16:256", 0, cuda)
    without, _ = _sparse(128, 512, "8:16", None, 1, cuda)
    x = torch.randn((2, 3, 512), generator=g, device=cuda).to(torch.bfloat16)
    counts = (nms.launches, fsl.launches)
    assert sparse_apply(with_o, x).shape == (2, 3, 128)
    assert sparse_apply(without, x).shape == (2, 3, 128)
    assert (nms.launches, fsl.launches) == (counts[0] + 1, counts[1] + 1)
    with_o8, _ = _sparse(128, 512, "8:16", "16:256", 0, cuda, quantize=True)
    without8, _ = _sparse(128, 512, "8:16", None, 1, cuda, quantize=True)
    counts8 = (nms.launches_int8, fsl.launches_int8)
    assert sparse_apply(with_o8, x).shape == (2, 3, 128)
    assert sparse_apply(without8, x).shape == (2, 3, 128)
    assert (nms.launches_int8, fsl.launches_int8) == (counts8[0] + 1,
                                                      counts8[1] + 1)
    assert (nms.launches, fsl.launches) == (counts[0] + 1, counts[1] + 1)


def test_wrappers_raise_instead_of_falling_back(cuda):
    sw, g = _sparse(64, 256, "8:16", "16:256", 2, cuda)
    x = torch.randn((4, 256), generator=g, device=cuda)
    counts = (nms.launches, fsl.launches)
    with pytest.raises(TypeError):                      # f32 x on CUDA
        nms.nm_spmm(x, sw.nm_values, sw.nm_meta, n=8, m=16)
    with pytest.raises(TypeError):
        sparse_apply(sw, x)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError):                     # not contiguous
        nms.nm_spmm(xb.t().contiguous().t(), sw.nm_values, sw.nm_meta,
                    n=8, m=16)
    flat = torch.empty(4 * 256 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                     # not 16-byte aligned
        nms.nm_spmm(flat[1:].view(4, 256), sw.nm_values, sw.nm_meta,
                    n=8, m=16)
    with pytest.raises(ValueError):                     # buffers on the CPU
        nms.nm_spmm(xb, sw.nm_values.cpu(), sw.nm_meta.cpu(), n=8, m=16)
    with pytest.raises(ValueError):                     # wrong outlier shape
        fsl.fused_sparse_linear(xb, sw.nm_values, sw.nm_meta,
                                sw.o_values[:, :, :8].contiguous(),
                                sw.o_meta, n=8, m=16, o_n=16)
    assert (nms.launches, fsl.launches) == counts


def test_int8_wrappers_raise_instead_of_falling_back(cuda):
    sw, g = _sparse(64, 256, "8:16", "16:256", 3, cuda, quantize=True)
    x = torch.randn((4, 256), generator=g, device=cuda).to(torch.bfloat16)
    counts = (nms.launches_int8, fsl.launches_int8)
    with pytest.raises(TypeError):                      # int8 without scale
        nms.nm_spmm(x, sw.nm_values, sw.nm_meta, n=8, m=16)
    with pytest.raises(TypeError):                      # bf16 with a scale
        nms.nm_spmm(x, sw.nm_values.to(torch.bfloat16), sw.nm_meta, n=8,
                    m=16, scale=sw.v_scale)
    with pytest.raises(TypeError):                      # f64 scale
        nms.nm_spmm(x, sw.nm_values, sw.nm_meta, n=8, m=16,
                    scale=sw.v_scale.double())
    with pytest.raises(ValueError):                     # scale [N/2]
        fsl.fused_sparse_linear(x, sw.nm_values, sw.nm_meta, sw.o_values,
                                sw.o_meta, n=8, m=16, o_n=16,
                                scale=sw.v_scale[:32].contiguous())
    with pytest.raises(ValueError):                     # scale on the CPU
        nms.nm_spmm(x, sw.nm_values, sw.nm_meta, n=8, m=16,
                    scale=sw.v_scale.cpu())
    flat = torch.zeros(sw.nm_values.numel() + 4, dtype=torch.int8,
                       device=cuda)
    with pytest.raises(ValueError):                     # not 8-byte aligned
        nms.nm_spmm(x, flat[4:].view(sw.nm_values.shape), sw.nm_meta, n=8,
                    m=16, scale=sw.v_scale)
    assert (nms.launches_int8, fsl.launches_int8) == counts


# ------------------------------ nm_spmm's decode (M <= T) and prefill paths
def _nm_counts():
    return (nms.launches, nms.launches_int8, nms.launches_decode,
            nms.launches_decode_int8, nms.launches_prefill,
            nms.launches_prefill_int8)


def _nm_args(sw, x):
    return ((x, sw.nm_values, sw.nm_meta),
            dict(n=sw.n, m=sw.m, scale=sw.v_scale))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("K", [256, 272, 768, 14336])
@pytest.mark.parametrize("N", [96, 200, 1024])
@pytest.mark.parametrize("M", [1, 3, T, T + 1, 37, 64, 65, 129, 512])
def test_nm_paths_match_plain(cuda, M, N, K, quantize):
    """At M <= T the decode body without outliers, above it the prefill
    body, at K on and off multiples of 256; one launch counted per call, on
    its path."""
    sw, g = _sparse(N, K, "8:16", None, M * 7 + N + K + 2, cuda,
                    quantize=quantize)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _nm_args(sw, x)
    p = fsl.plan(M, K, N, 8, 16, 0, _sm_count())
    assert p.path == ("decode" if M <= T else "prefill")
    before = _nm_counts()
    y = nms.nm_spmm(*args, **kw)
    decode = int(p.path == "decode")
    assert _nm_counts() == (
        before[0] + (not quantize), before[1] + quantize,
        before[2] + decode * (not quantize), before[3] + decode * quantize,
        before[4] + (1 - decode) * (not quantize),
        before[5] + (1 - decode) * quantize)
    torch.cuda.synchronize()
    assert y.shape == (M, N) and y.dtype == torch.bfloat16
    _close(y, nms.plain(*args, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("weight_pattern,K", [("4:8", 392), ("2:4", 392),
                                              ("4:8", 1024), ("2:4", 520),
                                              ("8:16", 400)])
@pytest.mark.parametrize("M", [1, 8, 37, 130])
def test_nm_paths_generic_instance(cuda, M, weight_pattern, K, quantize):
    """Shapes other than 8:16 take the generic instances (runtime n and m;
    16-column blocks that reach past K), as 8:16 at K % 64 != 0 does in the
    prefill body; never the plain version."""
    sw, g = _sparse(200, K, weight_pattern, None, M + K, cuda,
                    quantize=quantize)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _nm_args(sw, x)
    before = sum(_nm_counts()[2:])
    y = nms.nm_spmm(*args, **kw)
    assert sum(_nm_counts()[2:]) == before + 1
    torch.cuda.synchronize()
    _close(y, nms.plain(*args, **kw))


@pytest.mark.parametrize("M", [1, 8, 37, 130])
def test_nm_paths_unaligned_bf16_values(cuda, M):
    """bf16 values 2 bytes off a 16-byte boundary cannot be read 16 bytes
    at a time: the generic instances read them one by one."""
    sw, g = _sparse(200, 768, "8:16", None, 40 + M, cuda)
    flat = torch.zeros(sw.nm_values.numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    values = flat[1:].view(sw.nm_values.shape)
    values.copy_(sw.nm_values)
    assert values.data_ptr() % 16
    x = torch.randn((M, 768), generator=g, device=cuda).to(torch.bfloat16)
    y = nms.nm_spmm(x, values, sw.nm_meta, n=8, m=16)
    torch.cuda.synchronize()
    _close(y, nms.plain(x, values, sw.nm_meta, n=8, m=16))


@pytest.mark.parametrize("M", [1, 8, 37, 512])
def test_nm_paths_int8_zero_row(cuda, M):
    sw, g = _sparse(96, 784, "8:16", None, 41 + M, cuda, quantize=True)
    sw.nm_values[3] = 0
    sw.v_scale[3] = 1.0
    x = torch.randn((M, 784), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _nm_args(sw, x)
    y = nms.nm_spmm(*args, **kw)
    torch.cuda.synchronize()
    assert not y[:, 3].any()
    _close(y, nms.plain(*args, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("M,N,K", [(8, 4096, 14336), (1, 1024, 4096),
                                   (37, 4096, 14336), (37, 1024, 4096),
                                   (512, 4096, 4096), (T + 1, 200, 784)])
def test_nm_paths_are_deterministic(cuda, M, N, K, quantize):
    """Split-K partials are summed in split order by the last block: three
    calls give the same bits."""
    sw, g = _sparse(N, K, "8:16", None, 42, cuda, quantize=quantize)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _nm_args(sw, x)
    ys = [nms.nm_spmm(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[1], ys[2])
    _close(ys[0], nms.plain(*args, **kw))


def test_nm_paths_never_reach_plain_or_the_tile(cuda, monkeypatch):
    """On a CUDA tensor ``nm_spmm`` launches its decode or prefill kernel;
    neither the plain version nor the old tile kernel is called."""
    from repro_torch.kernels import build
    cases = []
    for quantize in (False, True):
        sw, g = _sparse(200, 784, "8:16", None, 43, cuda, quantize=quantize)
        for M in (1, T, T + 1, 37, 130):
            x = torch.randn((M, 784), generator=g, device=cuda).to(
                torch.bfloat16)
            args, kw = _nm_args(sw, x)
            cases.append((args, kw, nms.plain(*args, **kw)))

    def refuse(*a, **k):
        raise AssertionError("the plain version or the tile kernel was "
                             "called on CUDA tensors")
    monkeypatch.setattr(nms, "plain", refuse)
    monkeypatch.setattr(nms, "nm_spmm_ref", refuse)
    lib = build.library()
    for name in ("nm_spmm_bf16", "nm_spmm_int8"):
        monkeypatch.setattr(lib, name, refuse)
    before = sum(_nm_counts()[2:])
    for args, kw, want in cases:
        y = nms.nm_spmm(*args, **kw)
        torch.cuda.synchronize()
        _close(y, want)
    assert sum(_nm_counts()[2:]) == before + 10


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_nm_tile_kernel_still_forced(cuda, quantize):
    """The old tile kernel (OUTLIERS=false) stays callable through
    ``force_plan``, counted on neither path, and agrees with plain."""
    sw, g = _sparse(200, 768, "8:16", None, 44, cuda, quantize=quantize)
    x = torch.randn((37, 768), generator=g, device=cuda).to(torch.bfloat16)
    args, kw = _nm_args(sw, x)
    before = _nm_counts()
    y = nms.nm_spmm(*args, force_plan=fsl.tile_plan(37, 768, 200), **kw)
    after = _nm_counts()
    assert after[:2] == (before[0] + (not quantize), before[1] + quantize)
    assert after[2:] == before[2:]
    torch.cuda.synchronize()
    _close(y, nms.plain(*args, **kw))


def test_nm_raises_on_misaligned_x(cuda):
    sw, g = _sparse(64, 256, "8:16", None, 45, cuda)
    flat = torch.zeros(4 * 256 + 1, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(4, 256)
    x.copy_(torch.randn((4, 256), generator=g, device=cuda))
    before = _nm_counts()
    with pytest.raises(ValueError):
        nms.nm_spmm(x, sw.nm_values, sw.nm_meta, n=8, m=16)
    assert _nm_counts() == before


# ------------------------------------------------------------ paged attention
def _paged_case(B, S, H, KV, hd, bs, cursors, seed, device):
    """bf16 q and arenas with shuffled, non-contiguous block tables padded
    with a trash block (id 0): each lane owns the blocks covering
    cursor + S positions, in a random order of the arena."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    need = [-(-(c + S) // bs) for c in cursors]
    nb = max(need) + 2                                 # trash-padded width
    n_blocks = 1 + sum(need) + 3
    perm = (torch.randperm(n_blocks - 1, generator=g) + 1).tolist()
    tables = torch.zeros((B, nb), dtype=torch.int32)
    for b, n in enumerate(need):
        tables[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    q = torch.randn((B, S, H, hd), generator=g).to(torch.bfloat16)
    k = torch.randn((n_blocks, bs, KV, hd), generator=g).to(torch.bfloat16)
    v = torch.randn((n_blocks, bs, KV, hd), generator=g).to(torch.bfloat16)
    cur = torch.tensor(cursors, dtype=torch.int32)
    return [t.to(device) for t in (q, k, v, tables, cur)]


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (16, 2)])
@pytest.mark.parametrize("S,bs,cursors", [
    (1, 16, [0, 15, 16, 77]), (3, 8, [5, 0, 40]), (37, 16, [9, 130]),
    (70, 24, [0, 17]), (129, 32, [200])])
def test_paged_attention_matches_plain(cuda, S, bs, cursors, H, KV, hd,
                                       window):
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(len(cursors), S, H, KV, hd, bs,
                                       cursors, S * 7 + H, cuda)
    before = pa.launches
    out = pa.paged_attention(q, k, v, tables, cur, window=window)
    assert pa.launches == before + 1
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    _close(out, pa.plain(q, k, v, tables, cur, window=window))


def _quantized(k, v):
    from repro_torch.serving.cache_pool import quantize_kv
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    return k8, v8, ks, vs


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV", [(4, 4), (16, 2)])
@pytest.mark.parametrize("S,bs,cursors", [
    (1, 16, [0, 15, 16, 77]), (3, 8, [5, 0, 40]), (37, 16, [9, 130]),
    (129, 32, [200])])
def test_paged_attention_int8_matches_plain(cuda, S, bs, cursors, H, KV, hd,
                                            window):
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(len(cursors), S, H, KV, hd, bs,
                                       cursors, S * 7 + H, cuda)
    k8, v8, ks, vs = _quantized(k, v)
    before = (pa.launches, pa.launches_int8)
    out = pa.paged_attention(q, k8, v8, tables, cur, window=window,
                             k_scale=ks, v_scale=vs)
    assert (pa.launches, pa.launches_int8) == (before[0], before[1] + 1)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    _close(out, pa.plain(q, k8, v8, tables, cur, window=window, k_scale=ks,
                         v_scale=vs))


def test_paged_attention_int8_unwritten_blocks_finite(cuda):
    """A padding lane reads the trash block as the arena holds it before any
    write (zeros, scale 1) and returns finite values."""
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(2, 8, 8, 2, 128, 16, [20, 0], 3, cuda)
    k8, v8, ks, vs = _quantized(k, v)
    k8[0], v8[0], ks[0], vs[0] = 0, 0, 1.0, 1.0
    tables[1] = 0
    out = pa.paged_attention(q, k8, v8, tables, cur, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _close(out, pa.plain(q, k8, v8, tables, cur, k_scale=ks, v_scale=vs))


def test_paged_attention_int8_raises_on_unsupported(cuda):
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(2, 4, 8, 2, 128, 16, [3, 9], 4, cuda)
    k8, v8, ks, vs = _quantized(k, v)
    before = (pa.launches, pa.launches_int8)
    with pytest.raises(ValueError):                     # int8 without scales
        pa.paged_attention(q, k8, v8, tables, cur)
    with pytest.raises(ValueError):                     # bf16 with scales
        pa.paged_attention(q, k, v, tables, cur, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError):                     # one scale only
        pa.paged_attention(q, k8, v8, tables, cur, k_scale=ks)
    with pytest.raises(ValueError):                     # bf16 scales
        pa.paged_attention(q, k8, v8, tables, cur,
                           k_scale=ks.to(torch.bfloat16),
                           v_scale=vs.to(torch.bfloat16))
    with pytest.raises(ValueError):                     # scales [.., KV/2]
        pa.paged_attention(q, k8, v8, tables, cur,
                           k_scale=ks[..., :1].contiguous(),
                           v_scale=vs[..., :1].contiguous())
    with pytest.raises(ValueError):                     # scales not contiguous
        pa.paged_attention(q, k8, v8, tables, cur,
                           k_scale=ks.transpose(0, 1).contiguous()
                           .transpose(0, 1), v_scale=vs)
    assert (pa.launches, pa.launches_int8) == before


def test_paged_attention_padding_lanes_finite(cuda):
    """A padding lane (cursor 0, all-trash table) reads only the trash block
    and returns finite values."""
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(2, 8, 8, 2, 128, 16, [20, 0], 3, cuda)
    tables[1] = 0
    out = pa.paged_attention(q, k, v, tables, cur)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _close(out, pa.plain(q, k, v, tables, cur))


def test_paged_attention_raises_on_unsupported(cuda):
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(2, 4, 8, 2, 128, 16, [3, 9], 4, cuda)
    before = pa.launches
    with pytest.raises(TypeError):                      # f32 q
        pa.paged_attention(q.float(), k, v, tables, cur)
    q96 = torch.zeros((2, 4, 8, 96), dtype=torch.bfloat16, device=cuda)
    k96 = torch.zeros((k.shape[0], 16, 2, 96), dtype=torch.bfloat16,
                      device=cuda)
    with pytest.raises(ValueError):                     # hd 96
        pa.paged_attention(q96, k96, k96, tables, cur)
    k12 = torch.zeros((k.shape[0], 12, 2, 128), dtype=torch.bfloat16,
                      device=cuda)
    with pytest.raises(ValueError):                     # bs 12
        pa.paged_attention(q, k12, k12, tables, cur)
    with pytest.raises(ValueError):                     # int64 tables
        pa.paged_attention(q, k, v, tables.long(), cur)
    with pytest.raises(ValueError):                     # tables on the CPU
        pa.paged_attention(q, k, v, tables.cpu(), cur)
    with pytest.raises(ValueError):                     # not contiguous
        pa.paged_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, tables, cur)
    q3 = torch.zeros((2, 4, 6, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                     # H % KV != 0 (KV 4)
        pa.paged_attention(q3, k.repeat(1, 1, 2, 1), v.repeat(1, 1, 2, 1),
                           tables, cur)
    assert pa.launches == before


def _paged_counts(pa):
    return (pa.launches, pa.launches_decode, pa.launches_prefill,
            pa.launches_int8, pa.launches_decode_int8,
            pa.launches_prefill_int8)


def _prefill_plan(pa, q, k, tables, bm):
    B, S, H, _ = q.shape
    p = pa.plan(B, S, H, k.shape[2], k.shape[3], k.shape[1], _sm_count(),
                nb=tables.shape[1], decode_max_rows=0)
    return p if bm == "plan" else dataclasses.replace(p, rows=bm)


@pytest.mark.parametrize("bm", ["plan", 64, 128])
@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (16, 2)])
@pytest.mark.parametrize("S,bs,cursors", [
    (5, 8, [5, 0, 40]), (37, 16, [9, 130]), (70, 24, [0, 17]),
    (129, 32, [200]), (512, 16, [256, 3])])
def test_paged_attention_prefill_matches_plain(cuda, S, bs, cursors, H, KV,
                                               hd, window, quantize, bm):
    """The prefill-chunk body, forced at every S, against the plain
    version: one bf16 ulp of the largest output (P rounded to bf16 adds at
    most 2**-8 of the mean |v| the row sees)."""
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(len(cursors), S, H, KV, hd, bs,
                                       cursors, S * 7 + H, cuda)
    kw = dict(window=window)
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        kw.update(k_scale=ks, v_scale=vs)
    p = _prefill_plan(pa, q, k, tables, bm)
    before = _paged_counts(pa)
    out = pa.paged_attention(q, k, v, tables, cur, force_plan=p, **kw)
    want = [0] * 6
    want[5 if quantize else 2] = want[3 if quantize else 0] = 1
    assert [a - b for a, b in zip(_paged_counts(pa), before)] == want
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    _close(out, pa.plain(q, k, v, tables, cur, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("S,cursors,window", [(512, [256], None),
                                              (64, [0, 64, 300, 700], None),
                                              (64, [0, 64, 300, 700], 128)])
def test_paged_attention_prefill_is_deterministic(cuda, S, cursors, window,
                                                  quantize):
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(len(cursors), S, 32, 8, 128, 16,
                                       cursors, 5, cuda)
    kw = dict(window=window)
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        kw.update(k_scale=ks, v_scale=vs)
    assert pa.plan(len(cursors), S, 32, 8, 128, 16, _sm_count(),
                   nb=tables.shape[1]).path == "prefill"
    a = pa.paged_attention(q, k, v, tables, cur, **kw)
    b = pa.paged_attention(q, k, v, tables, cur, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a, pa.plain(q, k, v, tables, cur, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 24])
def test_paged_attention_prefill_never_reads_past_the_visible_end(
        cuda, window, quantize):
    """NaN in every arena position no query can see (the rest of the last
    visible block, blocks past it, the trash block and unreferenced blocks)
    and table entries outside the arena past the visible end: the
    prefill-chunk body reads none of them (zero-filled rows), so its output
    is finite and equals the plain version's on the clean arena."""
    from repro_torch.serving.paged import paged_attention as pa
    cursors, S, bs = [9, 130, 0], 40, 16
    q, k, v, tables, cur = _paged_case(len(cursors), S, 8, 2, 128, bs,
                                       cursors, 11, cuda)
    kw = dict(window=window)
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        kw.update(k_scale=ks, v_scale=vs)
    ref = pa.plain(q, k, v, tables, cur, **kw)
    seen = torch.zeros(k.shape[:2], dtype=torch.bool, device=cuda)
    for b, c in enumerate(cursors):
        for j in range(c + S):
            seen[tables[b, j // bs], j % bs] = True
    dirty = [t.clone() for t in ((k, v, ks, vs) if quantize else (k, v))]
    for t in dirty:
        t[~seen] = 127 if t.dtype == torch.int8 else float("nan")
    if quantize:
        kw.update(k_scale=dirty[2], v_scale=dirty[3])
    wild = tables.clone()
    for b, c in enumerate(cursors):
        wild[b, -(-(c + S) // bs):] = torch.tensor(
            [k.shape[0] + 5, -3], dtype=torch.int32, device=cuda).repeat(
                wild.shape[1])[:wild.shape[1] - -(-(c + S) // bs)]
    p = _prefill_plan(pa, q, k, tables, "plan")
    out = pa.paged_attention(q, dirty[0], dirty[1], wild, cur, force_plan=p,
                             **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _close(out, ref)


def test_paged_attention_never_reaches_plain(cuda, monkeypatch):
    """On a CUDA tensor both bodies launch; the plain version is never
    called, whichever body the plan picks."""
    from repro_torch.serving.paged import paged_attention as pa

    def boom(*a, **k):
        raise AssertionError("plain reached on CUDA")
    for S, path in ((1, "decode"), (64, "prefill")):
        q, k, v, tables, cur = _paged_case(2, S, 32, 8, 128, 16, [20, 300],
                                           2, cuda)
        k8, v8, ks, vs = _quantized(k, v)
        want = pa.plan(2, S, 32, 8, 128, 16, _sm_count(),
                       nb=tables.shape[1])
        assert want.path == path
        ref = pa.plain(q, k, v, tables, cur)
        ref8 = pa.plain(q, k8, v8, tables, cur, k_scale=ks, v_scale=vs)
        monkeypatch.setattr(pa, "plain", boom)
        before = _paged_counts(pa)
        out = pa.paged_attention(q, k, v, tables, cur)
        out8 = pa.paged_attention(q, k8, v8, tables, cur, k_scale=ks,
                                  v_scale=vs)
        monkeypatch.undo()
        delta = [a - b for a, b in zip(_paged_counts(pa), before)]
        d, p_ = int(path == "decode"), int(path == "prefill")
        assert delta == [1, d, p_, 1, d, p_]
        torch.cuda.synchronize()
        _close(out, ref)
        _close(out8, ref8)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_paged_attention_decode_body_still_forced(cuda, quantize):
    """A chunk the plan sends to the prefill-chunk body still runs on the
    decode body when that is forced (as the sweep and the timings do)."""
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(4, 64, 32, 8, 128, 16,
                                       [0, 64, 300, 700], 6, cuda)
    kw = {}
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        kw = dict(k_scale=ks, v_scale=vs)
    p = pa.plan(4, 64, 32, 8, 128, 16, _sm_count(), nb=tables.shape[1])
    assert p.path == "prefill"
    forced = pa.plan(4, 64, 32, 8, 128, 16, _sm_count(), nb=tables.shape[1],
                     decode_max_rows=256)
    before = _paged_counts(pa)
    out = pa.paged_attention(q, k, v, tables, cur, force_plan=forced, **kw)
    delta = [a - b for a, b in zip(_paged_counts(pa), before)]
    assert delta == ([0, 0, 0, 1, 1, 0] if quantize else [1, 1, 0, 0, 0, 0])
    torch.cuda.synchronize()
    _close_rows(out, pa.plain(q, k, v, tables, cur, **kw))


def test_paged_attention_prefill_raises_on_unsupported(cuda):
    """Plans no body takes, and operands the bodies refuse, raise before
    any launch."""
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(2, 40, 8, 2, 128, 16, [3, 9], 4, cuda)
    p = pa.plan(2, 40, 8, 2, 128, 16, _sm_count(), nb=tables.shape[1])
    assert p.path == "prefill"
    before = _paged_counts(pa)
    for bad in (dataclasses.replace(p, rows=96),
                dataclasses.replace(p, rows=0),
                dataclasses.replace(p, path="tile")):
        with pytest.raises(ValueError):
            pa.paged_attention(q, k, v, tables, cur, force_plan=bad)
    k12 = torch.zeros((k.shape[0], 12, 2, 128), dtype=torch.bfloat16,
                      device=cuda)
    with pytest.raises(ValueError):                     # bs 12
        pa.paged_attention(q, k12, k12, tables, cur, force_plan=p)
    with pytest.raises(TypeError):                      # f32 q
        pa.paged_attention(q.float(), k, v, tables, cur, force_plan=p)
    k8, v8, ks, vs = _quantized(k, v)
    with pytest.raises(ValueError):                     # int8 without scales
        pa.paged_attention(q, k8, v8, tables, cur, force_plan=p)
    assert _paged_counts(pa) == before


# ------------------------------- paged attention's decode body (rows <= T)
def _decode_plan(pa, q, k, tables):
    B, S, H, _ = q.shape
    return pa.plan(B, S, H, k.shape[2], k.shape[3], k.shape[1], _sm_count(),
                   nb=tables.shape[1], decode_max_rows=S * H // k.shape[2])


def _tile_counts(pa):
    return (pa.launches_tile, pa.launches_tile_int8)


# the decode case of chip_smoke.py's phase 2b, and lanes at 0, on and off
# 16-key block and 128-key span edges
DECODE_CURSORS = [[63, 200, 500, 700, 767, 1000, 15, 16], [0, 127, 128, 301]]


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 24])
def test_paged_decode_matches_plain(cuda, bs, hd, n_rep, window, S,
                                    quantize):
    """The decode body, forced at S = 1 and 2, against the plain version:
    one bf16 ulp of each row's largest output (P stays in f32)."""
    from repro_torch.serving.paged import paged_attention as pa
    cursors = DECODE_CURSORS[1]
    q, k, v, tables, cur = _paged_case(len(cursors), S, 2 * n_rep, 2, hd, bs,
                                       cursors, bs + hd + n_rep + S, cuda)
    kw = dict(window=window)
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        kw.update(k_scale=ks, v_scale=vs)
    p = _decode_plan(pa, q, k, tables)
    assert p.path == "decode" and p.splits > 1
    before = _paged_counts(pa)
    out = pa.paged_attention(q, k, v, tables, cur, force_plan=p, **kw)
    want = [0] * 6
    want[4 if quantize else 1] = want[3 if quantize else 0] = 1
    assert [a - b for a, b in zip(_paged_counts(pa), before)] == want
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    _close_rows(out, pa.plain(q, k, v, tables, cur, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 128])
def test_paged_decode_llama3_case_matches_plain(cuda, window, quantize):
    """chip_smoke.py's decode case (8 lanes, cursors 15..1000, H 32, KV 8,
    hd 128, bs 16) as ``plan`` sends it: the decode body."""
    from repro_torch.serving.paged import paged_attention as pa
    cursors = DECODE_CURSORS[0]
    q, k, v, tables, cur = _paged_case(8, 1, 32, 8, 128, 16, cursors, 21,
                                       cuda)
    kw = dict(window=window)
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        kw.update(k_scale=ks, v_scale=vs)
    assert pa.plan(8, 1, 32, 8, 128, 16, _sm_count(),
                   nb=tables.shape[1]).path == "decode"
    before = (pa.launches_decode, pa.launches_decode_int8)
    out = pa.paged_attention(q, k, v, tables, cur, **kw)
    assert (pa.launches_decode, pa.launches_decode_int8) == (
        before[0] + (not quantize), before[1] + quantize)
    torch.cuda.synchronize()
    _close_rows(out, pa.plain(q, k, v, tables, cur, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_paged_decode_is_deterministic(cuda, quantize):
    """The split-KV partials are merged in split order by the last block:
    two calls give the same bits, also after calls of other plans (another
    decode shape, a split-K weight kernel) have used the shared workspace
    and counters."""
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(8, 1, 32, 8, 128, 16,
                                       DECODE_CURSORS[0], 22, cuda)
    q2, k2, v2, tables2, cur2 = _paged_case(4, 2, 16, 2, 64, 8,
                                            DECODE_CURSORS[1], 23, cuda)
    kw, kw2 = {}, {}
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        k2, v2, ks2, vs2 = _quantized(k2, v2)
        kw, kw2 = dict(k_scale=ks, v_scale=vs), dict(k_scale=ks2, v_scale=vs2)
    p2 = _decode_plan(pa, q2, k2, tables2)
    a = pa.paged_attention(q, k, v, tables, cur, **kw)
    pa.paged_attention(q2, k2, v2, tables2, cur2, force_plan=p2, **kw2)
    sw, g = _sparse(1024, 4096, "8:16", "16:256", 24, cuda)
    x = torch.randn((1, 4096), generator=g, device=cuda).to(torch.bfloat16)
    args, kw_w = _fused_args(sw, x)
    fsl.fused_sparse_linear(*args, **kw_w)
    b = pa.paged_attention(q, k, v, tables, cur, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close_rows(a, pa.plain(q, k, v, tables, cur, **kw))


@pytest.mark.parametrize("window", [None, 24])
def test_paged_decode_int8_unwritten_blocks_finite(cuda, window):
    """A padding lane (cursor 0, all-trash table) on an int8 arena whose
    trash block is as it was allocated (zeros, scale 1), and NaN scales
    and 127s everywhere no query can see: finite, equal to the plain
    version on the clean arena."""
    from repro_torch.serving.paged import paged_attention as pa
    cursors, bs = [130, 0, 17], 16
    q, k, v, tables, cur = _paged_case(3, 1, 8, 2, 128, bs, cursors, 25,
                                       cuda)
    k8, v8, ks, vs = _quantized(k, v)
    k8[0], v8[0], ks[0], vs[0] = 0, 0, 1.0, 1.0
    tables[1] = 0
    kw = dict(window=window)
    ref = pa.plain(q, k8, v8, tables, cur, k_scale=ks, v_scale=vs, **kw)
    seen = torch.zeros(k.shape[:2], dtype=torch.bool, device=cuda)
    for b, c in enumerate(cursors):
        for j in range(c + 1):
            seen[tables[b, j // bs], j % bs] = True
    dirty = [t.clone() for t in (k8, v8, ks, vs)]
    for t in dirty:
        t[~seen] = 127 if t.dtype == torch.int8 else float("nan")
    p = _decode_plan(pa, q, k8, tables)
    out = pa.paged_attention(q, dirty[0], dirty[1], tables, cur,
                             k_scale=dirty[2], v_scale=dirty[3], force_plan=p,
                             **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _close_rows(out, ref)


def test_paged_decode_never_reaches_plain_or_the_old_kernel(cuda,
                                                            monkeypatch):
    """A decode call on the card launches the decode body: neither the
    plain version nor the old kernel's entry points are called."""
    from repro_torch.kernels import build
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(8, 1, 32, 8, 128, 16,
                                       DECODE_CURSORS[0], 26, cuda)
    k8, v8, ks, vs = _quantized(k, v)
    ref = pa.plain(q, k, v, tables, cur)
    ref8 = pa.plain(q, k8, v8, tables, cur, k_scale=ks, v_scale=vs)
    lib = build.library()

    def refuse(*a, **kw):
        raise AssertionError("plain or the old kernel reached on CUDA")
    monkeypatch.setattr(pa, "plain", refuse)
    monkeypatch.setattr(lib, "paged_attention_bf16", refuse)
    monkeypatch.setattr(lib, "paged_attention_int8", refuse)
    before = _paged_counts(pa) + _tile_counts(pa)
    out = pa.paged_attention(q, k, v, tables, cur)
    out8 = pa.paged_attention(q, k8, v8, tables, cur, k_scale=ks, v_scale=vs)
    monkeypatch.undo()
    delta = [a - b for a, b in zip(_paged_counts(pa) + _tile_counts(pa),
                                   before)]
    assert delta == [1, 1, 0, 1, 1, 0, 0, 0]
    torch.cuda.synchronize()
    _close_rows(out, ref)
    _close_rows(out8, ref8)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("S", [1, 64])
def test_paged_attention_old_kernel_still_forced(cuda, S, quantize):
    """``Plan("tile")`` runs the old kernel (csrc/paged_attention.cu), as
    chip_smoke.py times it: counted in ``launches_tile*`` and the total,
    in neither path's counter."""
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(4, S, 32, 8, 128, 16,
                                       [0, 64, 300, 700], 27, cuda)
    kw = {}
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        kw = dict(k_scale=ks, v_scale=vs)
    before = _paged_counts(pa) + _tile_counts(pa)
    out = pa.paged_attention(q, k, v, tables, cur, force_plan=pa.Plan("tile"),
                             **kw)
    delta = [a - b for a, b in zip(_paged_counts(pa) + _tile_counts(pa),
                                   before)]
    assert delta == ([0, 0, 0, 1, 0, 0, 0, 1] if quantize
                     else [1, 0, 0, 0, 0, 0, 1, 0])
    torch.cuda.synchronize()
    _close(out, pa.plain(q, k, v, tables, cur, **kw))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_paged_decode_replays_in_a_cuda_graph(cuda, quantize):
    """One decode call captured in a CUDA graph after a warm-up call: the
    plan and grid come from the shapes, the cursors are read on the card,
    so a replay on new cursor values written into the same tensors equals
    an uncaptured call on them."""
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(8, 1, 32, 8, 128, 16,
                                       DECODE_CURSORS[0], 28, cuda)
    kw = {}
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        kw = dict(k_scale=ks, v_scale=vs)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pa.paged_attention(q, k, v, tables, cur, **kw)      # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention(q, k, v, tables, cur, **kw)
    for cursors in ([700, 15, 16, 63, 1000, 500, 767, 200],
                    [0, 1, 127, 128, 129, 255, 256, 1000]):
        cur.copy_(torch.tensor(cursors, dtype=torch.int32))
        graph.replay()
        want = pa.paged_attention(q, k, v, tables, cur, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        _close_rows(out, pa.plain(q, k, v, tables, cur, **kw))


# ------------------------------------------------ the captured decode step

GRAPH_LAYOUTS = [("slot", "bf16"), ("paged", "bf16"), ("slot", "int8"),
                 ("paged", "int8")]


def _graph_params(cuda, seed, int8):
    """The smoke model, bf16, 8:16+16:256 weights (int8 values with
    ``int8``), drawn from ``seed``."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    cfg = dataclasses.replace(get_smoke("llama-paper"), dtype=torch.bfloat16)
    args = serve.parse_args(["--arch", "llama-paper", "--smoke-arch",
                             "--sparse"])
    params, _ = serve.build_params(
        cfg, args, cuda, torch.Generator(device=cuda).manual_seed(seed),
        quantize=int8)
    return cfg, params


def _graph_engine(cfg, params, kv_layout, kv_dtype):
    from repro_torch.serving import ServingEngine
    return ServingEngine(cfg, params, device="cuda", n_slots=4, max_len=96,
                         kv_layout=kv_layout, block_size=16,
                         token_budget=32, kv_dtype=kv_dtype)


def _all_decoding(engine, g, n=3):
    """Submit ``n`` requests (one lane stays free) and step until every
    one decodes; returns the decode call's tokens and active lanes, the
    paged rows' next positions made writable."""
    from repro_torch.serving import SamplingParams, Status
    reqs = [engine.submit(torch.randint(0, engine.cfg.vocab, (20 + 7 * i,),
                                        generator=g, device="cuda").tolist(),
                          SamplingParams(max_new_tokens=40))
            for i in range(n)]
    while not all(r.status is Status.RUNNING for r in reqs):
        engine.step()
    active = engine._decode_rows()
    if engine.kv_layout == "paged":
        engine.pool.prepare_decode(active)
    return engine._last_token[:, None].copy(), active


def _decode_call(adapter, tokens, active):
    """One decode call: its logits (copied) and the launch counters' moves."""
    from repro_torch.kernels.common import launch_counts
    before = launch_counts()
    out = adapter.step_decode(tokens, active)[:, 0].clone()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {k: n - before[k] for k, n in after.items()
                 if n != before[k]}


@pytest.mark.parametrize("kv_layout,kv_dtype", GRAPH_LAYOUTS)
def test_engine_decode_replays_equal_eager(cuda, kv_layout, kv_dtype):
    """On an engine whose lanes decode (one lane free): the decode call
    under ``eager()``, then graphed (its key's capture, or a replay if
    the engine's steps captured it already), then replayed, on the same
    inputs (the cursors do not move): the active lanes' logits are the
    same bits, and every call moves the launch counters by the same
    counts, the weight kernel's 7 x layers and (paged) paged attention's
    layers on their decode bodies."""
    from repro_torch.serving.families import eager
    cfg, params = _graph_params(cuda, 0, kv_dtype == "int8")
    engine = _graph_engine(cfg, params, kv_layout, kv_dtype)
    ad = engine.adapter
    assert ad.graphed
    tokens, active = _all_decoding(engine,
                                   torch.Generator(device=cuda).manual_seed(1))
    with eager():
        want, launched = _decode_call(ad, tokens, active)
    calls = [_decode_call(ad, tokens, active) for _ in range(2)]
    for got, moved in calls:
        assert torch.equal(got[active], want[active])
        assert moved == launched
    st = ad.captured_decode.stats()
    assert st["captures"] == 1 and st["replays"] >= 1
    int8 = "_int8" if kv_dtype == "int8" else ""
    weights = sum(launched.get((f"repro_torch.kernels.{m}",
                                "launches_decode" + int8), 0)
                  for m in ("fused_sparse_linear", "nm_spmm"))
    assert weights == 7 * cfg.n_layers
    pa = "repro_torch.serving.paged.paged_attention"
    want_pa = cfg.n_layers if kv_layout == "paged" else None
    assert launched.get((pa, "launches_decode" + int8)) == want_pa
    assert st["launches_per_replay"] == [weights + (want_pa or 0)]
    engine.run()


@pytest.mark.parametrize("kv_layout", ["slot", "paged"])
def test_eager_chunk_regrowing_scratch_keeps_the_graph(cuda, kv_layout):
    """A prefill chunk run eagerly between two replays on free lanes (its
    split plans need more workspace than any call before: the shared
    workspace is replaced), then allocations that would reuse freed
    memory: the next replay's active logits are the first's bits, and the
    graph still holds the workspace its kernels were captured with."""
    from repro_torch.kernels import common
    # the workspace is per process: start from none, so that this engine's
    # own calls size it (the graphs of earlier tests hold theirs)
    common._scratch.clear()
    cfg, params = _graph_params(cuda, 0, False)
    engine = _graph_engine(cfg, params, kv_layout, "bf16")
    ad = engine.adapter
    tokens, active = _all_decoding(engine,
                                   torch.Generator(device=cuda).manual_seed(2))
    _decode_call(ad, tokens, active)                  # captured by now
    first, _ = _decode_call(ad, tokens, active)
    graph = next(iter(ad.captured_decode.graphs.values()))
    held = {ws.data_ptr() for ws, _ in graph.scratch}
    sizes = {n for ws, cnt in graph.scratch for n in (ws.numel(),
                                                      cnt.numel())}
    # two lanes of 96 rows: M = 192, above every chunk of the 32-token
    # budget (at most 4 lanes x 32), so the split plans' workspace grows
    S = 96
    if kv_layout == "paged":                 # all-trash lanes: no write
        lanes = engine.pool.lane_tables([], 2)
    else:                    # a free slot, and a padding lane past them
        free = [s for s in range(4) if s not in active]
        lanes = engine.pool.lane_rows(free[:1], 2)
    chunk = np.random.default_rng(3).integers(0, cfg.vocab, (2, S))
    ad.step_chunk(lanes, np.zeros(2, np.int64), np.full(2, S), chunk)
    ws, cnt = common._scratch[torch.cuda.current_device()]
    assert ws.data_ptr() not in held
    junk = [torch.full((n,), -1, dtype=torch.int32, device=cuda)
            for n in sizes for _ in range(4)]
    again, _ = _decode_call(ad, tokens, active)
    assert torch.equal(again[active], first[active])
    del junk
    engine.run()


def test_new_params_or_arenas_capture_anew(cuda):
    """Other params under the same adapter capture a graph of their own,
    whose logits are the eager call's on those params; the first params
    replay their own graph again.  Arenas replaced by copies capture
    again, and the replaced arena is never written by the new replays."""
    from repro_torch.serving.families import eager
    cfg, params = _graph_params(cuda, 0, False)
    _, other = _graph_params(cuda, 5, False)
    engine = _graph_engine(cfg, params, "slot", "bf16")
    ad = engine.adapter
    tokens, active = _all_decoding(engine,
                                   torch.Generator(device=cuda).manual_seed(3))
    first, _ = _decode_call(ad, tokens, active)
    n = len(ad.captured_decode.graphs)
    ad.params = other
    with eager():
        want, _ = _decode_call(ad, tokens, active)
    for _ in range(2):                       # the capture, then a replay
        got, _ = _decode_call(ad, tokens, active)
        assert torch.equal(got[active], want[active])
    assert len(ad.captured_decode.graphs) == n + 1
    assert not torch.equal(got[active], first[active])
    ad.params = params
    back, _ = _decode_call(ad, tokens, active)
    assert len(ad.captured_decode.graphs) == n + 1
    assert torch.equal(back[active], first[active])
    pool = engine.pool
    old_k = pool.k
    snapshot = old_k.clone()
    pool.k, pool.v = pool.k.clone(), pool.v.clone()
    tokens2 = (tokens + 1) % cfg.vocab
    with eager():
        want, _ = _decode_call(ad, tokens2, active)
    for _ in range(2):
        got, _ = _decode_call(ad, tokens2, active)
        assert torch.equal(got[active], want[active])
    assert len(ad.captured_decode.graphs) == n + 2
    assert torch.equal(old_k, snapshot)


@pytest.mark.parametrize("kv_layout,kv_dtype", GRAPH_LAYOUTS)
def test_serve_captures_once_and_streams_equal_eager(cuda, kv_layout,
                                                     kv_dtype):
    """The same traffic served eagerly (``eager()``) and replayed, on two
    engines over the same params: identical streams; the replayed serve
    captures one graph over 64 and more decode calls, replays every other,
    and moves every launch counter as the eager serve does."""
    from repro_torch.kernels.common import launch_counts
    from repro_torch.serving import SamplingParams, Status
    from repro_torch.serving.families import eager
    cfg, params = _graph_params(cuda, 0, kv_dtype == "int8")
    g = torch.Generator(device=cuda).manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (8 + 6 * i,), generator=g,
                             device=cuda).tolist() for i in range(4)]
    runs = []
    for graphed in (False, True):
        engine = _graph_engine(cfg, params, kv_layout, kv_dtype)
        decodes = [0]
        step_decode = engine.adapter.step_decode

        def counted(*a, _fn=step_decode, _n=decodes):
            _n[0] += 1
            return _fn(*a)
        engine.adapter.step_decode = counted
        before = launch_counts()
        reqs = [engine.submit(p, SamplingParams(max_new_tokens=70))
                for p in prompts]
        if graphed:
            engine.run()
        else:
            with eager():
                engine.run()
        after = launch_counts()
        assert all(r.status is Status.FINISHED and len(r.tokens) == 70
                   for r in reqs)
        runs.append(([r.tokens for r in reqs], decodes[0],
                     {k: n - before[k] for k, n in after.items()},
                     engine.adapter.captured_decode.stats()))
    (eager_streams, eager_calls, eager_moved, eager_st), \
        (streams, calls, moved, st) = runs
    assert streams == eager_streams
    assert calls == eager_calls >= 64
    assert moved == eager_moved
    assert eager_st["captures"] == 0 and st["captures"] == 1
    assert st["replays"] == calls - 1


# the moe and enc-dec families' captured decode: (arch, layout)
FAMILY_GRAPHS = [("mixtral-8x7b", "slot"), ("mixtral-8x7b", "paged"),
                 ("llama4-maverick-400b-a17b", "paged"),
                 ("whisper-medium", "slot")]


def _family_params(cuda, arch, seed):
    """A smoke twin in bf16, 8:16+16:256 weights (the routed experts stay
    dense), drawn from ``seed``."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.bfloat16)
    args = serve.parse_args(["--arch", arch, "--smoke-arch", "--sparse"])
    params, _ = serve.build_params(
        cfg, args, cuda, torch.Generator(device=cuda).manual_seed(seed))
    return cfg, params


def _family_engine(cfg, params, kv_layout):
    from repro_torch.serving import ServingEngine
    kw = (dict(max_ctx=24) if cfg.family == "encdec"
          else dict(kv_layout=kv_layout, block_size=16))
    return ServingEngine(cfg, params, device="cuda", n_slots=4, max_len=96,
                         token_budget=32, **kw)


def _family_kw(cfg, g):
    """An enc-dec request's encoder frames (1..24 of them), else none."""
    if cfg.family != "encdec":
        return {}
    n = int(torch.randint(1, 25, (1,), generator=g, device=g.device))
    return {"embeds": torch.randn((n, cfg.d_model), generator=g,
                                  device=g.device)}


def _family_decoding(engine, g, n=3):
    """``_all_decoding`` for any family: ``n`` requests (one lane stays
    free), enc-dec ones with their frames."""
    from repro_torch.serving import SamplingParams, Status
    reqs = [engine.submit(torch.randint(0, engine.cfg.vocab, (20 + 7 * i,),
                                        generator=g, device="cuda").tolist(),
                          SamplingParams(max_new_tokens=40),
                          **_family_kw(engine.cfg, g))
            for i in range(n)]
    while not all(r.status is Status.RUNNING for r in reqs):
        engine.step()
    active = engine._decode_rows()
    if engine.kv_layout == "paged":
        engine.pool.prepare_decode(active)
    return engine._last_token[:, None].copy(), active


@pytest.mark.parametrize("arch,kv_layout", FAMILY_GRAPHS)
def test_family_decode_replays_equal_eager(cuda, arch, kv_layout):
    """mixtral (top-2), maverick (top-1, a shared expert) and whisper: the
    decode call under ``eager()``, then graphed, then replayed, on the
    same inputs: the active lanes' logits are the same bits (a moe
    batch's lanes are coupled through the routing, padding lanes
    included) and every call moves the launch counters alike."""
    from repro_torch.serving.families import eager
    cfg, params = _family_params(cuda, arch, 0)
    engine = _family_engine(cfg, params, kv_layout)
    ad = engine.adapter
    assert ad.graphed
    tokens, active = _family_decoding(
        engine, torch.Generator(device=cuda).manual_seed(1))
    with eager():
        want, launched = _decode_call(ad, tokens, active)
    for _ in range(2):
        got, moved = _decode_call(ad, tokens, active)
        assert torch.equal(got[active], want[active])
        assert moved == launched
    st = ad.captured_decode.stats()
    assert st["captures"] == 1 and st["replays"] >= 1
    assert st["launches_per_replay"] == [sum(launched.values())]
    engine.run()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "whisper-medium"])
def test_family_new_params_or_arenas_capture_anew(cuda, arch):
    """Other params under the same adapter capture a graph of their own
    whose logits are the eager call's on them; the first params replay
    their own graph again; a replaced arena (KV, or whisper's context
    rows) captures again."""
    from repro_torch.serving.families import eager
    cfg, params = _family_params(cuda, arch, 0)
    _, other = _family_params(cuda, arch, 5)
    engine = _family_engine(cfg, params, "slot")
    ad = engine.adapter
    tokens, active = _family_decoding(
        engine, torch.Generator(device=cuda).manual_seed(3))
    first, _ = _decode_call(ad, tokens, active)
    n = len(ad.captured_decode.graphs)
    ad.params = other
    with eager():
        want, _ = _decode_call(ad, tokens, active)
    for _ in range(2):
        got, _ = _decode_call(ad, tokens, active)
        assert torch.equal(got[active], want[active])
    assert len(ad.captured_decode.graphs) == n + 1
    assert not torch.equal(got[active], first[active])
    ad.params = params
    back, _ = _decode_call(ad, tokens, active)
    assert len(ad.captured_decode.graphs) == n + 1
    assert torch.equal(back[active], first[active])
    if cfg.family == "encdec":
        ad.ctx.ck = ad.ctx.ck.clone()
    else:
        ad.pool.k = ad.pool.k.clone()
    with eager():
        want, _ = _decode_call(ad, tokens, active)
    got, _ = _decode_call(ad, tokens, active)
    assert torch.equal(got[active], want[active])
    assert len(ad.captured_decode.graphs) == n + 2


@pytest.mark.parametrize("arch,kv_layout", FAMILY_GRAPHS)
def test_family_serve_captures_once_and_streams_equal_eager(cuda, arch,
                                                            kv_layout):
    """The same traffic served under ``eager()`` and replayed, on two
    engines over the same params: identical streams, one capture, every
    other decode call a replay, and the same launch counts."""
    from repro_torch.kernels.common import launch_counts
    from repro_torch.serving import SamplingParams, Status
    from repro_torch.serving.families import eager
    cfg, params = _family_params(cuda, arch, 0)
    g = torch.Generator(device=cuda).manual_seed(4)
    traffic = [(torch.randint(0, cfg.vocab, (8 + 6 * i,), generator=g,
                              device=cuda).tolist(), _family_kw(cfg, g))
               for i in range(4)]
    runs = []
    for graphed in (False, True):
        engine = _family_engine(cfg, params, kv_layout)
        before = launch_counts()
        reqs = [engine.submit(p, SamplingParams(max_new_tokens=40), **kw)
                for p, kw in traffic]
        with (contextlib.nullcontext() if graphed else eager()):
            engine.run()
        after = launch_counts()
        assert all(r.status is Status.FINISHED and len(r.tokens) == 40
                   for r in reqs)
        runs.append(([r.tokens for r in reqs],
                     {k: n - before[k] for k, n in after.items()},
                     engine.adapter.captured_decode.stats()))
    (eager_streams, eager_moved, eager_st), (streams, moved, st) = runs
    assert streams == eager_streams
    assert moved == eager_moved
    assert eager_st["captures"] == 0 and st["captures"] == 1
    assert st["replays"] >= 38


def test_paged_engine_runs_the_kernel(cuda):
    """The smoke model served on the paged layout on the card: every layer
    of every model call launches the paged kernel once."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import SamplingParams, ServingEngine, Status
    from repro_torch.serving.paged import paged_attention as pa
    cfg = dataclasses.replace(get_smoke("llama-paper"), dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = tfm.init_params(cfg, g, cuda)
    engine = ServingEngine(cfg, params, device="cuda", n_slots=4,
                           max_len=96, kv_layout="paged", block_size=16,
                           token_budget=32)
    before = pa.launches
    before_paths = pa.launches_decode + pa.launches_prefill
    before_prefill = pa.launches_prefill
    shared = torch.randint(0, cfg.vocab, (32,), generator=g,
                           device=cuda).tolist()
    reqs = [engine.submit(shared + [i + 1] * (5 + 3 * i),
                          SamplingParams(max_new_tokens=6)) for i in range(3)]
    engine.run()
    reqs.append(engine.submit(shared + [7] * 4,
                              SamplingParams(max_new_tokens=6)))
    engine.run()
    assert all(r.status is Status.FINISHED and len(r.tokens) == 6
               for r in reqs)
    st = engine.stats()
    assert pa.launches - before == cfg.n_layers * st["n_model_calls"]
    assert pa.launches_decode + pa.launches_prefill - before_paths == \
        pa.launches - before
    assert pa.launches_prefill > before_prefill
    assert st["pool"]["prefix_cache"]["hits"] >= 1


@pytest.mark.parametrize("kv_layout", ["slot", "paged"])
def test_int8_engine_runs_the_int8_kernels(cuda, kv_layout):
    """The smoke model with int8 8:16+16:256 weights on int8 KV arenas: every
    projection of every model call launches an int8 weight kernel, and on
    the paged layout every layer the int8 paged kernel; no bf16 variant
    launches."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.serving import SamplingParams, ServingEngine, Status
    from repro_torch.serving.paged import paged_attention as pa
    cfg = dataclasses.replace(get_smoke("llama-paper"), dtype=torch.bfloat16)
    args = serve.parse_args(["--arch", "llama-paper", "--smoke-arch",
                             "--sparse"])
    g = torch.Generator(device=cuda).manual_seed(0)
    params, _ = serve.build_params(cfg, args, cuda, g, quantize=True)
    engine = ServingEngine(cfg, params, device="cuda", n_slots=4,
                           max_len=96, kv_layout=kv_layout, block_size=16,
                           token_budget=32, kv_dtype="int8")
    counts = lambda: (nms.launches, fsl.launches, pa.launches,  # noqa: E731
                      nms.launches_int8, fsl.launches_int8, pa.launches_int8)
    before = counts()
    reqs = [engine.submit(torch.randint(0, cfg.vocab, (20 + 9 * i,),
                                        generator=g, device=cuda).tolist(),
                          SamplingParams(max_new_tokens=6)) for i in range(3)]
    engine.run()
    assert all(r.status is Status.FINISHED and len(r.tokens) == 6
               for r in reqs)
    st = engine.stats()
    calls = st["n_model_calls"]
    delta = [a - b for a, b in zip(counts(), before)]
    with_o = sum(lp[n].o_values is not None for lp in params["layers"]
                 for n in lp if n.startswith("w"))
    without_o = 7 * cfg.n_layers - with_o
    want_pa = cfg.n_layers * calls if kv_layout == "paged" else 0
    assert delta == [0, 0, 0, without_o * calls, with_o * calls, want_pa]
    assert st["pool"]["kv_dtype"] == "int8" and st["pool"]["scale_bytes"] > 0


# ----------------------------------------------------- outlier_spmm and ops

def _outliers(N, K, n, g, device):
    """Random N:256 outliers: distinct ascending indices per group, index
    255 in the last slot of a few groups (the top byte of a word, which
    makes it negative)."""
    from repro_torch.core import pack_outlier_meta
    groups = K // 256
    idx = torch.rand((N, groups, 256), generator=g, device=device)
    idx = torch.sort(idx.argsort(-1)[..., :n], dim=-1).values.int()
    idx[::7, :, -1] = 255
    vals = torch.randn((N, groups, n), generator=g, device=device)
    return vals.to(torch.bfloat16), pack_outlier_meta(idx)


def _osp_plans(M, K, N, n, path, split):
    """``outlier_spmm``'s plan for ``path`` ("decode" or "prefill"), with K
    split as far as it goes (one group a slice, ``split`` True) or as
    little as the body takes (False: one slice; the decode body's x slice
    bounds it)."""
    from repro_torch.kernels import outlier_spmm as osp
    p = osp.plan(M, K, N, n, _sm_count(),
                 decode_max_m=M if path == "decode" else 0)
    assert p.path == path
    groups = K // 256
    if split:
        per = 1
    elif path == "decode":
        per = min(groups, osp.X_SLICE_BYTES // (2 * p.rows) // 256)
    else:
        per = groups
    S = -(-groups // per)
    tiles = p.counters if p.splits > 1 else p.blocks
    return dataclasses.replace(
        p, splits=S, k_per_split=per * 256,
        workspace_bytes=S * M * N * 4 if S > 1 else 0, blocks=tiles * S,
        counters=tiles if S > 1 else 0)


def _osp_counts():
    from repro_torch.kernels import outlier_spmm as osp
    return osp.launches, osp.launches_decode, osp.launches_prefill


@pytest.mark.parametrize("o_n", [4, 8, 16])
@pytest.mark.parametrize("N,K", [(96, 4096), (1000, 4096), (70, 14336),
                                 (37, 512)])
@pytest.mark.parametrize("M", [1, 7, 8, 9, 37, 130, 512])
def test_outlier_spmm_matches_plain(cuda, M, N, K, o_n):
    """Through the plan: the decode body at M <= T, the prefill body above,
    each counted on its path."""
    from repro_torch.kernels import outlier_spmm as osp
    g = torch.Generator(device=cuda).manual_seed(M * N + o_n)
    vals, meta = _outliers(N, K, o_n, g, cuda)
    assert bool((meta < 0).any())
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    path = osp.plan(M, K, N, o_n, _sm_count()).path
    assert path == ("decode" if M <= osp.DECODE_MAX_M else "prefill")
    before = _osp_counts()
    y = osp.outlier_spmm(x, vals, meta, n=o_n)
    assert _osp_counts() == (before[0] + 1, before[1] + (path == "decode"),
                             before[2] + (path == "prefill"))
    torch.cuda.synchronize()
    assert y.shape == (M, N) and y.dtype == torch.bfloat16
    _close(y, osp.plain(x, vals, meta, n=o_n))


@pytest.mark.parametrize("split", [False, True], ids=["one_slice", "split"])
@pytest.mark.parametrize("o_n", [4, 16])
@pytest.mark.parametrize("K", [512, 4096, 14336])
@pytest.mark.parametrize("N", [37, 70, 1000])
@pytest.mark.parametrize("M", [1, 7, 8, 9, 37, 130, 512])
@pytest.mark.parametrize("path", ["decode", "prefill"])
def test_outlier_spmm_bodies_forced_match_plain(cuda, path, M, N, K, o_n,
                                                split):
    """Each body forced at every M, with K in one slice (or as few as the
    decode body's x slice allows) and split one group a slice; two calls
    give the same bits."""
    from repro_torch.kernels import outlier_spmm as osp
    g = torch.Generator(device=cuda).manual_seed(M + N + K + o_n)
    vals, meta = _outliers(N, K, o_n, g, cuda)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    p = _osp_plans(M, K, N, o_n, path, split)
    before = _osp_counts()
    ys = [osp.outlier_spmm(x, vals, meta, n=o_n, force_plan=p)
          for _ in range(2)]
    assert _osp_counts() == (before[0] + 2,
                             before[1] + 2 * (path == "decode"),
                             before[2] + 2 * (path == "prefill"))
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1])
    _close(ys[0], osp.plain(x, vals, meta, n=o_n))


@pytest.mark.parametrize("o_n", [12, 20, 64])
@pytest.mark.parametrize("M", [1, 37])
def test_outlier_spmm_other_n_takes_the_decode_body(cuda, M, o_n):
    """The prefill body is compiled for n = 4, 8, 16; any other multiple of
    4 takes the decode body at every M."""
    from repro_torch.kernels import outlier_spmm as osp
    g = torch.Generator(device=cuda).manual_seed(o_n)
    vals, meta = _outliers(200, 768, o_n, g, cuda)
    x = torch.randn((M, 768), generator=g, device=cuda).to(torch.bfloat16)
    assert osp.plan(M, 768, 200, o_n, _sm_count()).path == "decode"
    before = _osp_counts()
    y = osp.outlier_spmm(x, vals, meta, n=o_n)
    assert _osp_counts()[1] == before[1] + 1
    torch.cuda.synchronize()
    _close(y, osp.plain(x, vals, meta, n=o_n))


def test_outlier_spmm_never_reaches_plain_or_the_old_kernel(cuda,
                                                            monkeypatch):
    """On a CUDA tensor the wrapper launches one of its two bodies; neither
    the plain version nor the old kernel is called."""
    from repro_torch.kernels import build
    from repro_torch.kernels import outlier_spmm as osp
    g = torch.Generator(device=cuda).manual_seed(3)
    vals, meta = _outliers(300, 1024, 16, g, cuda)
    cases = []
    for M in (1, 8, 9, 37, 130):
        x = torch.randn((M, 1024), generator=g, device=cuda).to(
            torch.bfloat16)
        cases.append((x, osp.plain(x, vals, meta, n=16)))

    def refuse(*a, **k):
        raise AssertionError("the plain version or the old kernel was "
                             "called on CUDA tensors")
    monkeypatch.setattr(osp, "plain", refuse)
    monkeypatch.setattr(osp, "outlier_spmm_ref", refuse)
    monkeypatch.setattr(build.library(), "outlier_spmm_gather8_bf16", refuse)
    before = _osp_counts()
    for x, want in cases:
        y = osp.outlier_spmm(x, vals, meta, n=16)
        torch.cuda.synchronize()
        _close(y, want)
    T = osp.DECODE_MAX_M
    n_dec = sum(M <= T for M in (1, 8, 9, 37, 130))
    assert _osp_counts() == (before[0] + 5, before[1] + n_dec,
                             before[2] + 5 - n_dec)


@pytest.mark.parametrize("M", [1, 37, 512])
def test_outlier_spmm_old_kernel_still_forced(cuda, M):
    """The first kernel stays callable through ``force_plan`` (to be timed
    beside the two bodies), counted on neither path, and agrees with the
    plain version."""
    from repro_torch.kernels import outlier_spmm as osp
    g = torch.Generator(device=cuda).manual_seed(M)
    vals, meta = _outliers(1000, 4096, 8, g, cuda)
    x = torch.randn((M, 4096), generator=g, device=cuda).to(torch.bfloat16)
    before = _osp_counts()
    y = osp.outlier_spmm(x, vals, meta, n=8,
                         force_plan=osp.gather8_plan(M, 4096, 1000))
    assert _osp_counts() == (before[0] + 1, before[1], before[2])
    torch.cuda.synchronize()
    _close(y, osp.plain(x, vals, meta, n=8))


def test_outlier_spmm_raises_on_misaligned_x(cuda):
    """Both bodies load x in 16-byte pieces: an x that is not 16-byte
    aligned raises before any launch."""
    from repro_torch.kernels import outlier_spmm as osp
    g = torch.Generator(device=cuda).manual_seed(1)
    vals, meta = _outliers(64, 512, 8, g, cuda)
    flat = torch.zeros(4 * 512 + 1, dtype=torch.bfloat16, device=cuda)
    before = _osp_counts()
    with pytest.raises(ValueError):
        osp.outlier_spmm(flat[1:].view(4, 512), vals, meta, n=8)
    assert _osp_counts() == before


def test_outlier_spmm_raises_instead_of_falling_back(cuda):
    from repro_torch.kernels import outlier_spmm as osp
    g = torch.Generator(device=cuda).manual_seed(0)
    vals, meta = _outliers(64, 512, 8, g, cuda)
    x = torch.randn((4, 512), generator=g, device=cuda).to(torch.bfloat16)
    before = osp.launches
    with pytest.raises(TypeError):                      # f32 x on CUDA
        osp.outlier_spmm(x.float(), vals, meta, n=8)
    with pytest.raises(TypeError):                      # f32 values
        osp.outlier_spmm(x, vals.float(), meta, n=8)
    with pytest.raises(TypeError):                      # int64 meta
        osp.outlier_spmm(x, vals, meta.long(), n=8)
    with pytest.raises(ValueError):                     # values on the CPU
        osp.outlier_spmm(x, vals.cpu(), meta, n=8)
    with pytest.raises(ValueError):                     # not contiguous
        osp.outlier_spmm(x, vals.transpose(0, 1).contiguous()
                         .transpose(0, 1), meta, n=8)
    with pytest.raises(ValueError):                     # K % 256
        osp.outlier_spmm(x[:, :384], vals, meta, n=8)
    with pytest.raises(ValueError):                     # n does not match
        osp.outlier_spmm(x, vals, meta, n=4)
    with pytest.raises(ValueError):                     # not 8-byte aligned
        flat = torch.empty(vals.numel() + 1, dtype=torch.bfloat16,
                           device=cuda)
        osp.outlier_spmm(x, flat[1:].view(vals.shape), meta, n=8)
    assert osp.launches == before


@pytest.mark.parametrize("o_pattern", ["4:256", "16:256"])
def test_ops_on_cuda_launch_the_kernels(cuda, o_pattern):
    """``kernels/ops`` on the pipeline's output (RIA + SmoothQuant + VC on
    the card): each entry point launches its kernel once and agrees with
    its plain version; the unfused pair agrees with the fused kernel to the
    two extra bf16 roundings of the partial products and their bf16 sum."""
    from repro_torch.core import ActStats, sparsify_linear
    from repro_torch.kernels import ops
    from repro_torch.kernels import outlier_spmm as osp
    g = torch.Generator(device=cuda).manual_seed(5)
    w = (torch.randn((200, 1024), generator=g, device=cuda) / 32).to(
        torch.bfloat16)
    st = ActStats.init(1024, device=cuda).update(
        torch.randn((64, 1024), generator=g, device=cuda))
    sl = sparsify_linear(w, st, SparsifyConfig(outlier_pattern=o_pattern))
    x = torch.randn((2, 9, 1024), generator=g, device=cuda).to(torch.bfloat16)
    counts = lambda: (nms.launches, osp.launches, fsl.launches)  # noqa: E731
    before = counts()
    y_nm = ops.nm_matmul(x[0], sl.nm)
    y_o = ops.outlier_matmul(x[0], sl.outliers)
    y = ops.sparse_linear_apply(x, sl.nm, sl.outliers)
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1]
    torch.cuda.synchronize()
    assert y.shape == (2, 9, 200)
    ref, xc = _to_cpu(sl), x[0].cpu()        # the plain versions
    _close(y_o.cpu(), ops.outlier_matmul(xc, ref.outliers))
    _close(y_nm.cpu(), ops.nm_matmul(xc, ref.nm))
    _close(y[0].cpu(), ops.sparse_linear_apply(xc, ref.nm, ref.outliers))
    pair = y_nm + y_o
    tol = TOL_REL * float(y_nm.float().abs().max() + y_o.float().abs().max()
                          + y[0].float().abs().max())
    assert float((pair.float() - y[0].float()).abs().max()) <= tol


def _to_cpu(sl):
    import dataclasses
    return dataclasses.replace(
        sl, nm=dataclasses.replace(sl.nm, values=sl.nm.values.cpu(),
                                   indices=sl.nm.indices.cpu()),
        outliers=dataclasses.replace(sl.outliers,
                                     values=sl.outliers.values.cpu(),
                                     indices=sl.outliers.indices.cpu()),
        nm_mask=sl.nm_mask.cpu(), salient_mask=sl.salient_mask.cpu())


def test_pipeline_on_cuda_matches_cpu(cuda):
    """The paper's pipeline (RIA + SmoothQuant + VC) on the card against the
    same pipeline on the CPU, from the same bf16 weights and statistics:
    only reduction orders differ, so all but near-tied indices agree."""
    from repro_torch.core import ActStats, sparsify_linear
    g = torch.Generator(device=cuda).manual_seed(6)
    w = (torch.randn((512, 2048), generator=g, device=cuda) / 45).to(
        torch.bfloat16)
    st = ActStats.init(2048, device=cuda).update(
        torch.randn((256, 2048), generator=g, device=cuda))
    st_cpu = ActStats(st.sq_sum.cpu(), st.max_abs.cpu(), st.count.cpu())
    for cfg in (SparsifyConfig(), SparsifyConfig(unstructured_outliers=True)):
        a = sparsify_linear(w, st, cfg)
        b = sparsify_linear(w.cpu(), st_cpu, cfg)
        assert (a.nm.indices.cpu() == b.nm.indices).float().mean() >= 0.999
        assert (a.salient_mask.cpu() == b.salient_mask).float().mean() \
            >= 0.999


# ------------- paged attention at head dims 80, 192 and 256 (ROADMAP B11)
WIDE_SHAPES = [(192, 24, 2), (256, 4, 4), (256, 16, 4),      # hd, H, KV
               (80, 32, 32), (80, 8, 2)]
WIDE_CASES = [(1, 16, [0, 15, 16, 77]), (2, 8, [5, 130]),
              (37, 16, [9, 130]), (512, 16, [256, 3])]      # S, bs, cursors
# the prefill-chunk body at every case, the decode body where a lane has
# at most 2 x 8 rows
WIDE = [(S, bs, cur, hd, H, KV, body)
        for S, bs, cur in WIDE_CASES for hd, H, KV in WIDE_SHAPES
        for body in ("decode", "prefill")
        if body == "prefill" or S * H // KV <= 16]


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("S,bs,cursors,hd,H,KV,body", WIDE)
def test_paged_attention_wide_heads_match_plain(cuda, S, bs, cursors, hd, H,
                                                KV, body, window, quantize):
    """Both bodies, each forced, at hd 80, 192 and 256 against the plain
    version (the decode body row by row), with the body's launch counted
    and the same bits on a second call."""
    from repro_torch.serving.paged import paged_attention as pa
    rows = S * H // KV
    q, k, v, tables, cur = _paged_case(len(cursors), S, H, KV, hd, bs,
                                       cursors, S * 7 + H + hd, cuda)
    kw = dict(window=window)
    if quantize:
        k, v, ks, vs = _quantized(k, v)
        kw.update(k_scale=ks, v_scale=vs)
    p = pa.plan(len(cursors), S, H, KV, hd, bs, _sm_count(),
                nb=tables.shape[1],
                decode_max_rows=rows if body == "decode" else 0)
    assert p.path == body
    before = _paged_counts(pa)
    out = pa.paged_attention(q, k, v, tables, cur, force_plan=p, **kw)
    want = [0] * 6
    want[3 if quantize else 0] = 1
    want[(4 if quantize else 1) if body == "decode" else
         (5 if quantize else 2)] = 1
    assert [a - b for a, b in zip(_paged_counts(pa), before)] == want
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    ref = pa.plain(q, k, v, tables, cur, **kw)
    (_close_rows if body == "decode" else _close)(out, ref)
    again = pa.paged_attention(q, k, v, tables, cur, force_plan=p, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


def test_paged_attention_hd256_refuses_bm128(cuda):
    """At hd 256 a bf16 block of 128 rows needs 263,168 bytes of shared
    memory: the wrapper raises before any launch; BM 64 runs."""
    import dataclasses
    from repro_torch.serving.paged import paged_attention as pa
    q, k, v, tables, cur = _paged_case(1, 512, 16, 16, 256, 16, [256], 9,
                                       cuda)
    p = pa.plan(1, 512, 16, 16, 256, 16, _sm_count(), nb=tables.shape[1])
    assert (p.path, p.rows) == ("prefill", 64)
    before = _paged_counts(pa)
    with pytest.raises(ValueError, match="shared memory"):
        pa.paged_attention(q, k, v, tables, cur,
                           force_plan=dataclasses.replace(p, rows=128))
    assert _paged_counts(pa) == before
    _close(pa.paged_attention(q, k, v, tables, cur),
           pa.plain(q, k, v, tables, cur))


@pytest.mark.parametrize("arch", ["gemma-7b", "nemotron-4-340b"])
def test_paged_engine_serves_wide_heads(cuda, arch):
    """A 2-layer model of the arch's attention shape (hd 256 / 192) served
    on the paged layout: one paged kernel launch a layer a model call, bf16
    and int8 KV."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import SamplingParams, ServingEngine, Status
    from repro_torch.serving.paged import paged_attention as pa
    base = get(arch)
    cfg = dataclasses.replace(base, n_layers=2, d_model=256, d_ff=512,
                              vocab=1024)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = tfm.init_params(cfg, g, cuda)
    for kv_dtype in ("bf16", "int8"):
        engine = ServingEngine(cfg, params, device="cuda", n_slots=4,
                               max_len=96, kv_layout="paged", block_size=16,
                               token_budget=64, kv_dtype=kv_dtype)
        attr = "launches" + ("_int8" if kv_dtype == "int8" else "")
        before = getattr(pa, attr)
        reqs = [engine.submit(torch.randint(0, cfg.vocab, (20 + 9 * i,),
                                            generator=g,
                                            device=cuda).tolist(),
                              SamplingParams(max_new_tokens=6))
                for i in range(3)]
        engine.run()
        assert all(r.status is Status.FINISHED and len(r.tokens) == 6
                   for r in reqs)
        assert getattr(pa, attr) - before == \
            cfg.n_layers * engine.stats()["n_model_calls"]
