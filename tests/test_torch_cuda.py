"""The port's CUDA kernels on the card, bf16 and int8 variants and
``outlier_spmm``: each against its plain version at small and ragged shapes
(M, N and K not multiples of the tiles), ``kernels/ops`` and the paper's
pipeline on the card, and the wrappers' refusals — a CUDA tensor reaching
a wrapper launches the kernel or raises, it never falls back to the plain
version.

Needs a card and nvcc; skips elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import math

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


@pytest.mark.parametrize("o_n", [4, 8, 16])
@pytest.mark.parametrize("N,K", [(96, 4096), (1000, 4096), (70, 14336),
                                 (37, 512)])
@pytest.mark.parametrize("M", [1, 7, 37, 130])
def test_outlier_spmm_matches_plain(cuda, M, N, K, o_n):
    from repro_torch.kernels import outlier_spmm as osp
    g = torch.Generator(device=cuda).manual_seed(M * N + o_n)
    vals, meta = _outliers(N, K, o_n, g, cuda)
    assert bool((meta < 0).any())
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    before = osp.launches
    y = osp.outlier_spmm(x, vals, meta, n=o_n)
    assert osp.launches == before + 1
    torch.cuda.synchronize()
    assert y.shape == (M, N) and y.dtype == torch.bfloat16
    _close(y, osp.plain(x, vals, meta, n=o_n))


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
