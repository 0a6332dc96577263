"""The port's CUDA kernels on the card: each against its plain version at
small and ragged shapes (M, N and K not multiples of the tiles), and the
wrappers' refusals — a CUDA tensor reaching a wrapper launches the kernel or
raises, it never falls back to the plain version.

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


def _sparse(N, K, weight_pattern, outlier_pattern, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    w = (torch.randn((N, K), generator=g, device=device)
         / math.sqrt(K)).to(torch.bfloat16)
    cfg = SparsifyConfig(weight_pattern=weight_pattern,
                         outlier_pattern=outlier_pattern)
    return to_sparse_weight(w, cfg), g


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


def test_sparse_apply_routes_to_the_kernels(cuda):
    with_o, g = _sparse(128, 512, "8:16", "16:256", 0, cuda)
    without, _ = _sparse(128, 512, "8:16", None, 1, cuda)
    x = torch.randn((2, 3, 512), generator=g, device=cuda).to(torch.bfloat16)
    counts = (nms.launches, fsl.launches)
    assert sparse_apply(with_o, x).shape == (2, 3, 128)
    assert sparse_apply(without, x).shape == (2, 3, 128)
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
