"""``paged_attention``'s plan and a plain-torch model of its prefill-chunk
body (``csrc/paged_attention_prefill.cu``) on the CPU, against the JAX
package's ``paged_attention_ref`` and ``paged_attention_pallas`` (interpret
mode) on the same numpy inputs.

The model does the body's arithmetic in the body's order: per (lane, KV
head, tile of BM rows) a loop over 64-key tiles from the window's first
tile to the last position the tile's rows see, each key row gathered
through the table (zero-filled past the visible end, past nb * bs, or where
the table entry lies outside the arena), scores scaled in log2 units (with
int8 each column by its k_scale), an online softmax a tile at a time, P
times v_scale rounded to bf16 before the PV product, and O / max(l, 1e-30).

Tolerances.  With P kept in f32 the model is the reference's masked
softmax in another summation order: atol = rtol = 1e-5 (f32 inputs of order
1).  With P rounded to bf16, each p_j v_j term moves by at most 2**-8 of
|p_j v_j| (round to nearest), so an output moves by at most 2**-8 sum_j p_j
|v_j| / l <= 2**-8 max_j |v_j|; the tests allow that plus the f32
tolerance.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving.paged.paged_attention import \
    paged_attention_pallas  # noqa: E402
from repro.serving.paged.paged_attention import \
    paged_attention_ref  # noqa: E402
from repro_torch.serving.paged import paged_attention as pa  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module's many small CPU ops run, so
    that several test workers on one machine do not oversubscribe its
    cores (it changes no case and no tolerance); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TK = 64
ATOL = RTOL = 1e-5
SMS = 132                       # an H100's SMs, for the plan tests
NB = 65                         # table entries: a 1,040-token lane at bs 16


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("S,H,KV", [(1, 32, 8), (2, 32, 8), (4, 32, 8),
                                    (5, 32, 8), (16, 8, 8), (17, 8, 8),
                                    (2, 64, 8), (3, 64, 8), (1, 16, 1)])
def test_plan_sends_rows_up_to_t_to_decode(S, H, KV):
    rows = S * (H // KV)
    p = pa.plan(4, S, H, KV, 128, 16, SMS, nb=NB)
    assert p.path == ("decode" if rows <= pa.DECODE_MAX_ROWS else "prefill")
    if p.path == "decode":     # R rows a block, spans of DECODE_SPAN keys
        r = 4 if rows <= 4 else 8
        splits = -(-NB * 16 // pa.DECODE_SPAN)
        assert (p.rows, p.splits) == (r, splits)
        assert p.blocks == splits * -(-rows // r) * KV * 4
    for t in (0, rows - 1, rows, 4096):
        assert pa.plan(4, S, H, KV, 128, 16, SMS, nb=NB,
                       decode_max_rows=t).path == (
            "decode" if rows <= t else "prefill")


def test_plan_picks_bm_by_blocks():
    """A 512-token chunk of llama3-8b: 16 x 8 = 128 blocks of 128 rows; a
    64-token chunk of 4 lanes: 128 blocks of 64 rows (64 blocks of 128
    would leave half the SMs idle)."""
    p = pa.plan(1, 512, 32, 8, 128, 16, SMS, nb=NB)
    assert (p.path, p.rows, p.blocks) == ("prefill", 128, 128)
    p = pa.plan(4, 64, 32, 8, 128, 16, SMS, nb=NB)
    assert (p.path, p.rows, p.blocks) == ("prefill", 64, 128)
    assert pa.plan(8, 64, 32, 8, 128, 16, SMS, nb=NB).rows == 128


@pytest.mark.parametrize("B", [1, 3, 65535])
@pytest.mark.parametrize("S", [5, 37, 64, 129, 512, 4096])
@pytest.mark.parametrize("H,KV", [(4, 4), (32, 8), (12, 4), (64, 8),
                                  (8, 1)])
def test_plan_covers_every_row_within_the_grid(B, S, H, KV):
    p = pa.plan(B, S, H, KV, 64, 16, SMS, nb=NB, decode_max_rows=0)
    rows = S * (H // KV)
    tiles = -(-rows // p.rows)
    assert p.path == "prefill" and p.rows in (64, 128)
    assert p.blocks == tiles * KV * B
    assert (tiles - 1) * p.rows < rows <= tiles * p.rows
    assert tiles < 2**31 and KV <= pa.GRID_LIMIT and B <= pa.GRID_LIMIT


def test_force_plan_picks_the_entry_point():
    """The body ``paged_attention`` launches is the forced plan's: decode
    plans call the decode entry points, prefill plans the prefill ones;
    a plan no body takes raises."""
    import dataclasses
    dec = pa.plan(4, 64, 32, 8, 128, 16, SMS, nb=NB, decode_max_rows=10**6)
    pre = pa.plan(1, 1, 32, 8, 128, 16, SMS, nb=NB, decode_max_rows=0)
    assert (dec.path, pre.path) == ("decode", "prefill")
    assert pa.entry_point(dec, False) == "paged_attention_decode_bf16"
    assert pa.entry_point(dec, True) == "paged_attention_decode_int8"
    assert pa.entry_point(pre, False) == "paged_attention_prefill_bf16"
    assert pa.entry_point(pre, True) == "paged_attention_prefill_int8"
    for bad in (dataclasses.replace(pre, rows=96),
                dataclasses.replace(pre, rows=0),
                dataclasses.replace(pre, path="tile")):
        with pytest.raises(ValueError):
            pa.entry_point(bad, False)
    with pytest.raises(ValueError):
        pa.plan(1, 4, 6, 4, 128, 16, SMS, nb=NB)   # H % KV != 0


def test_cpu_tensors_take_the_plain_version_whatever_the_plan():
    q, k, v, tables, cur, _, _ = _inputs(2, 9, 8, 2, 64, 16, [3, 20], 1)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, cur)]
    before = (pa.launches, pa.launches_prefill, pa.launches_decode)
    forced = pa.plan(2, 9, 8, 2, 64, 16, SMS, nb=tables.shape[1],
                     decode_max_rows=0)
    out = pa.paged_attention(*t, force_plan=forced)
    assert torch.equal(out, pa.plain(*t))
    assert (pa.launches, pa.launches_prefill, pa.launches_decode) == before


# ----------------------------------------------------------------- model
def prefill_model(q, k_arena, v_arena, tables, cursor, *, window=None,
                  k_scale=None, v_scale=None, bm=64, round_p=True):
    """The prefill-chunk body's arithmetic in f32 (see the module
    docstring); rows past S * n_rep are not computed."""
    B, S, H, hd = q.shape
    n_blocks, bs, KV, _ = k_arena.shape
    nb = tables.shape[1]
    n_rep = H // KV
    rows = S * n_rep
    scale = math.log2(math.e) / math.sqrt(hd)
    int8 = k_scale is not None
    out = torch.zeros(B, S, H, hd)
    for b in range(B):
        cur = int(cursor[b])
        for kvh in range(KV):
            for r0 in range(0, rows, bm):
                gr = torch.arange(r0, min(r0 + bm, rows))
                qi, h = gr // n_rep, kvh * n_rep + gr % n_rep
                qt = q[b, qi, h].float()
                qpos = cur + qi
                kv_end = min(nb * bs, cur + int(qi[-1]) + 1)
                kv_begin = 0 if window is None else max(
                    0, cur + int(qi[0]) - window + 1) // TK * TK
                lim = torch.clamp(qpos, max=kv_end - 1)
                lo = (qpos - window + 1 if window is not None
                      else torch.zeros_like(qpos))
                m = torch.full((len(gr),), -1e30)
                l_sum = torch.zeros(len(gr))
                o = torch.zeros(len(gr), hd)
                for j0 in range(kv_begin, kv_end, TK):
                    j = torch.arange(j0, j0 + TK)
                    blk = torch.full((TK,), -1, dtype=torch.long)
                    vis = j < kv_end
                    blk[vis] = tables[b, j[vis] // bs].long()
                    ok = (blk >= 0) & (blk < n_blocks)
                    kt, vt = torch.zeros(TK, hd), torch.zeros(TK, hd)
                    kt[ok] = k_arena[blk[ok], j[ok] % bs, kvh].float()
                    vt[ok] = v_arena[blk[ok], j[ok] % bs, kvh].float()
                    col = torch.full((TK,), scale)
                    vs = torch.ones(TK)
                    if int8:
                        ks, vs = torch.zeros(TK), torch.zeros(TK)
                        ks[ok] = k_scale[blk[ok], j[ok] % bs, kvh]
                        vs[ok] = v_scale[blk[ok], j[ok] % bs, kvh]
                        col = scale * ks
                    s = (qt @ kt.T) * col[None]
                    seen = (j[None] <= lim[:, None]) & (j[None] >= lo[:, None])
                    s = torch.where(seen, s, torch.tensor(-1e30))
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    m = m_new
                    l_sum = l_sum * alpha + p.sum(dim=1)
                    pv = p * vs[None]
                    if round_p:
                        pv = pv.to(torch.bfloat16).float()
                    o = o * alpha[:, None] + pv @ vt
                out[b, qi, h] = o / torch.clamp(l_sum, min=1e-30)[:, None]
    return out


def _inputs(B, S, H, KV, hd, bs, cursors, seed, *, int8=False, wild=False):
    """numpy q and arenas (bf16-representable values; int8 values with f32
    scales), shuffled tables padded with the trash block 0.  ``wild``: lane
    0's entries past its visible end hold out-of-range ids (n_blocks + 5,
    -3) and trash."""
    rng = np.random.default_rng(seed)
    need = [-(-(c + S) // bs) for c in cursors]
    nb = max(need) + 2
    n_blocks = 1 + sum(need) + 3
    perm = list(rng.permutation(n_blocks - 1) + 1)
    tables = np.zeros((B, nb), np.int32)
    for b, n in enumerate(need):
        tables[b, :n] = perm[:n]
        perm = perm[n:]
    if wild:
        pad = np.array([n_blocks + 5, -3, 0], np.int32)
        tables[0, need[0]:] = np.resize(pad, nb - need[0])

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16).float().numpy()
    q = bf16(rng.standard_normal((B, S, H, hd)))
    shape = (n_blocks, bs, KV, hd)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, shape[:3]).astype(np.float32)
    else:
        k, v = bf16(rng.standard_normal(shape)), bf16(rng.standard_normal(shape))
        ks = vs = None
    return q, k, v, tables, np.array(cursors, np.int32), ks, vs


def _jax(fn, q, k, v, tables, cur, ks, vs, window, **kw):
    extra = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                       v_scale=jnp.asarray(vs))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(tables), jnp.asarray(cur),
                         window=window, **extra, **kw))


def _model(q, k, v, tables, cur, ks, vs, window, **kw):
    extra = {} if ks is None else dict(k_scale=torch.from_numpy(ks),
                                       v_scale=torch.from_numpy(vs))
    return prefill_model(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(tables),
                         torch.from_numpy(cur), window=window, **extra,
                         **kw).numpy()


def _v_max(v, vs):
    return float(np.abs(v.astype(np.float32) * (
        1.0 if vs is None else vs[..., None])).max())


# (S, bs, cursors): ragged cursors on and off block and tile edges
CASES = {8: (37, [0, 61, 130]), 16: (70, [5, 64, 17]), 24: (21, [100, 3, 47])}


# the int8 half of this grid is in test_torch_paged_attention_prefill_int8.py
# (the same test, cases and tolerances), so that the two halves, 350 s each
# on the CPU, can run on two test workers
@pytest.mark.parametrize("int8", [False], ids=["bf16"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 24])
def test_model_matches_paged_attention_ref(bs, hd, n_rep, window, int8):
    """The model against ``paged_attention_ref``: exact P at the f32
    tolerance, bf16 P within 2**-8 of the largest |v| more; lane 0's table
    holds out-of-range ids and trash past its visible end."""
    S, cursors = CASES[bs]
    KV = 2
    args = _inputs(len(cursors), S, KV * n_rep, KV, hd, bs, cursors,
                   seed=bs * 100 + hd + n_rep, int8=int8, wild=True)
    q, k, v, tables, cur, ks, vs = args
    ref = _jax(paged_attention_ref, *args, window)
    exact = _model(*args, window, round_p=False)
    np.testing.assert_allclose(exact, ref, atol=ATOL, rtol=RTOL)
    got = _model(*args, window)
    assert np.abs(got - ref).max() <= 2.0 ** -8 * _v_max(v, vs) + ATOL + \
        RTOL * np.abs(ref).max()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("n_rep,hd,bs", [(1, 64, 24), (4, 128, 16),
                                         (8, 64, 8)])
def test_model_matches_paged_attention_pallas(n_rep, hd, bs, window, int8):
    """The model against the Pallas kernel in interpret mode on the same
    inputs (its tables must index the arena: no out-of-range ids)."""
    S, cursors = CASES[bs]
    KV = 2
    args = _inputs(len(cursors), S, KV * n_rep, KV, hd, bs, cursors,
                   seed=7 + bs + hd + n_rep, int8=int8)
    q, k, v, tables, cur, ks, vs = args
    ref = _jax(paged_attention_pallas, *args, window, interpret=True)
    exact = _model(*args, window, round_p=False)
    np.testing.assert_allclose(exact, ref, atol=ATOL, rtol=RTOL)
    got = _model(*args, window)
    assert np.abs(got - ref).max() <= 2.0 ** -8 * _v_max(v, vs) + ATOL + \
        RTOL * np.abs(ref).max()


@pytest.mark.parametrize("window", [None, 24])
def test_model_rows_tile_independent(window):
    """BM 64 and 128 give the same bits: a row's tiles differ only by
    leading tiles it cannot see, which alpha = 0 wipes exactly."""
    args = _inputs(3, 70, 8, 2, 64, 16, [5, 64, 17], seed=3, wild=True)
    a = _model(*args, window, bm=64)
    b = _model(*args, window, bm=128)
    np.testing.assert_array_equal(a, b)


def test_model_padding_lane_finite():
    """A padding lane (cursor 0, all-trash table) gives finite values equal
    to the reference's."""
    args = list(_inputs(2, 9, 8, 2, 64, 16, [20, 0], seed=4))
    args[3][1] = 0
    ref = _jax(paged_attention_ref, *args, None)
    got = _model(*args, None, round_p=False)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
