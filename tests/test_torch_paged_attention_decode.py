"""``paged_attention``'s decode plan and a plain-torch model of its decode
body (``csrc/paged_attention_decode.cu``) on the CPU, against the JAX
package's ``paged_attention_ref`` and ``paged_attention_pallas`` (interpret
mode) on the same numpy inputs.

The model does the body's arithmetic in the body's order: per (lane, tile
of R rows, split) the split's keys [s * span, (s + 1) * span) cut to what
the tile's rows can see, 64-key tiles from the window's first tile, each
key row gathered through the table (zero-filled past the visible end, past
nb * bs, or where the table entry lies outside the arena), scores scaled in
log2 units (with int8 each column by its k_scale), an online softmax a
tile at a time with P in f32 (with int8 times v_scale; l sums the unscaled
p), then the live splits' (m, l, acc) merged in split order, M = max m_s,
L = sum 2^(m_s - M) l_s, O = sum 2^(m_s - M) acc_s, and O / max(L, 1e-30).
KV heads are independent, so the model takes them together.

Tolerance: P stays in f32, so the model is the reference's masked softmax
in another summation order: atol = rtol = 1e-5 (f32 inputs of order 1).
"""
import inspect
import math
import pathlib
import re

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


# ----------------------------------------------------------------- model
def live_splits(cur, r0, R, rows, n_rep, nb, bs, window, span):
    """The body's key range for the row tile starting at r0 and its live
    splits: (kv_begin, kv_end, s_lo, s_hi)."""
    first_q, last_q = r0 // n_rep, (min(r0 + R, rows) - 1) // n_rep
    kv_end = min(nb * bs, cur + last_q + 1)
    kv_begin = 0 if window is None else max(0, cur + first_q - window + 1)
    s_hi = (kv_end - 1) // span
    return kv_begin, kv_end, min(kv_begin // span, s_hi), s_hi


def split_keys(s, kv_begin, kv_end, span):
    """The keys split s walks: from the 64-key tile of the window's first
    key (or the span's start) to the span's end or kv_end."""
    return max(s * span, kv_begin // TK * TK), min((s + 1) * span, kv_end)


def decode_model(q, k_arena, v_arena, tables, cursor, *, window=None,
                 k_scale=None, v_scale=None, span=pa.DECODE_SPAN, R=None):
    """The decode body's arithmetic in f32 (see the module docstring)."""
    B, S, H, hd = q.shape
    n_blocks, bs, KV, _ = k_arena.shape
    nb = tables.shape[1]
    n_rep = H // KV
    rows = S * n_rep
    R = R or (4 if rows <= 4 else 8)
    scale = math.log2(math.e) / math.sqrt(hd)
    int8 = k_scale is not None
    heads = torch.arange(KV)
    out = torch.zeros(B, S, H, hd)
    for b in range(B):
        cur = int(cursor[b])
        for r0 in range(0, rows, R):
            gr = torch.clamp(torch.arange(r0, r0 + R), max=rows - 1)
            valid = torch.arange(r0, r0 + R) < rows
            qi, rep = gr // n_rep, gr % n_rep
            h = heads[:, None] * n_rep + rep[None]              # [KV, R]
            qt = q[b, qi[None].expand(KV, R), h].float()        # [KV, R, hd]
            qt = qt * valid[None, :, None]
            kv_begin, kv_end, s_lo, s_hi = live_splits(
                cur, r0, R, rows, n_rep, nb, bs, window, span)
            qpos = cur + qi
            lim = torch.clamp(qpos, max=kv_end - 1)
            lo = (qpos - window + 1 if window is not None
                  else torch.zeros_like(qpos))
            parts = []
            for s in range(s_lo, s_hi + 1):
                m = torch.full((KV, R), -1e30)
                l_sum = torch.zeros(KV, R)
                acc = torch.zeros(KV, R, hd)
                j_lo, j_hi = split_keys(s, kv_begin, kv_end, span)
                for j0 in range(j_lo, j_hi, TK):
                    j = torch.arange(j0, j0 + TK)
                    blk = torch.full((TK,), -1, dtype=torch.long)
                    vis = j < kv_end
                    blk[vis] = tables[b, j[vis] // bs].long()
                    ok = (blk >= 0) & (blk < n_blocks)
                    kt, vt = torch.zeros(TK, KV, hd), torch.zeros(TK, KV, hd)
                    kt[ok] = k_arena[blk[ok], j[ok] % bs].float()
                    vt[ok] = v_arena[blk[ok], j[ok] % bs].float()
                    col = torch.full((KV, TK), scale)
                    vs = torch.ones(KV, TK)
                    if int8:
                        ks, vs = torch.zeros(TK, KV), torch.zeros(TK, KV)
                        ks[ok] = k_scale[blk[ok], j[ok] % bs]
                        vs[ok] = v_scale[blk[ok], j[ok] % bs]
                        col, vs = scale * ks.T, vs.T
                    x = torch.einsum("krd,jkd->krj", qt, kt) * col[:, None]
                    seen = (j[None] <= lim[:, None]) & (j[None] >= lo[:, None])
                    x = torch.where(seen[None], x, torch.tensor(-1e30))
                    m_new = torch.maximum(m, x.max(dim=2).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new[..., None])
                    m = m_new
                    l_sum = l_sum * alpha + p.sum(dim=2)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "krj,jkd->krd", p * vs[:, None], vt)
                parts.append((m, l_sum, acc))
            if len(parts) == 1:
                m_s, l_s, acc_s = parts[0]
                o = acc_s / torch.clamp(l_s, min=1e-30)[..., None]
            else:
                big = torch.stack([pt[0] for pt in parts]).max(dim=0).values
                L = torch.zeros(KV, R)
                o = torch.zeros(KV, R, hd)
                for m_s, l_s, acc_s in parts:
                    w = torch.exp2(m_s - big)
                    L = L + w * l_s
                    o = o + w[..., None] * acc_s
                o = o / torch.clamp(L, min=1e-30)[..., None]
            for r in range(R):
                if valid[r]:
                    out[b, qi[r], h[:, r]] = o[:, r]
    return out


def _inputs(B, S, H, KV, hd, bs, cursors, seed, *, int8=False, wild=False):
    """numpy q and arenas (bf16-representable values; int8 values with f32
    scales), shuffled tables padded with the trash block 0.  ``wild``:
    every lane's entries past its visible end hold out-of-range ids
    (n_blocks + 5, -3) and trash."""
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
            tables[b, n:] = np.resize(np.array([n_blocks + 5, -3, 0],
                                               np.int32), nb - n)

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
        k = bf16(rng.standard_normal(shape))
        v = bf16(rng.standard_normal(shape))
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
    return decode_model(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(tables),
                        torch.from_numpy(cur), window=window, **extra,
                        **kw).numpy()


# lanes' cursors: 0, on and off 16-key block edges and 128-key span edges
CURSORS = {8: [0, 63, 128, 301], 16: [0, 127, 144, 255],
           24: [0, 128, 71, 383]}


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 24])
def test_model_matches_paged_attention_ref(bs, hd, n_rep, window, int8, S):
    """The model against ``paged_attention_ref`` at the f32 tolerance; the
    tables hold out-of-range ids and trash past every lane's visible end."""
    KV = 2
    args = _inputs(4, S, KV * n_rep, KV, hd, bs, CURSORS[bs],
                   seed=bs * 100 + hd + n_rep + S, int8=int8, wild=True)
    ref = _jax(paged_attention_ref, *args, window)
    got = _model(*args, window)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n_rep,hd,bs,window", [(1, 64, 24, None),
                                                (4, 128, 16, 24),
                                                (8, 64, 8, None)])
def test_model_matches_paged_attention_pallas(n_rep, hd, bs, window, int8,
                                              S):
    """The model against the Pallas kernel in interpret mode on the same
    inputs (its tables must index the arena: no out-of-range ids)."""
    KV = 2
    args = _inputs(4, S, KV * n_rep, KV, hd, bs, CURSORS[bs],
                   seed=7 + bs + hd + n_rep + S, int8=int8)
    ref = _jax(paged_attention_pallas, *args, window, interpret=True)
    got = _model(*args, window)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("S,n_rep", [(1, 4), (2, 8), (2, 1)])
def test_model_one_split_and_many_agree(S, n_rep, window):
    """Spans of 64 keys (up to 7 live splits a lane) and one span over all
    of nb * bs give the same outputs within the f32 tolerance, and R = 4
    and R = 8 rows a block too."""
    args = _inputs(4, S, 2 * n_rep, 2, 64, 16, CURSORS[16], seed=11,
                   wild=True)
    nb_bs = args[3].shape[1] * 16
    many = _model(*args, window, span=TK)
    one = _model(*args, window, span=-(-nb_bs // TK) * TK)
    np.testing.assert_allclose(many, one, atol=ATOL, rtol=RTOL)
    other_r = _model(*args, window, R=8 if S * n_rep <= 4 else 4)
    np.testing.assert_allclose(other_r, one, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_model_padding_lane_finite(int8):
    """A padding lane (cursor 0, all-trash table) gives finite values equal
    to the reference's."""
    args = list(_inputs(2, 1, 8, 2, 64, 16, [200, 0], seed=4, int8=int8))
    args[3][1] = 0
    ref = _jax(paged_attention_ref, *args, None)
    got = _model(*args, None)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------ plan
def test_plan_takes_no_cursor_value():
    """The decode plan (grid, splits, workspace, counters) comes from the
    shapes alone: ``plan`` has no cursor argument, and calls whose
    cursors differ get the plan of their shapes, while the live splits
    the body computes on the card move with the cursors."""
    assert not any("cur" in name
                   for name in inspect.signature(pa.plan).parameters)
    B, S, H, KV, hd, bs, nb = 8, 1, 32, 8, 128, 16, 65
    p = pa.plan(B, S, H, KV, hd, bs, SMS, nb=nb)
    assert (p.path, p.rows, p.splits) == ("decode", 4, 9)
    assert p.blocks == 9 * 8 * 8
    assert p.workspace_bytes == 9 * 8 * 8 * 4 * (hd + 2) * 4
    assert p.counters == 8 * 8
    lives = set()
    for cursors in ([0] * 8, [1039] * 8, list(range(0, 1040, 130))):
        assert pa.plan(B, S, H, KV, hd, bs, SMS, nb=nb) == p
        lives.add(sum(hi - lo + 1 for _, _, lo, hi in (
            live_splits(c, 0, 4, 4, 4, nb, bs, None, pa.DECODE_SPAN)
            for c in cursors)))
    assert lives == {8, 72, 36}
    # the decode case of chip_smoke.py: 29 live splits of the 9 x 8 lanes
    live = [live_splits(c, 0, 4, 4, 4, nb, bs, None, 128)
            for c in [63, 200, 500, 700, 767, 1000, 15, 16]]
    assert sum(hi - lo + 1 for _, _, lo, hi in live) == 29


@pytest.mark.parametrize("bs,nb", [(8, 1), (16, 65), (24, 11), (16, 8),
                                   (8, 4096)])
def test_every_key_falls_in_one_split(bs, nb):
    """The plan's splits of DECODE_SPAN keys cover each key position
    < nb * bs exactly once, and no split lies wholly past them."""
    p, span = pa.plan(2, 1, 8, 2, 64, bs, SMS, nb=nb), pa.DECODE_SPAN
    assert p.path == "decode" and span % TK == 0
    count = np.zeros(nb * bs, np.int64)
    for s in range(p.splits):
        count[s * span:(s + 1) * span] += 1
    assert (count == 1).all()
    assert (p.splits - 1) * span < nb * bs <= p.splits * span


def test_decode_span_is_the_kernels():
    """``DECODE_SPAN``, by which ``plan`` sizes the workspace, is the span
    the decode body is compiled with (``kSpan``)."""
    src = (pathlib.Path(pa.__file__).resolve().parents[2] / "csrc"
           / "paged_attention_decode.cu").read_text()
    spans = re.findall(r"constexpr int kSpan = (\d+);", src)
    assert spans == [str(pa.DECODE_SPAN)]


@pytest.mark.parametrize("window", [None, 24, 200])
@pytest.mark.parametrize("S,n_rep,R", [(1, 4, 4), (2, 4, 8), (2, 8, 8),
                                       (3, 1, 4)])
def test_live_splits_cover_the_visible_keys_once(S, n_rep, R, window):
    """For each row tile, the live splits' key ranges are disjoint, in
    split order, and together cover every key a row of the tile can see;
    every other split of the grid does nothing."""
    bs, nb, span = 16, 40, 128
    rows = S * n_rep
    for cur in (0, 1, 63, 127, 128, 129, 300, nb * bs - S):
        for r0 in range(0, rows, R):
            kv_begin, kv_end, s_lo, s_hi = live_splits(
                cur, r0, R, rows, n_rep, nb, bs, window, span)
            walked = []
            for s in range(s_lo, s_hi + 1):
                j_lo, j_hi = split_keys(s, kv_begin, kv_end, span)
                assert j_lo < j_hi
                walked += list(range(j_lo, j_hi))
            assert walked == sorted(set(walked))
            qpos = [cur + (r0 + i) // n_rep for i in range(R)
                    if r0 + i < rows]
            seen = {j for p in qpos for j in range(nb * bs)
                    if j <= p and (window is None or j > p - window)}
            assert seen <= set(walked)
            assert 0 <= s_lo <= s_hi < -(-nb * bs // span)


def test_entry_points_of_the_decode_and_tile_plans():
    """Decode plans call the decode body's entry points; ``Plan("tile")``,
    and only it, the old kernel's; plans no body takes raise."""
    import dataclasses
    dec = pa.plan(4, 1, 32, 8, 128, 16, SMS, nb=65)
    assert dec.path == "decode"
    assert pa.entry_point(dec, False) == "paged_attention_decode_bf16"
    assert pa.entry_point(dec, True) == "paged_attention_decode_int8"
    assert pa.entry_point(pa.Plan("tile"), False) == "paged_attention_bf16"
    assert pa.entry_point(pa.Plan("tile"), True) == "paged_attention_int8"
    for bad in (dataclasses.replace(dec, rows=16),
                dataclasses.replace(dec, splits=0),
                dataclasses.replace(dec, path="tile"),
                pa.Plan("tile", rows=4), pa.Plan("decode")):
        with pytest.raises(ValueError):
            pa.entry_point(bad, False)


def test_decode_plan_must_cover_the_call():
    """A forced decode plan whose splits are not the body's for the call's
    keys, or that covers fewer row tiles or workspace than the call needs,
    raises before any launch."""
    import dataclasses
    p = pa.plan(4, 2, 32, 8, 128, 16, SMS, nb=65, decode_max_rows=8)
    assert p.path == "decode"
    pa._check_decode_plan(p, 4, 8, 8, 128, 65 * 16)
    for bad, args in ((p, (4, 8, 8, 128, 73 * 16)),
                      (p, (4, 16, 8, 128, 65 * 16)),
                      (p, (5, 8, 8, 128, 65 * 16)),
                      (dataclasses.replace(p, workspace_bytes=4),
                       (4, 8, 8, 128, 65 * 16)),
                      (dataclasses.replace(p, splits=p.splits + 1),
                       (4, 8, 8, 128, 65 * 16))):
        with pytest.raises(ValueError):
            pa._check_decode_plan(bad, *args)


@pytest.mark.parametrize("forced", ["decode", "tile"])
def test_cpu_tensors_take_the_plain_version_whatever_the_plan(forced):
    q, k, v, tables, cur, _, _ = _inputs(2, 1, 8, 2, 64, 16, [3, 20], 1)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, cur)]
    counters = ("launches", "launches_decode", "launches_tile")
    before = [getattr(pa, c) for c in counters]
    p = (pa.plan(2, 1, 8, 2, 64, 16, SMS, nb=tables.shape[1])
         if forced == "decode" else pa.Plan("tile"))
    out = pa.paged_attention(*t, force_plan=p)
    assert torch.equal(out, pa.plain(*t))
    assert [getattr(pa, c) for c in counters] == before
