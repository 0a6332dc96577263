"""``paged_attention`` at head dims 192 (nemotron-4-340b), 256 (gemma-7b)
and 80 (zamba2-2.7b's shared attention, in a narrow grid of its own at the
end) on the CPU: the plain version against the JAX package's
``paged_attention_ref`` and its Pallas kernel in interpret mode (with a
head tile where H * hd >= 4,096, as the reference's ``_head_tile``
picks), bf16 and int8 arenas; the CPU models of the decode and
prefill-chunk bodies (``test_torch_paged_attention_decode.py``,
``test_torch_paged_attention_prefill.py``) at these widths; the plan's
row tiles and the shared memory each takes (``prefill_smem_bytes``, the
sizes of ``Layout<HD, BM, T>`` in ``csrc/paged_attention_prefill.cu``), and
the decode workspace at hd + 2 floats a row.  The kernels themselves run
in ``test_torch_cuda.py`` on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serving.paged.paged_attention import _head_tile  # noqa: E402
from repro.serving.paged.paged_attention import \
    paged_attention_pallas  # noqa: E402
from repro.serving.paged.paged_attention import \
    paged_attention_ref  # noqa: E402
from repro_torch.serving.paged import paged_attention as pa  # noqa: E402
from test_torch_paged_attention_decode import \
    _model as decode_model  # noqa: E402
from test_torch_paged_attention_prefill import \
    _inputs, _jax, _v_max  # noqa: E402
from test_torch_paged_attention_prefill import \
    _model as prefill_model  # noqa: E402

ATOL = RTOL = 1e-5
SMS = 132                       # an H100's SMs
WIDE = (192, 256)


def _plain(q, k, v, tables, cur, ks, vs, window):
    extra = {} if ks is None else dict(k_scale=torch.from_numpy(ks),
                                       v_scale=torch.from_numpy(vs))
    return pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(cur), window=window,
        **extra).numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ the plain version vs JAX
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("hd", WIDE)
def test_plain_matches_paged_attention_ref(hd, S, window, int8):
    """GQA 4:1 over shuffled, trash-padded tables."""
    args = _inputs(3, S, 8, 2, hd, 16, [0, 37, 70], seed=hd + S,
                   int8=int8)
    np.testing.assert_allclose(_plain(*args, window),
                               _jax(paged_attention_ref, *args, window),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hd,H,KV", [(256, 16, 4), (192, 24, 4),
                                     (256, 4, 2)])
def test_plain_matches_paged_attention_pallas(hd, H, KV, int8):
    """Against the Pallas kernel in interpret mode, with the head tile the
    reference picks: H * hd >= 4,096 walks head tiles (gemma-7b's width at
    16 heads, 2 KV heads a tile; hd 192 at 24 heads, 1), below it none."""
    tile = _head_tile(H, KV, hd)
    assert (tile is not None) == (H * hd >= 4096)
    args = _inputs(2, 5, H, KV, hd, 8, [3, 20], seed=hd + H, int8=int8)
    ref = _jax(paged_attention_pallas, *args, None, interpret=True,
               head_tile=tile)
    np.testing.assert_allclose(_plain(*args, None), ref, atol=ATOL,
                               rtol=RTOL)


# ------------------------------------------------- the bodies' CPU models
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hd,n_rep,window", [(192, 4, None), (256, 1, 24)])
def test_decode_model_matches_paged_attention_ref(hd, n_rep, window, int8):
    """The decode body's model (spans, 64-key tiles, merge in split order)
    at the f32 tolerance."""
    args = _inputs(3, 1, 2 * n_rep, 2, hd, 16, [0, 127, 301],
                   seed=hd + n_rep, int8=int8, wild=True)
    np.testing.assert_allclose(
        decode_model(*args, window),
        _jax(paged_attention_ref, *args, window), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hd,n_rep,window,bm", [(192, 4, None, 128),
                                                (256, 1, 24, 64)])
def test_prefill_model_matches_paged_attention_ref(hd, n_rep, window, bm,
                                                   int8):
    """The prefill-chunk body's model: exact P at the f32 tolerance, P in
    bf16 within 2**-8 of the largest |v| more."""
    args = _inputs(2, 21, 2 * n_rep, 2, hd, 16, [5, 64], seed=hd + bm,
                   int8=int8, wild=True)
    v, vs = args[2], args[6]
    ref = _jax(paged_attention_ref, *args, window)
    exact = prefill_model(*args, window, bm=bm, round_p=False)
    np.testing.assert_allclose(exact, ref, atol=ATOL, rtol=RTOL)
    got = prefill_model(*args, window, bm=bm)
    assert np.abs(got - ref).max() <= 2.0 ** -8 * _v_max(v, vs) + ATOL + \
        RTOL * np.abs(ref).max()


# ------------------------------------------------------------------ plan
def test_prefill_smem_bytes_are_the_kernels_layouts():
    """``Layout<HD, BM, T>::kTotal`` worked out: hd 256 fits bf16 at BM 64
    only; int8 converts a tile ahead (two operand pairs, one ring slot
    more) where that fits, else in place."""
    want = {(64, 64): (58368, 76800), (64, 128): (66560, 84992),
            (128, 64): (115712, 150528), (128, 128): (132096, 166912),
            (192, 64): (173056, 224256), (192, 128): (197632, 174592),
            (256, 64): (230400, 199168), (256, 128): (263168, 231936)}
    for (hd, bm), sizes in want.items():
        assert tuple(pa.prefill_smem_bytes(hd, bm, i)
                     for i in (False, True)) == sizes
    assert pa.SMEM_LIMIT == 232448
    assert pa.prefill_smem_bytes(256, 128, False) > pa.SMEM_LIMIT


@pytest.mark.parametrize("hd", pa.HEAD_DIMS)
@pytest.mark.parametrize("B,S,H,KV", [(1, 512, 16, 16), (1, 512, 96, 8),
                                      (8, 1, 96, 8), (4, 64, 32, 8),
                                      (1, 4096, 64, 8), (2, 9, 16, 16)])
def test_every_prefill_plan_fits_shared_memory(hd, B, S, H, KV):
    p = pa.plan(B, S, H, KV, hd, 16, SMS, nb=65)
    if p.path != "prefill":
        assert S * H // KV <= pa.DECODE_MAX_ROWS
        return
    for int8 in (False, True):
        assert pa.prefill_smem_bytes(hd, p.rows, int8) <= pa.SMEM_LIMIT
    if hd == 256:
        assert p.rows == 64
    assert p.blocks == -(-S * (H // KV) // p.rows) * KV * B


def test_plan_at_gemma_and_nemotron_widths():
    """gemma-7b's 512-token chunk takes BM 64 (BM 128 would not fit);
    nemotron-4-340b's decode rows (12 = n_rep) exceed T and take the
    prefill-chunk body, its 512-token chunk BM 128."""
    assert pa.plan(1, 512, 16, 16, 256, 16, SMS, nb=64).rows == 64
    dec = pa.plan(8, 1, 16, 16, 256, 16, SMS, nb=64)
    assert (dec.path, dec.rows) == ("decode", 4)
    nem = pa.plan(8, 1, 96, 8, 192, 16, SMS, nb=64)
    assert (nem.path, nem.rows) == ("prefill", 64)
    assert pa.plan(1, 512, 96, 8, 192, 16, SMS, nb=64).rows == 128


@pytest.mark.parametrize("hd", WIDE)
@pytest.mark.parametrize("S,n_rep", [(1, 1), (1, 8), (2, 4)])
def test_decode_workspace_holds_hd_plus_two_floats_a_row(hd, S, n_rep):
    """The split workspace: f32 (acc [hd], m, l) per row, per split, per
    row tile, per (lane, KV head)."""
    B, KV, bs, nb = 3, 2, 16, 65
    p = pa.plan(B, S, n_rep * KV, KV, hd, bs, SMS, nb=nb)
    assert p.path == "decode"
    tiles = -(-S * n_rep // p.rows)
    assert p.splits == -(-nb * bs // pa.DECODE_SPAN)
    assert p.workspace_bytes == B * KV * tiles * p.splits * p.rows * \
        (hd + 2) * 4
    assert p.counters == B * KV * tiles
    pa._check_decode_plan(p, B, S * n_rep, KV, hd, nb * bs)
    small = pa.Plan("decode", p.rows, p.blocks, p.splits,
                    p.workspace_bytes - 4, p.counters)
    with pytest.raises(ValueError):
        pa._check_decode_plan(small, B, S * n_rep, KV, hd, nb * bs)


@pytest.mark.parametrize("hd", WIDE)
def test_entry_points_take_the_wide_plans(hd):
    for int8 in (False, True):
        sfx = "_int8" if int8 else "_bf16"
        assert pa.entry_point(pa.plan(2, 1, 8, 2, hd, 16, SMS, nb=9),
                              int8) == "paged_attention_decode" + sfx
        assert pa.entry_point(pa.plan(2, 40, 8, 2, hd, 16, SMS, nb=9),
                              int8) == "paged_attention_prefill" + sfx


# ---------------------------------------------- head dim 80 (zamba2-2.7b)
# A narrow grid of its own: zamba2-2.7b's shared attention (H = KV, n_rep
# 1) and a GQA shape, bf16 and int8 arenas.
HD80 = 80


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("S,H,KV,window", [(1, 4, 4, None), (9, 4, 4, 24),
                                           (1, 8, 2, 24), (9, 8, 2, None)])
def test_hd80_plain_matches_paged_attention_ref(S, H, KV, window, int8):
    args = _inputs(3, S, H, KV, HD80, 16, [0, 37, 70], seed=S + H,
                   int8=int8)
    np.testing.assert_allclose(_plain(*args, window),
                               _jax(paged_attention_ref, *args, window),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H,KV", [(32, 32), (64, 16)])
def test_hd80_plain_matches_paged_attention_pallas(H, KV, int8):
    """zamba2-2.7b's 32 heads of 80 (H * hd = 2,560: no head tile) and 64
    heads (5,120: the reference walks head tiles)."""
    tile = _head_tile(H, KV, HD80)
    assert (tile is not None) == (H * HD80 >= 4096)
    args = _inputs(2, 5, H, KV, HD80, 8, [3, 20], seed=H + int8, int8=int8)
    ref = _jax(paged_attention_pallas, *args, None, interpret=True,
               head_tile=tile)
    np.testing.assert_allclose(_plain(*args, None), ref, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n_rep,window", [(1, None), (4, 24)])
def test_hd80_decode_model_matches_paged_attention_ref(n_rep, window, int8):
    """The decode body's model at hd 80 (its 20-thread column groups change
    no sum the model orders)."""
    args = _inputs(3, 1, 2 * n_rep, 2, HD80, 16, [0, 127, 301],
                   seed=80 + n_rep, int8=int8, wild=True)
    np.testing.assert_allclose(
        decode_model(*args, window),
        _jax(paged_attention_ref, *args, window), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n_rep,window,bm", [(1, None, 128), (4, 24, 64)])
def test_hd80_prefill_model_matches_paged_attention_ref(n_rep, window, bm,
                                                        int8):
    """The prefill-chunk body's model at hd 80: the body computes at the
    padded width 128, whose padding columns add nothing to the scores and
    are never stored, so its arithmetic on the 80 real columns is the
    model's."""
    args = _inputs(2, 21, 2 * n_rep, 2, HD80, 16, [5, 64], seed=80 + bm,
                   int8=int8, wild=True)
    v, vs = args[2], args[6]
    ref = _jax(paged_attention_ref, *args, window)
    exact = prefill_model(*args, window, bm=bm, round_p=False)
    np.testing.assert_allclose(exact, ref, atol=ATOL, rtol=RTOL)
    got = prefill_model(*args, window, bm=bm)
    assert np.abs(got - ref).max() <= 2.0 ** -8 * _v_max(v, vs) + ATOL + \
        RTOL * np.abs(ref).max()


def test_hd80_layouts_and_plans():
    """hd 80 is a head dim of both bodies; the prefill-chunk body's tiles
    are laid out at the padded width 128 (its q tile and bf16 tiles as at
    hd 128), int8 rows at 80 bytes, converting a tile ahead at BM 64 and
    128; zamba2-2.7b's decode step takes the decode body at R 4, its
    512-token chunk BM 128."""
    assert HD80 in pa.HEAD_DIMS
    assert [pa.padded_hd(h) for h in (64, 80, 128, 192, 256)] == \
        [64, 128, 128, 192, 256]
    want = {64: (115712, 125952), 128: (132096, 142336)}
    for bm, sizes in want.items():
        assert tuple(pa.prefill_smem_bytes(HD80, bm, i)
                     for i in (False, True)) == sizes
        assert pa.prefill_smem_bytes(HD80, bm, False) == \
            pa.prefill_smem_bytes(128, bm, False)
    dec = pa.plan(8, 1, 32, 32, HD80, 16, SMS, nb=64)
    assert (dec.path, dec.rows, dec.splits) == ("decode", 4, 8)
    assert dec.workspace_bytes == 8 * 32 * 8 * 4 * (HD80 + 2) * 4
    chunk = pa.plan(1, 512, 32, 32, HD80, 16, SMS, nb=64)
    assert (chunk.path, chunk.rows, chunk.blocks) == ("prefill", 128, 128)
    for int8 in (False, True):
        sfx = "_int8" if int8 else "_bf16"
        assert pa.entry_point(dec, int8) == "paged_attention_decode" + sfx
        assert pa.entry_point(chunk, int8) == "paged_attention_prefill" + sfx
