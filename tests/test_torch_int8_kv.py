"""The port's int8 KV path against the JAX package's, on the CPU at f32.

- ``quantize_kv`` gives the bytes and scales of JAX's, all-zero rows
  (scale 1) and exact .5 ties (half to even) included.
- The pools' stats surfaces (``SlotKVPool.stats``, ``PagedKVPool.stats``
  with ``BlockPool.occupancy``, ``engine.stats()["pool"]``) report the same
  keys and byte counts as JAX's, scales billed in ``arena_bytes`` and
  ``scale_bytes``, for bf16 and int8 arenas on both layouts.
- Slot and paged pools replayed op by op under int8: chunk writes with
  padding lanes, decode writes, copy-on-write and release leave arenas and
  scales bit-identical to JAX's.  On the paged layout the trash block is
  left out of the comparison: JAX routes padding writes there, the port
  drops them (ROADMAP A5).
- Attention with scales: ``attend_length_masked`` and
  ``paged_attention.plain`` against JAX ``attend_length_masked``,
  ``paged_attention_ref`` and ``paged_attention_pallas`` in interpret mode
  (untiled and head-tiled), at 1e-5 on shuffled, shared, trash-padded
  tables.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models.layers import \
    attend_length_masked as jax_attend  # noqa: E402
from repro.serving.cache_pool import SlotKVPool as JaxSlotKVPool  # noqa: E402
from repro.serving.cache_pool import SlotPoolView as JaxSlotPoolView  # noqa: E402
from repro.serving.cache_pool import quantize_kv as jax_quantize_kv  # noqa: E402
from repro.serving.paged import PagedKVPool as JaxPagedKVPool  # noqa: E402
from repro.serving.paged import PagedPoolView as JaxPagedPoolView  # noqa: E402
from repro.serving.paged.paged_attention import \
    paged_attention_pallas  # noqa: E402
from repro.serving.paged.paged_attention import \
    paged_attention_ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import paged_pool_from_jax  # noqa: E402
from repro_torch.models.layers import attend_length_masked  # noqa: E402
from repro_torch.serving.cache_pool import (SlotKVPool,  # noqa: E402
                                            SlotPoolView, quantize_kv)
from repro_torch.serving.paged import PagedKVPool, PagedPoolView  # noqa: E402
from repro_torch.serving.paged import paged_attention as pa  # noqa: E402

SHAPE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
             d_ff=64, vocab=64)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-int8-kv", remat=False,
                           dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-int8-kv", dtype=torch.float32, **SHAPE)
KV, HD = SHAPE["n_kv_heads"], SHAPE["head_dim"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _fresh(rng, shape, zero_rows=True):
    """Fresh KV [..., KV, hd]: random, with all-zero rows and rows holding
    exact .5 ties (absmax 127, so scale 1 and x / scale = x exactly)."""
    x = rng.standard_normal(shape).astype(np.float32) * 3
    flat = x.reshape(-1, shape[-1])
    if zero_rows:
        flat[::7] = 0.0
    ties = np.resize(np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5,
                               -126.5], np.float32), shape[-1])
    flat[3::11] = ties
    return x


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------ quantize_kv
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical_to_jax(dtype):
    x = _fresh(np.random.default_rng(0), (3, 9, KV, 16))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jq, js = jax_quantize_kv(jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    q, s = quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    flat_q, flat_s = q.reshape(-1, 16), s.reshape(-1)
    assert (flat_s[[0, 7]] == 1.0).all() and not flat_q[[0, 7]].any()
    assert flat_s[3] == 1.0                     # absmax 127: x / scale = x
    assert flat_q[3].tolist()[:8] == [127, 2, -4, 0, 0, 2, 126, -126]


# ------------------------------------------------------------ stats surface
def _pools(layout, kv_dtype):
    if layout == "slot":
        return (JaxSlotKVPool(JCFG, 3, 24, kv_dtype=kv_dtype),
                SlotKVPool(CFG, 3, 24, "cpu", kv_dtype=kv_dtype))
    kw = dict(block_size=4, n_blocks=11, kv_dtype=kv_dtype)
    return (JaxPagedKVPool(JCFG, 3, 24, **kw),
            PagedKVPool(CFG, 3, 24, device="cpu", **kw))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_pool_stats_match_reference(layout, kv_dtype):
    jpool, tpool = _pools(layout, kv_dtype)
    jst, tst = jpool.stats(), tpool.stats()
    assert tst == jst
    assert tst["kv_dtype"] == kv_dtype
    L, ns = CFG.n_layers, 3
    positions = L * (ns * 24 if layout == "slot" else 12 * 4) * KV
    scale_bytes = 2 * positions * 4 if kv_dtype == "int8" else 0
    value_bytes = 2 * positions * HD * (1 if kv_dtype == "int8" else 4)
    assert tst["scale_bytes"] == scale_bytes
    assert tst["arena_bytes"] == value_bytes + scale_bytes
    if layout == "paged":
        assert tpool.blocks.occupancy() == jpool.blocks.occupancy()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_engine_pool_stats_match_reference(layout, kv_dtype):
    from repro.models import transformer as jax_tfm
    from repro.serving import ServingEngine as JaxServingEngine
    from repro_torch.interchange import from_jax_params
    from repro_torch.serving import ServingEngine
    import jax
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    kw = dict(n_slots=2, max_len=32, kv_layout=layout, block_size=8,
              kv_dtype=kv_dtype)
    jst = JaxServingEngine(JCFG, jparams, **kw).stats()
    tst = ServingEngine(CFG, from_jax_params(jparams, device="cpu"),
                        device="cpu", **kw).stats()
    assert tst["kv_dtype"] == jst["kv_dtype"] == kv_dtype
    assert tst["pool"] == jst["pool"]


# ------------------------------------------------------------ slot replay
def _assert_slot_same(jarenas, tarenas):
    for j, t in zip(jarenas, tarenas):
        np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_slot_pool_replay_matches_jax():
    """Chunk writes (padding lanes, n_new < S), then fused decode writes
    over every slot, quantized on scatter by both packages."""
    rng = np.random.default_rng(1)
    jpool = JaxSlotKVPool(JCFG, 4, 24, kv_dtype="int8")
    tpool = SlotKVPool(CFG, 4, 24, "cpu", kv_dtype="int8")
    j = [jpool.k, jpool.v, jpool.k_scale, jpool.v_scale]
    t = [tpool.k, tpool.v, tpool.k_scale, tpool.v_scale]
    _assert_slot_same(j, t)
    steps = [([1, 3, 4], [0, 0, 0], [8, 5, 0], 8),     # lane 2: padding
             ([0, 1], [0, 8], [6, 8], 8),
             ([3, 2], [5, 0], [8, 3], 8),
             (None, [6, 16, 3, 13], [1, 1, 1, 1], 1),   # fused decode
             (None, [7, 17, 4, 14], [1, 1, 1, 1], 1),
             ([1], [18], [6], 8)]                       # ends at max_len
    for rows, cursor, n_new, S in steps:
        B = len(cursor)
        fk = _fresh(rng, (CFG.n_layers, B, S, KV, HD))
        fv = _fresh(rng, (CFG.n_layers, B, S, KV, HD))
        jview = JaxSlotPoolView(
            k=None, v=None,
            rows=None if rows is None else jnp.asarray(rows, jnp.int32),
            cursor=jnp.asarray(cursor, jnp.int32),
            n_new=jnp.asarray(n_new, jnp.int32))
        tview = SlotPoolView.build(t[0], t[1], rows, cursor, n_new, S,
                                   k_scale=t[2], v_scale=t[3])
        for i in range(CFG.n_layers):
            out = jview.write_layer_quantized(
                j[0][i], j[1][i], j[2][i], j[3][i], jnp.asarray(fk[i]),
                jnp.asarray(fv[i]))
            for a, o in enumerate(out):
                j[a] = j[a].at[i].set(o)
            tview.write_layer_quantized(
                t[0][i], t[1][i], t[2][i], t[3][i], torch.from_numpy(fk[i]),
                torch.from_numpy(fv[i]))
        _assert_slot_same(j, t)
    assert (t[2] != 1.0).any() and (t[2] == 1.0).any()


# ------------------------------------------------------------ paged replay
def _assert_paged_same(jp, tp):
    keep = np.arange(tp.blocks.n_blocks) != tp.trash_block
    for ja, ta in ((jp.k, tp.k), (jp.v, tp.v), (jp.k_scale, tp.k_scale),
                   (jp.v_scale, tp.v_scale)):
        np.testing.assert_array_equal(_np(ta)[:, keep], np.asarray(ja)[:, keep])
    np.testing.assert_array_equal(tp.blocks.ref, np.asarray(jp.blocks.ref))
    assert tp.blocks._free == list(jp.blocks._free)
    np.testing.assert_array_equal(tp.host_tables, jp._bt_np)
    np.testing.assert_array_equal(tp.pos, jp._pos_np)


def _paged_write(jp, tp, rows, cursor, n_new, S, rng):
    """One step's quantized writes through both pools' views; ``rows`` are
    real rows, padded with one trash-table lane."""
    B = len(rows) + 1
    tables = tp.lane_tables(rows, B)
    cursor, n_new = list(cursor) + [0], list(n_new) + [0]
    fk = _fresh(rng, (CFG.n_layers, B, S, KV, HD))
    fv = _fresh(rng, (CFG.n_layers, B, S, KV, HD))
    jview = JaxPagedPoolView(
        None, None, jnp.asarray(tables), jnp.asarray(cursor, jnp.int32),
        jnp.asarray(n_new, jnp.int32), jp.trash_block)
    tview = PagedPoolView.build(tp.k, tp.v, tables, cursor, n_new, S,
                                trash=tp.trash_block, k_scale=tp.k_scale,
                                v_scale=tp.v_scale)
    jb = jp.blocks
    for i in range(CFG.n_layers):
        out = jview.write_layer_quantized(
            jb.k[i], jb.v[i], jb.k_scale[i], jb.v_scale[i],
            jnp.asarray(fk[i]), jnp.asarray(fv[i]))
        jb.k, jb.v, jb.k_scale, jb.v_scale = (
            a.at[i].set(o) for a, o in
            zip((jb.k, jb.v, jb.k_scale, jb.v_scale), out))
        tview.write_layer_quantized(
            tp.k[i], tp.v[i], tp.k_scale[i], tp.v_scale[i],
            torch.from_numpy(fk[i]), torch.from_numpy(fv[i]))


def test_paged_pool_replay_matches_jax():
    """Admission with a prefix hit, chunked prefill writes, decode writes
    after ``prepare_decode`` (a copy on write of a shared block), fork,
    release: arenas and scales bit-identical outside the trash block."""
    rng = np.random.default_rng(2)
    kw = dict(block_size=4, n_blocks=14, kv_dtype="int8")
    jp = JaxPagedKVPool(JCFG, 4, 24, **kw)
    tp = paged_pool_from_jax(jp, CFG, device="cpu")
    _assert_paged_same(jp, tp)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    for pool in (jp, tp):
        row, n_cached = pool.admit(prompt)
        assert (row, n_cached) == (0, 0)
    _paged_write(jp, tp, [0], [0], [10], 16, rng)
    for pool in (jp, tp):
        pool.advance_prefill([0], [10])
        pool.register_prefix(0, prompt)
    _assert_paged_same(jp, tp)
    # a second request shares both full blocks and recomputes its tail
    second = prompt[:8] + [11, 12, 13]
    assert jp.admit(second, alloc_tokens=8) == tp.admit(second,
                                                        alloc_tokens=8)
    for pool in (jp, tp):
        pool.ensure_capacity(1, len(second))
    _paged_write(jp, tp, [1], [8], [3], 8, rng)
    for pool in (jp, tp):
        pool.advance_prefill([1], [11])
    _assert_paged_same(jp, tp)
    # fork row 0: its last block is shared, so the decode copies it on
    # write, scales included
    assert jp.fork(0) == tp.fork(0) == 2
    shared = tp.tables[0].blocks[-1]
    for pool in (jp, tp):
        pool.prepare_decode([0, 1, 2])
    fresh = tp.tables[0].blocks[-1]
    assert fresh != shared and tp.tables[2].blocks[-1] == shared
    for arena in (tp.k_scale, tp.v_scale, tp.k, tp.v):
        torch.testing.assert_close(arena[:, fresh], arena[:, shared],
                                   rtol=0, atol=0)
    _assert_paged_same(jp, tp)
    for step in range(3):
        pos = [int(tp.pos[r]) for r in (0, 1, 2)]
        for pool in (jp, tp):
            pool.prepare_decode([0, 1, 2])
        _paged_write(jp, tp, [0, 1, 2], pos, [1, 1, 1], 1, rng)
        for pool in (jp, tp):
            pool.advance_decode(np.arange(4) < 3)
        _assert_paged_same(jp, tp)
    for row in (1, 0, 2):
        jp.release(row)
        tp.release(row)
        _assert_paged_same(jp, tp)


def test_copy_on_write_copies_scales_every_layer():
    rng = np.random.default_rng(3)
    jp = JaxPagedKVPool(JCFG, 2, 16, block_size=4, n_blocks=6,
                        kv_dtype="int8")
    for name in ("k_scale", "v_scale"):
        setattr(jp.blocks, name, jnp.asarray(
            rng.random(getattr(jp.blocks, name).shape, np.float32) + 0.5))
    tp = paged_pool_from_jax(jp, CFG, device="cpu")
    src = jp.blocks.alloc()
    assert tp.blocks.alloc() == src
    j_dst = jp.blocks.copy_on_write(src)
    t_dst = tp.blocks.copy_on_write(src)
    assert j_dst == t_dst != src
    for j, t in ((jp.blocks.k_scale, tp.blocks.k_scale),
                 (jp.blocks.v_scale, tp.blocks.v_scale)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        torch.testing.assert_close(t[:, t_dst], t[:, src], rtol=0, atol=0)


# ------------------------------------------------------------ attention
H, BS, N_BLOCKS = 8, 4, 12
TABLES = np.array([[3, 7, 1, 9, 0],
                   [3, 7, 5, 0, 0],
                   [0, 0, 0, 0, 0],
                   [2, 11, 6, 8, 10]], np.int32)
CURSORS = np.array([8, 6, 0, 13], np.int32)
KVA = 4                                        # n_rep 2 with H 8


def _int8_arenas(seed):
    rng = np.random.default_rng(seed)
    k = _fresh(rng, (N_BLOCKS, BS, KVA, 16))
    v = _fresh(rng, (N_BLOCKS, BS, KVA, 16))
    (k8, ks), (v8, vs) = jax_quantize_kv(jnp.asarray(k)), \
        jax_quantize_kv(jnp.asarray(v))
    return [np.asarray(a) for a in (k8, v8, ks, vs)]


def test_attend_length_masked_with_scales_matches_jax():
    rng = np.random.default_rng(4)
    B, S, T = 3, 5, 24
    q = rng.standard_normal((B, S, H, 16)).astype(np.float32)
    (k8, ks), (v8, vs) = (jax_quantize_kv(jnp.asarray(
        rng.standard_normal((B, T, KVA, 16)).astype(np.float32)))
        for _ in range(2))
    off = np.array([0, 7, 19], np.int32)
    for window in (None, 6):
        ref = jax_attend(jnp.asarray(q), k8, v8, jnp.asarray(off),
                         window=window, k_scale=ks, v_scale=vs)
        out = attend_length_masked(
            torch.from_numpy(q), torch.from_numpy(np.array(k8)),
            torch.from_numpy(np.array(v8)), torch.from_numpy(off),
            window=window, k_scale=torch.from_numpy(np.array(ks)),
            v_scale=torch.from_numpy(np.array(vs)))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _port_paged(q, arenas, window):
    k8, v8, ks, vs = (torch.from_numpy(np.array(a)) for a in arenas)
    before = (pa.launches, pa.launches_int8)
    out = pa.paged_attention(torch.from_numpy(q), k8, v8,
                             torch.from_numpy(TABLES),
                             torch.from_numpy(CURSORS), window=window,
                             k_scale=ks, v_scale=vs)
    assert (pa.launches, pa.launches_int8) == before   # CPU: plain version
    return out.numpy()


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("S", [1, 5])
def test_paged_plain_with_scales_matches_ref(S, window):
    arenas = _int8_arenas(S)
    q = np.random.default_rng(10 + S).standard_normal(
        (len(CURSORS), S, H, 16)).astype(np.float32)
    ref = paged_attention_ref(jnp.asarray(q), *map(jnp.asarray, arenas[:2]),
                              jnp.asarray(TABLES), jnp.asarray(CURSORS),
                              window=window, k_scale=jnp.asarray(arenas[2]),
                              v_scale=jnp.asarray(arenas[3]))
    np.testing.assert_allclose(_port_paged(q, arenas, window),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("head_tile", [None, 1, 2])
@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("S", [1, 5])
def test_paged_plain_with_scales_matches_pallas(S, window, head_tile):
    arenas = _int8_arenas(20 + S)
    q = np.random.default_rng(30 + S).standard_normal(
        (len(CURSORS), S, H, 16)).astype(np.float32)
    ref = paged_attention_pallas(
        jnp.asarray(q), *map(jnp.asarray, arenas[:2]), jnp.asarray(TABLES),
        jnp.asarray(CURSORS), window=window, interpret=True,
        head_tile=head_tile, k_scale=jnp.asarray(arenas[2]),
        v_scale=jnp.asarray(arenas[3]))
    np.testing.assert_allclose(_port_paged(q, arenas, window),
                               np.asarray(ref), **TOL)
