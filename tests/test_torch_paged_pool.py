"""The port's paged pool against the JAX package's, operation by operation.

A seeded random walk in the manner of ``tests/test_paged_properties.py``
replays the same operations on a JAX ``PagedKVPool`` and on the port's:
admission with prefix hits (whole-sequence and chunk-aware with
``ensure_capacity``), multi-token ``prepare_decode``, ``register_prefix``,
``fork``, ``release``, and LRU eviction, with copy-on-write wherever a write
range or a recomputed tail is shared.  The port's pool starts from the JAX
pool's state, random arenas included, carried across by
``interchange.paged_pool_from_jax``.  After every operation both pools hold
identical block ids, refcounts, free lists, tables, positions and
``n_cached_idle``, the same prefix-cache entries and stats, raise the same
``OutOfBlocks``, and hold bit-identical arenas (copy-on-write moves whole
blocks across every layer).

Also pinned: the batch-wide decode writes only the decoding rows, never a
block shared through the prefix cache, and never the trash block."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import random  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.serving.cache_pool import CapacityError as JaxCapacityError  # noqa: E402
from repro.serving.paged import OutOfBlocks as JaxOutOfBlocks  # noqa: E402
from repro.serving.paged import PagedKVPool as JaxPagedKVPool  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import paged_pool_from_jax  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.cache_pool import CapacityError  # noqa: E402
from repro_torch.serving.families import TransformerAdapter  # noqa: E402
from repro_torch.serving.paged import OutOfBlocks, PagedKVPool  # noqa: E402

SHAPE = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=8,
             d_ff=64, vocab=64)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-paged-pool", remat=False,
                           dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-paged-pool", dtype=torch.float32,
                          **SHAPE)
BS = 4
POOL = dict(n_rows=4, max_len=6 * BS, block_size=BS, n_blocks=9)


def _assert_same(jp: JaxPagedKVPool, tp: PagedKVPool) -> None:
    jb, tb = jp.blocks, tp.blocks
    np.testing.assert_array_equal(tb.ref, np.asarray(jb.ref))
    assert tb._free == list(jb._free)
    np.testing.assert_array_equal(tb._cached, np.asarray(jb._cached))
    assert tb.n_cached_idle == jb.n_cached_idle
    assert tp.trash_block == jp.trash_block
    assert [None if t is None else (t.blocks, t.n_cached_tokens)
            for t in tp.tables] == \
        [None if t is None else (t.blocks, t.n_cached_tokens)
         for t in jp.tables]
    np.testing.assert_array_equal(tp.host_tables, jp._bt_np)
    np.testing.assert_array_equal(tp.pos, jp._pos_np)
    assert tp._free_rows == jp._free_rows
    assert tp.free_blocks == jp.free_blocks
    jc, tc = jp.prefix_cache, tp.prefix_cache
    assert (jc is None) == (tc is None)
    if jc is not None:
        assert list(tc._entries.items()) == list(jc._entries.items())
        assert tc.stats() == jc.stats()
    np.testing.assert_array_equal(tp.k.numpy(), np.asarray(jp.k))
    np.testing.assert_array_equal(tp.v.numpy(), np.asarray(jp.v))
    # the device tables are the host tables, uploaded
    np.testing.assert_array_equal(tp.block_tables.numpy(), jp._bt_np)


def _both(jfn, tfn):
    """Run one operation on both pools; both must succeed or both raise
    the same kind of error.  Returns (jax result, port result) or None."""
    try:
        jres = jfn()
    except (JaxOutOfBlocks, JaxCapacityError) as e:
        kind = OutOfBlocks if isinstance(e, JaxOutOfBlocks) else CapacityError
        with pytest.raises(kind):
            tfn()
        return None
    return jres, tfn()


def _pools(seed, prefix_caching=True):
    """A JAX pool with random arenas and some history, and the port's pool
    carried across from it."""
    rng = np.random.default_rng(seed)
    jp = JaxPagedKVPool(JCFG, prefix_caching=prefix_caching, **POOL)
    jp.blocks.k = jnp.asarray(rng.standard_normal(jp.k.shape), jnp.float32)
    jp.blocks.v = jnp.asarray(rng.standard_normal(jp.v.shape), jnp.float32)
    toks = [int(t) for t in rng.integers(0, 2, 2 * BS + 1)]
    row, _ = jp.admit(toks)
    jp._pos_np[row] = len(toks)
    jp.register_prefix(row, toks)
    return jp, paged_pool_from_jax(jp, CFG, device="cpu"), {row: toks}


@pytest.mark.parametrize("seed", range(8))
def test_lifecycle_replay_matches_jax(seed):
    rng = random.Random(seed)
    jp, tp, active = _pools(seed, prefix_caching=seed % 4 != 3)
    _assert_same(jp, tp)
    for _ in range(40):
        op = rng.choice(("admit", "admit", "admit_chunked", "release",
                         "evict", "decode", "decode", "fork", "register"))
        if op in ("admit", "admit_chunked"):
            # a tiny alphabet makes identical prefixes (cache hits) common
            toks = [rng.randint(0, 1) for _ in
                    range(rng.randint(1, tp.max_request_tokens))]
            if jp.can_admit(len(toks)) != tp.can_admit(len(toks)):
                pytest.fail("can_admit disagrees")
            if not tp.can_admit(len(toks)):
                continue
            alloc = None if op == "admit" else 0
            res = _both(lambda: jp.admit(toks, alloc_tokens=alloc),
                        lambda: tp.admit(toks, alloc_tokens=alloc))
            if res is not None:
                assert res[0] == res[1]
                row, n_cached = res[1]
                assert 0 <= n_cached < len(toks)
                if op == "admit_chunked":
                    end = min(len(toks), n_cached + rng.randint(1, 2 * BS))
                    _both(lambda: jp.ensure_capacity(row, end),
                          lambda: tp.ensure_capacity(row, end))
                    _assert_same(jp, tp)
                    _both(lambda: jp.ensure_capacity(row, len(toks)),
                          lambda: tp.ensure_capacity(row, len(toks)))
                if jp.tables[row].capacity >= len(toks):
                    jp._pos_np[row] = len(toks)
                    tp.advance_prefill([row], [len(toks)])
                    active[row] = toks
                else:                             # could not grow: give up
                    jp.release(row)
                    tp.release(row)
        elif op == "release" and active:
            row = rng.choice(sorted(active))
            jp.release(row)
            tp.release(row)
            del active[row]
        elif op == "evict" and tp.prefix_cache is not None:
            assert jp.prefix_cache.evict_one() == tp.prefix_cache.evict_one()
        elif op == "decode" and active:
            row = rng.choice(sorted(active))
            n = rng.choice((1, 1, rng.randint(2, BS + 1)))
            if int(tp.pos[row]) + n <= tp.max_request_tokens:
                if _both(lambda: jp.prepare_decode([row], [n]),
                         lambda: tp.prepare_decode([row], [n])) is not None:
                    jp._pos_np[row] += n
                    mask = np.arange(tp.n_rows) == row
                    for _ in range(n):
                        tp.advance_decode(mask)
                    pos = int(tp.pos[row])
                    for bi in range((pos - n) // BS, (pos - 1) // BS + 1):
                        assert tp.blocks.ref[tp.tables[row].blocks[bi]] == 1
        elif op == "register" and active:
            row = rng.choice(sorted(active))
            toks = active[row][:rng.randint(0, len(active[row]))]
            jp.register_prefix(row, toks)
            tp.register_prefix(row, toks)
        elif op == "fork" and active:
            row = rng.choice(sorted(active))
            res = _both(lambda: jp.fork(row), lambda: tp.fork(row))
            if res is not None:
                assert res[0] == res[1]
                active[res[1]] = list(active[row])
        _assert_same(jp, tp)
        assert jp.prefix_match_length(active.get(0, [0])) == \
            tp.prefix_match_length(active.get(0, [0]))
    for row in sorted(active):                    # drain; nothing may leak
        jp.release(row)
        tp.release(row)
        _assert_same(jp, tp)
    while tp.prefix_cache is not None and tp.prefix_cache.evict_one():
        assert jp.prefix_cache.evict_one()
        _assert_same(jp, tp)
    assert tp.blocks.n_free == tp.n_blocks        # all but the trash block
    jp.reset_stats()
    tp.reset_stats()
    _assert_same(jp, tp)


def test_copy_on_write_copies_every_layer():
    jp, tp, _ = _pools(20)
    src = tp.tables[0].blocks[0]                  # held by row 0 and cache
    assert tp.blocks.ref[src] == 2
    j_dst = jp.blocks.copy_on_write(src)
    t_dst = tp.blocks.copy_on_write(src)
    assert j_dst == t_dst and t_dst != src
    for arena in (tp.k, tp.v):
        torch.testing.assert_close(arena[:, t_dst], arena[:, src],
                                   atol=0, rtol=0)
    _assert_same(jp, tp)


def test_decode_writes_only_decoding_rows_into_private_blocks():
    """Row 0 decodes; row 1 is mid-prefill and shares row 0's cached
    prefix blocks; rows 2 and 3 are free.  One fused decode step may change
    only row 0's position in its (private) block: not the shared blocks,
    not row 1's blocks, not the trash block."""
    torch.manual_seed(0)
    params = tfm.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    adapter = TransformerAdapter(CFG, params, n_slots=4, max_len=6 * BS,
                                 device=torch.device("cpu"),
                                 kv_layout="paged", block_size=BS,
                                 n_blocks=12)
    pool = adapter.pool
    prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13]          # 2 full blocks + 1
    row0, _ = pool.admit(prompt)
    adapter.step_chunk(pool.lane_tables([row0], 1), [0], [len(prompt)],
                       np.array([prompt + [0] * 7]))
    pool.advance_prefill([row0], [len(prompt)])
    pool.register_prefix(row0, prompt)
    row1, n_cached = pool.admit(prompt[:8] + [1, 2, 3, 4, 5],
                                alloc_tokens=8)
    assert n_cached == 8 and pool.tables[row1].blocks[:2] == \
        pool.tables[row0].blocks[:2]
    pool.advance_prefill([row1], [8])             # mid-prefill at cursor 8
    pool.prepare_decode([row0])
    before_k, before_v = pool.k.clone(), pool.v.clone()
    tokens = np.zeros((4, 1), np.int64)
    adapter.step_decode(tokens, [row0])
    changed = ((pool.k != before_k) | (pool.v != before_v)).any(
        dim=(0, 3, 4))                            # [n_blocks, bs]
    blk, off = divmod(len(prompt), BS)
    expect = torch.zeros_like(changed)
    expect[pool.tables[row0].blocks[blk], off] = True
    assert torch.equal(changed, expect)
    assert not pool.k[:, pool.trash_block].any()
