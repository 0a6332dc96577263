"""The encdec family (Whisper) in the port against the JAX package, at f32
on whisper-medium-smoke, with the JAX weights carried over by
``interchange``:

  * ``attend_kv_length`` (cross-attention over length-masked context rows);
  * ``encode``/``decode_full`` through ``loss_fn``, ``prefill`` (logits and
    the k/v/ck/cv caches) and ``decode_lockstep`` a token at a time;
  * ``encode_ctx`` at the true encoder length;
  * ``unified_step`` over an ``EncDecPoolView`` (lanes at different
    cursors with different context lengths, one padding lane);
  * ``EncoderContextPool`` replayed op by op against JAX's (writes of
    several lengths, a context over ``max_ctx`` refused, swap round trips,
    lane lengths).

The engines' streams are in ``test_torch_moe_encdec_engines.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import random  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.models import whisper as jax_whi  # noqa: E402
from repro.serving.state_pool import \
    EncDecPoolView as JaxEncDecPoolView  # noqa: E402
from repro.serving.state_pool import \
    EncoderContextPool as JaxContextPool  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models import whisper as whi  # noqa: E402
from repro_torch.serving.cache_pool import CapacityError  # noqa: E402
from repro_torch.serving.state_pool import (EncDecPoolView,  # noqa: E402
                                            EncoderContextPool)

TOL = dict(atol=1e-4, rtol=0)
B, S, S_ENC, DECODE_STEPS = 2, 10, 7, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread each, so several test workers on
    one machine do not oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    jcfg = dataclasses.replace(jax_configs.get_smoke("whisper-medium"),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke("whisper-medium"),
                              dtype=torch.float32)
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jparams = jax_whi.init_params(jax.random.PRNGKey(50), jcfg)
    return jcfg, cfg, jparams, from_jax_params(jparams, "cpu")


def _inputs(cfg, seed, s_enc=S_ENC):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((B, s_enc, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    labels = rng.integers(0, cfg.vocab, (B, S))
    labels[1, :2] = -1
    return embeds, tokens, labels


def test_attend_kv_length_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 4, 4, 8)).astype(np.float32)
    k = rng.standard_normal((3, 9, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 9, 2, 8)).astype(np.float32)
    kv_len = np.array([9, 4, 1])
    want = jax_layers.attend_kv_length(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(kv_len))
    got = layers.attend_kv_length(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # keys past a row's length are never seen
    k2, v2 = k.copy(), v.copy()
    k2[1, 4:], v2[1, 4:] = 1e3, -1e3
    again = layers.attend_kv_length(torch.from_numpy(q), torch.from_numpy(k2),
                                    torch.from_numpy(v2),
                                    torch.from_numpy(kv_len))
    np.testing.assert_array_equal(again[1].numpy(), got[1].numpy())


def test_loss_matches_jax(model):
    jcfg, cfg, jparams, params = model
    embeds, tokens, labels = _inputs(cfg, 2)
    jloss, jaux = jax_whi.loss_fn(
        jparams, {"embeds": jnp.asarray(embeds),
                  "tokens": jnp.asarray(tokens),
                  "labels": jnp.asarray(labels)}, jcfg)
    with torch.no_grad():
        loss, aux = model_zoo.get_model(cfg, "cpu").loss(
            params, {"embeds": torch.from_numpy(embeds),
                     "tokens": torch.from_numpy(tokens),
                     "labels": torch.from_numpy(labels)})
    assert aux == {} == jaux
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


def test_prefill_and_decode_lockstep_match_jax(model):
    """``prefill`` (encoder + decoder over the prompt; logits and every
    cache), ``grow_caches`` (ck/cv stay at the encoder's length), then
    ``decode_lockstep`` a token at a time with JAX's greedy token fed to
    both."""
    jcfg, cfg, jparams, params = model
    embeds, tokens, _ = _inputs(cfg, 3)
    jzoo, zoo = jax_zoo.get_model(jcfg), model_zoo.get_model(cfg, "cpu")
    jlast, jc = jzoo.prefill(jparams, {"embeds": jnp.asarray(embeds),
                                       "tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        last, c = zoo.prefill(params, {"embeds": torch.from_numpy(embeds),
                                       "tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    for key in ("k", "v", "ck", "cv"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    assert c["ck"].shape == (cfg.n_layers, B, S_ENC, cfg.n_kv_heads, cfg.hd)
    assert int(c["pos"]) == int(jc["pos"]) == S
    jc = jax_zoo.grow_caches(jc, S + DECODE_STEPS)
    c = model_zoo.grow_caches(c, S + DECODE_STEPS)
    assert c["k"].shape[2] == S + DECODE_STEPS and c["ck"].shape[2] == S_ENC
    for step in range(DECODE_STEPS):
        nxt = np.array(jnp.argmax(jlast, -1))[:, None]
        jlast, jc = jzoo.decode(jparams, jc, {"tokens": jnp.asarray(nxt)})
        with torch.no_grad():
            last, c = zoo.decode(params, c, {"tokens": torch.from_numpy(nxt)})
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
        assert int(c["pos"]) == S + step + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


@pytest.mark.parametrize("s_enc", [1, S_ENC, 16])
def test_encode_ctx_matches_jax(model, s_enc):
    jcfg, cfg, jparams, params = model
    embeds, _, _ = _inputs(cfg, 4, s_enc)
    jck, jcv = jax_whi.encode_ctx(jparams, jnp.asarray(embeds), jcfg)
    with torch.no_grad():
        ck, cv = whi.encode_ctx(params, torch.from_numpy(embeds), cfg)
    assert ck.shape == (cfg.n_layers, B, s_enc, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jck), **TOL)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), **TOL)


@pytest.mark.parametrize("decode", [False, True])
def test_unified_step_matches_jax(model, decode):
    """A chunk over lanes at cursors 0 and 5 with context lengths 3 and 8
    and a padding lane (``rows`` past the arena, context 0), or the fused
    decode over every slot (``rows`` None): logits of the real positions
    and the self-attention arenas; the context arenas are only read."""
    jcfg, cfg, jparams, params = model
    n_slots, max_len, max_ctx = 3, 16, 8
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, n_slots, max_len, cfg.n_kv_heads, cfg.hd)
    cshape = (cfg.n_layers, n_slots, max_ctx, cfg.n_kv_heads, cfg.hd)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    ck, cv = (rng.standard_normal(cshape).astype(np.float32) for _ in "kv")
    if decode:
        rows, cur, n_new = None, np.array([3, 9, 0]), np.ones(3, np.int64)
        ctx, Sc = np.array([8, 2, 5]), 1
    else:
        rows, cur, n_new = np.array([1, 2, n_slots]), np.array([0, 5, 0]), \
            np.array([4, 3, 0])
        ctx, Sc = np.array([3, 8, 0]), 4
    tokens = rng.integers(0, cfg.vocab, (3, Sc))
    jview = JaxEncDecPoolView(
        k=jnp.asarray(k0), v=jnp.asarray(v0),
        rows=None if rows is None else jnp.asarray(rows, jnp.int32),
        cursor=jnp.asarray(cur, jnp.int32),
        n_new=jnp.asarray(n_new, jnp.int32), ck=jnp.asarray(ck),
        cv=jnp.asarray(cv), ctx_len=jnp.asarray(ctx, jnp.int32))
    jlogits, (jk, jv) = jax_whi.unified_step(
        jparams, jview, {"tokens": jnp.asarray(tokens)}, jcfg)
    ck_t, cv_t = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    view = EncDecPoolView.build(torch.from_numpy(k0.copy()),
                                torch.from_numpy(v0.copy()), rows, cur,
                                n_new, Sc, ck=ck_t, cv=cv_t, ctx_len=ctx)
    with torch.no_grad():
        logits, (k, v) = whi.unified_step(
            params, view, {"tokens": torch.from_numpy(tokens)}, cfg)
    for lane in range(3):
        n = int(n_new[lane])
        np.testing.assert_allclose(logits[lane, :n].numpy(),
                                   np.asarray(jlogits)[lane, :n], **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(ck_t.numpy(), ck)
    np.testing.assert_array_equal(cv_t.numpy(), cv)


@pytest.mark.parametrize("seed", range(4))
def test_context_pool_replayed_against_jax(seed):
    """A random walk of writes (lengths up to and past ``max_ctx``), swap
    saves and restores and lane-length queries, on the port's pool and
    JAX's: the arenas, lengths and answers stay equal; a context past
    ``max_ctx`` raises ``CapacityError`` and changes nothing."""
    from repro.serving.cache_pool import CapacityError as JaxCapacityError
    jcfg, cfg = _cfgs()
    n_slots, max_ctx = 3, 6
    pool = EncoderContextPool(cfg, n_slots, max_ctx, "cpu")
    jpool = JaxContextPool(jcfg, n_slots, max_ctx)
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    saved = {}
    for _ in range(24):
        op = rng.choice(["write", "write", "save", "restore", "lens"])
        slot = rng.randrange(n_slots)
        if op == "write":
            n = rng.randint(1, max_ctx + 1)
            shape = (cfg.n_layers, n, cfg.n_kv_heads, cfg.hd)
            ck = nrng.standard_normal(shape).astype(np.float32)
            cv = nrng.standard_normal(shape).astype(np.float32)
            if n > max_ctx:
                with pytest.raises(CapacityError, match="max_ctx"):
                    pool.write(slot, torch.from_numpy(ck),
                               torch.from_numpy(cv))
                with pytest.raises(JaxCapacityError):
                    jpool.write(slot, jnp.asarray(ck), jnp.asarray(cv))
            else:
                pool.write(slot, torch.from_numpy(ck), torch.from_numpy(cv))
                jpool.write(slot, jnp.asarray(ck), jnp.asarray(cv))
        elif op == "save":
            saved[slot] = (pool.save_slot(slot), jpool.save_slot(slot))
        elif op == "restore" and slot in saved:
            blob, jblob = saved[slot]
            pool.restore_slot(slot, blob)
            jpool.restore_slot(slot, jblob)
            assert pool.lens[slot] == blob[2]
        elif op == "lens":
            rows = rng.sample(range(n_slots), rng.randint(1, n_slots))
            padded = len(rows) + rng.randint(0, 2)
            assert pool.lane_lens(rows, padded).tolist() == \
                jpool.lane_lens(rows, padded).tolist()
        np.testing.assert_array_equal(pool.ck.numpy(), np.asarray(jpool.ck))
        np.testing.assert_array_equal(pool.cv.numpy(), np.asarray(jpool.cv))
        assert pool.lens.tolist() == jpool.lens.tolist()
