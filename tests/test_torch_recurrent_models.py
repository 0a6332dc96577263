"""The recurrent families of the port against the JAX package at f32, with
the JAX weights carried over by ``interchange``:

  linear_attn            ``chunked_gla`` (chunk 64 and 128, a sequence
                         shorter than the chunk, ``valid`` masks of ragged
                         real lengths, with and without the normalizer and
                         an initial state), ``masked_gates`` and
                         ``gla_decode_step``, outputs and final states
                         within 1e-5 of the largest value;
  xlstm-350m-smoke       ssm: mLSTM and sLSTM blocks;
  zamba2-2.7b-smoke      hybrid: Mamba2 blocks and the shared attention.

For each model: the parameter tree, ``forward`` and ``loss_fn`` (logits at
atol 1e-4), ``prefill`` and ``decode_lockstep`` through the model zoo (the
hybrid caches grown by ``grow_caches``), ``unified_step`` over lane rows
with padding, fresh and inactive lanes against JAX's and against
``decode_lockstep`` of the same lanes, and the set of leaves
``sparsify_for_serving`` compresses against JAX's, at the smoke widths and
(by shape alone) at the published widths.  The engines' streams are in
``test_torch_recurrent_engines.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import linear_attn as jax_la  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.models import sparse_serving as jax_ss  # noqa: E402
from repro.models import xlstm as jax_xls  # noqa: E402
from repro.models import zamba as jax_zam  # noqa: E402
from repro.serving.cache_pool import SlotPoolView as JaxSlotView  # noqa: E402
from repro.serving.state_pool import \
    HybridPoolView as JaxHybridView  # noqa: E402
from repro.serving.state_pool import \
    RecurrentStateView as JaxStateView  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import SparsifyConfig  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.models import linear_attn as la  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models import sparse_serving as ss  # noqa: E402
from repro_torch.models import xlstm as xls  # noqa: E402
from repro_torch.models import zamba as zam  # noqa: E402
from repro_torch.serving.cache_pool import SlotPoolView  # noqa: E402
from repro_torch.serving.state_pool import (HybridPoolView,  # noqa: E402
                                            RecurrentStateView, map_state,
                                            state_leaves)

ARCHS = {"ssm": "xlstm-350m", "hybrid": "zamba2-2.7b"}
MODULES = {"ssm": (jax_xls, xls), "hybrid": (jax_zam, zam)}
TOL = dict(atol=1e-4, rtol=0)
B, S, DECODE_STEPS = 2, 12, 3
SPARSE = dict(weight_pattern="8:16", outlier_pattern="16:256",
              scorer="magnitude", use_smoothquant=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread each, so several test workers on
    one machine do not oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_close(got, want, rel=1e-5):
    """max |got - want| within ``rel`` of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{err:.3e} > {rel} x {scale:.3e}"


# --------------------------------------------------------- linear_attn ---
def _gla_inputs(seed, Bn, Sn, H, dk, dv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bn, Sn, H, dk)).astype(np.float32)
    k = rng.standard_normal((Bn, Sn, H, dk)).astype(np.float32)
    v = rng.standard_normal((Bn, Sn, H, dv)).astype(np.float32)
    # log-sigmoid gates: log_f in (-inf, 0], mostly near 0
    log_f = -np.log1p(np.exp(-rng.standard_normal((Bn, Sn, H)) - 3))
    log_i = -np.log1p(np.exp(-rng.standard_normal((Bn, Sn, H))))
    return q, k, v, log_f.astype(np.float32), log_i.astype(np.float32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("normalizer", [False, True], ids=["ssd", "norm"])
@pytest.mark.parametrize("chunk,Sn", [(64, 128), (128, 256), (64, 40),
                                      (128, 64)])
def test_chunked_gla_matches_jax(chunk, Sn, normalizer, with_state):
    """Chunk 64 and 128 over whole chunks and over a sequence shorter than
    the chunk; log_i given (mLSTM) or None (Mamba2, the input gate in v)."""
    q, k, v, log_f, log_i = _gla_inputs(Sn + chunk, 2, Sn, 3, 8, 5)
    if not normalizer:
        log_i = None
    init = None
    if with_state:
        rng = np.random.default_rng(1)
        init = (rng.standard_normal((2, 3, 8, 5)).astype(np.float32),
                np.abs(rng.standard_normal((2, 3, 8))).astype(np.float32)
                if normalizer else None)
    jy, (jC, jn) = jax_la.chunked_gla(
        *_j(q, k, v, log_f, log_i), chunk=chunk, normalizer=normalizer,
        initial_state=None if init is None else tuple(_j(*init)))
    y, (C, n) = la.chunked_gla(
        *_t(q, k, v, log_f, log_i), chunk=chunk, normalizer=normalizer,
        initial_state=None if init is None else tuple(_t(*init)))
    _rel_close(y.numpy(), jy)
    _rel_close(C.numpy(), jC)
    assert (n is None) == (jn is None) == (not normalizer)
    if normalizer:
        _rel_close(n.numpy(), jn)


@pytest.mark.parametrize("normalizer", [False, True], ids=["ssd", "norm"])
@pytest.mark.parametrize("chunk", [64, 128])
def test_masked_gates_ragged_lengths_match_jax(chunk, normalizer):
    """A right-padded batch of ragged real lengths (one ending mid-chunk,
    one at a chunk edge, one empty): outputs and final states against
    JAX's, and the final state bit-identical to the real prefix alone."""
    Sn = 2 * chunk
    q, k, v, log_f, log_i = _gla_inputs(chunk, 3, Sn, 2, 8, 4)
    if not normalizer:
        log_i = None
    lens = [chunk + 21, chunk, 0]
    valid = np.arange(Sn)[None] < np.array(lens)[:, None]
    jf, ji = jax_la.masked_gates(*_j(log_f, log_i), jnp.asarray(valid))
    f, i = la.masked_gates(*_t(log_f, log_i), torch.from_numpy(valid))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    jy, (jC, jn) = jax_la.chunked_gla(*_j(q, k, v), jf, ji, chunk=chunk,
                                      normalizer=normalizer)
    y, (C, n) = la.chunked_gla(*_t(q, k, v), f, i, chunk=chunk,
                               normalizer=normalizer)
    _rel_close(y.numpy(), jy)
    _rel_close(C.numpy(), jC)
    if normalizer:
        _rel_close(n.numpy(), jn)
    assert not C[2].any()                    # the empty lane: no update
    # lane 1's real tokens fill one whole chunk: its state is that chunk's
    _, (C1, _) = la.chunked_gla(
        *_t(q[1:2, :chunk], k[1:2, :chunk], v[1:2, :chunk]),
        torch.from_numpy(log_f[1:2, :chunk]),
        None if log_i is None else torch.from_numpy(log_i[1:2, :chunk]),
        chunk=chunk, normalizer=normalizer)
    assert torch.equal(C[1:2], C1)


def test_chunked_gla_refuses_a_partial_last_chunk():
    """As the reference asserts S % min(chunk, S) == 0."""
    q, k, v, log_f, log_i = _gla_inputs(0, 1, 100, 2, 4, 4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        la.chunked_gla(*_t(q, k, v, log_f, log_i), chunk=64)


@pytest.mark.parametrize("normalizer", [False, True], ids=["ssd", "norm"])
def test_gla_decode_step_matches_jax(normalizer):
    q, k, v, log_f, log_i = _gla_inputs(5, 3, 1, 2, 8, 4)
    rng = np.random.default_rng(6)
    C = rng.standard_normal((3, 2, 8, 4)).astype(np.float32)
    n = np.abs(rng.standard_normal((3, 2, 8))).astype(np.float32)
    args = (q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
            log_i[:, 0] if normalizer else None)
    jy, (jC, jn) = jax_la.gla_decode_step(*_j(*args), tuple(_j(C, n)),
                                          normalizer)
    y, (C2, n2) = la.gla_decode_step(*_t(*args), tuple(_t(C, n)),
                                     normalizer)
    _rel_close(y.numpy(), jy)
    _rel_close(C2.numpy(), jC)
    _rel_close(n2.numpy(), jn)


# ------------------------------------------------------------ the models ---
def _cfgs(family):
    arch = ARCHS[family]
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    """family: (jcfg, cfg, JAX params, port params), drawn once a module."""
    out = {}
    for i, fam in enumerate(ARCHS):
        jcfg, cfg = _cfgs(fam)
        jparams = MODULES[fam][0].init_params(jax.random.PRNGKey(30 + i),
                                              jcfg)
        out[fam] = (jcfg, cfg, jparams, from_jax_params(jparams, "cpu"))
    return out


def _batch(cfg, seed, Sn=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, Sn))
    labels = rng.integers(0, cfg.vocab, (B, Sn))
    labels[0, :3] = -1                       # masked positions
    return tokens, labels


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("family", list(ARCHS))
def test_params_carry_across(models, family):
    """The stacked trees split per layer (xlstm's ``r_gates`` [4, H, dh,
    dh] too, zamba's f32 ``A_log``/``D``/``dt_bias``), zamba's
    ``shared_attn`` carried as one layer; the port's own init draws the
    same tree."""
    jcfg, cfg, jparams, params = models[family]
    mod = MODULES[family][1]
    stack = "layers" if family == "ssm" else "mamba"
    assert len(params[stack]) == cfg.n_layers
    for name, leaf in jparams[stack].items():
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(params[stack][i][name].numpy(),
                                          np.asarray(leaf[i]))
    if family == "ssm":
        di = 2 * cfg.d_model
        assert params["layers"][0]["r_gates"].shape == \
            (4, cfg.n_heads, di // cfg.n_heads, di // cfg.n_heads)
    else:
        assert params["mamba"][0]["A_log"].dtype == torch.float32
        assert sorted(params["shared_attn"]) == sorted(jparams["shared_attn"])
    mine = mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(mine) == _shapes(params)


@pytest.mark.parametrize("family", list(ARCHS))
def test_forward_and_loss_match_jax(models, family):
    jcfg, cfg, jparams, params = models[family]
    jmod, mod = MODULES[family]
    tokens, labels = _batch(cfg, 1)
    jlogits, _ = jmod.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    jloss, _ = jmod.loss_fn(jparams, {"tokens": jnp.asarray(tokens),
                                      "labels": jnp.asarray(labels)}, jcfg)
    with torch.no_grad():
        logits, _ = mod.forward(params, {"tokens": torch.from_numpy(tokens)},
                                cfg)
        loss, aux = mod.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                         "labels": torch.from_numpy(labels)},
                                cfg)
    assert logits.shape == (B, S, cfg.vocab) and aux == {}
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


def _state_close(got, want):
    for g, w in zip(state_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("family", list(ARCHS))
def test_prefill_and_decode_lockstep_match_jax(models, family):
    """``prefill``, ``grow_caches`` (the hybrid family's per-application
    KV), then ``decode_lockstep`` a token at a time (JAX's greedy token fed
    to both): logits, states and KV at every step."""
    jcfg, cfg, jparams, params = models[family]
    tokens, _ = _batch(cfg, 2)
    jzoo, zoo = jax_zoo.get_model(jcfg), model_zoo.get_model(cfg, "cpu")
    jlast, jc = jzoo.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        last, c = zoo.prefill(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    assert int(c["pos"]) == int(jc["pos"]) == S
    jc = jax_zoo.grow_caches(jc, S + DECODE_STEPS)
    c = model_zoo.grow_caches(c, S + DECODE_STEPS)
    for step in range(DECODE_STEPS):
        _state_close(c["states"], jc["states"])
        for kv, jkv in zip(c.get("kv", []), jc.get("kv", [])):
            assert kv[0].shape[1] == S + DECODE_STEPS
            for a, b in zip(kv, jkv):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        nxt = np.array(jnp.argmax(jlast, -1))[:, None]
        jlast, jc = jzoo.decode(jparams, jc, {"tokens": jnp.asarray(nxt)})
        with torch.no_grad():
            last, c = zoo.decode(params, c, {"tokens": torch.from_numpy(nxt)})
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
        assert int(c["pos"]) == int(jc["pos"]) == S + step + 1
    _state_close(c["states"], jc["states"])


# lanes of a chunk step: rows into a 4-slot arena (4 is padding), cursors
# (0: a fresh lane, whose stale slot content the step must not read), real
# positions of the step's 8
ROWS, CURSORS, N_NEW = [2, 0, 3, 4], [0, 5, 0, 0], [8, 3, 0, 0]


def _arena(family, cfg, rng):
    """A 4-slot state arena of random content (stale slots included)."""
    init = (xls.init_state(cfg, 4, "cpu") if family == "ssm" else
            [zam.lane_init(cfg, i, 4, "cpu") for i in range(cfg.n_layers)])
    return map_state(lambda a: torch.from_numpy(
        rng.standard_normal(a.shape).astype(np.float32)), init)


def _jax_states(states):
    return map_state(lambda a: jnp.asarray(a.numpy()), states)


@pytest.mark.parametrize("family", list(ARCHS))
def test_unified_step_matches_jax(models, family):
    """One chunk step over lane rows with a padding lane, a fresh lane at
    cursor 0 over a stale slot, a resumed lane, and an inactive one
    (n_new 0): logits of the real positions and every slot's new state
    against JAX's ``unified_step``; the inactive lane's slot and the slot
    nobody maps come back bit for bit (the hybrid's KV through a slot
    view)."""
    jcfg, cfg, jparams, params = models[family]
    jmod, mod = MODULES[family]
    rng = np.random.default_rng(4)
    states = _arena(family, cfg, rng)
    before = [a.clone() for a in state_leaves(states)]
    jstates = _jax_states(states)
    tokens = rng.integers(0, cfg.vocab, (4, 8))
    rows, cur, nn = (np.array(a, np.int32) for a in (ROWS, CURSORS, N_NEW))
    jview = JaxStateView(jstates, jnp.asarray(rows), jnp.asarray(cur),
                         jnp.asarray(nn))
    view = RecurrentStateView.build(states, rows, cur, nn)
    if family == "hybrid":
        n_attn = zam.n_applications(cfg)
        kv = rng.standard_normal((n_attn, 4, 16, cfg.n_kv_heads,
                                  cfg.hd)).astype(np.float32)
        jk = JaxSlotView(jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(rows),
                         jnp.asarray(cur), jnp.asarray(nn))
        k, v = torch.from_numpy(kv.copy()), torch.from_numpy(kv.copy())
        kview = SlotPoolView.build(k, v, rows, cur, nn, 8)
        jlogits, jkv, jnew = jmod.unified_step(
            jparams, JaxHybridView(jk, jview), {"tokens": jnp.asarray(tokens)},
            jcfg)
        with torch.no_grad():
            logits, kvs, new = mod.unified_step(
                params, HybridPoolView(kview, view),
                {"tokens": torch.from_numpy(tokens)}, cfg)
        for a, b in zip(kvs, jkv):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    else:
        jlogits, jnew = jmod.unified_step(jparams, jview,
                                          {"tokens": jnp.asarray(tokens)},
                                          jcfg)
        with torch.no_grad():
            logits, new = mod.unified_step(
                params, view, {"tokens": torch.from_numpy(tokens)}, cfg)
    for lane, n in enumerate(N_NEW):
        np.testing.assert_allclose(logits[lane, :n].numpy(),
                                   np.asarray(jlogits[lane, :n]), **TOL)
    _state_close(new, jnew)
    for a, b in zip(state_leaves(new), before):
        assert torch.equal(a[1], b[1])          # nobody's slot
    # the step wrote in place into the pool's arenas
    assert all(a is b for a, b in zip(state_leaves(new),
                                      state_leaves(states)))


@pytest.mark.parametrize("family", list(ARCHS))
def test_unified_step_chunks_equal_decode_lockstep(models, family):
    """Prefill chunks of 8 and 4 tokens through ``unified_step`` then S = 1
    steps, against ``prefill`` of the 12 tokens and ``decode_lockstep``:
    the state after the chunks and each decode token's logits (f32, two
    summation orders)."""
    jcfg, cfg, jparams, params = models[family]
    mod = MODULES[family][1]
    tokens, _ = _batch(cfg, 5)
    zoo = model_zoo.get_model(cfg, "cpu")
    n_slots, max_len = B, S + DECODE_STEPS
    states = (xls.init_state(cfg, n_slots, "cpu") if family == "ssm" else
              [zam.lane_init(cfg, i, n_slots, "cpu")
               for i in range(cfg.n_layers)])
    n_attn = zam.n_applications(cfg) if family == "hybrid" else 0
    k = torch.zeros((n_attn, n_slots, max_len, cfg.n_kv_heads, cfg.hd))
    v = torch.zeros_like(k)
    rows = np.arange(B)

    def step(toks, cur, nn, lane_rows):
        view = RecurrentStateView.build(states, lane_rows, cur, nn)
        batch = {"tokens": torch.from_numpy(toks)}
        if family == "ssm":
            return mod.unified_step(params, view, batch, cfg)
        kview = SlotPoolView.build(k, v, lane_rows, cur, nn, toks.shape[1])
        logits, _, new = mod.unified_step(
            params, HybridPoolView(kview, view), batch, cfg)
        return logits, new

    with torch.no_grad():
        for c0, c1 in ((0, 8), (8, S)):
            _, states = step(tokens[:, c0:c1], np.full(B, c0),
                             np.full(B, c1 - c0), rows)
        last, caches = zoo.prefill(params, {"tokens":
                                            torch.from_numpy(tokens)})
        caches = model_zoo.grow_caches(caches, max_len)
        for a, b in zip(state_leaves(states), state_leaves(caches["states"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        nxt = last.argmax(-1)[:, None].numpy()
        for i in range(DECODE_STEPS):
            logits, states = step(nxt, np.full(B, S + i), np.ones(B), None)
            last, caches = zoo.decode(params, caches,
                                      {"tokens": torch.from_numpy(nxt)})
            np.testing.assert_allclose(logits[:, -1].numpy(), last.numpy(),
                                       **TOL)
            nxt = last.argmax(-1)[:, None].numpy()


# ------------------------------------------------------ sparsified leaves ---
WANT_SPARSE = {
    "ssm": {"layers/w_up", "layers/w_q", "layers/w_k", "layers/w_v",
            "layers/w_down", "layers/w_slstm"},
    "hybrid": {"mamba/in_proj", "mamba/out_proj", "shared_attn/wq",
               "shared_attn/wk", "shared_attn/wv", "shared_attn/wo",
               "shared_attn/w_gate", "shared_attn/w_up",
               "shared_attn/w_down"}}


def _sparse_names(tree, prefix=""):
    """Names of the SparseWeight leaves of a JAX or port tree, the port's
    per-layer ``layers/{i}/name`` folded into the reference's stacked
    ``layers/name``."""
    out = set()
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out |= _sparse_names(v, f"{prefix}{k}/")
        elif hasattr(v, "nm_values"):
            out.add(f"{prefix}{k}")
    return {"/".join(p for p in n.split("/") if not p.isdigit())
            for n in out}


@pytest.mark.parametrize("family", list(ARCHS))
def test_sparsified_leaves_match_jax_at_smoke_width(models, family):
    """``w_gates``, ``r_gates``, ``A_log``, ``dt_bias``, ``D``, the norms,
    ``embed`` and ``lm_head`` stay dense, as in the reference."""
    jcfg, cfg, jparams, params = models[family]
    jsparse, _ = jax_ss.sparsify_for_serving(jparams,
                                             JaxSparsifyConfig(**SPARSE))
    sparse, rep = ss.sparsify_for_serving(params, SparsifyConfig(**SPARSE))
    names = _sparse_names(sparse)
    assert names == _sparse_names(jsparse) == WANT_SPARSE[family]
    n_shared = sum(n.startswith("shared_attn/") for n in names)
    assert rep["n_layers_sparsified"] == \
        (len(names) - n_shared) * cfg.n_layers + n_shared
    for name in ("embed", "lm_head"):
        assert isinstance(sparse[name], torch.Tensor)


def _leaf_decision(c):
    return None if c is None else (c.weight_pattern, c.outlier_pattern)


@pytest.mark.parametrize("family", list(ARCHS))
def test_sparsified_leaves_match_jax_at_published_width(family):
    """Each leaf's decision (dense, N:M, N:M + outliers) at the published
    shapes from shapes alone: JAX's ``_leaf_cfg`` on the stacked
    ``eval_shape`` leaves, the port's ``leaf_cfg`` on the per-layer shapes
    (meta tensors).  At full width every prunable projection keeps its
    16:256 outliers (in-dims 1,024, 2,048, 2,560, 5,120, 10,240)."""
    arch = ARCHS[family]
    jcfg = jax_configs.get(arch)
    shapes = jax.eval_shape(lambda: MODULES[family][0].init_params(
        jax.random.PRNGKey(0), jcfg))
    jscfg, scfg = JaxSparsifyConfig(**SPARSE), SparsifyConfig(**SPARSE)
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    picked = set()
    stack = "layers" if family == "ssm" else "mamba"
    for path, leaf in flat:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        want = _leaf_decision(jax_ss._leaf_cfg(name, leaf, jscfg))
        stacked = name.startswith(stack + "/")
        shape = leaf.shape[1:] if stacked else leaf.shape
        port_name = name.replace(stack + "/", stack + "/0/")
        got = _leaf_decision(ss.leaf_cfg(
            port_name, torch.empty(shape, device="meta"), scfg))
        assert got == want, name
        if got is not None:
            picked.add(name)
            assert got[1] == "16:256", name
    assert picked == WANT_SPARSE[family]
