"""The moe family in the port against the JAX package, at f32 on the smoke
twins (mixtral-8x7b-smoke: top-2 of 4 experts; llama4-maverick-400b-a17b-
smoke: top-1 of 8 plus a shared expert), with the JAX weights carried over
by ``interchange``:

  * ``moe_apply`` against JAX's ``moe_apply`` at rtol 1e-5 and against a
    per-token computation of the routed experts; ``route`` against JAX's
    top-k; ``aux_load_balance_loss``;
  * the transformer with a moe FFN: ``forward``, ``loss_fn`` (the
    0.01 x load-balance term included), ``prefill`` and ``decode_lockstep``
    and one ``unified_step`` chunk over a slot view;
  * the leaves ``sparsify_for_serving`` compresses, per family, against
    JAX's, at the smoke widths and (by shape alone) at the published
    widths of mixtral-8x7b, llama4-maverick-400b-a17b and whisper-medium:
    the routed experts ``we_*`` and the router stay dense, ``ws_*`` and
    the cross-attention's ``c_*`` compress.

The engines' streams are in ``test_torch_moe_encdec_engines.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import sparse_serving as jax_ss  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models import whisper as jax_whi  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import SparsifyConfig  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import sparse_serving as ss  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import whisper as whi  # noqa: E402
from repro_torch.serving.cache_pool import SlotPoolView  # noqa: E402

ARCHS = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]
TOL = dict(atol=1e-4, rtol=0)
MOE_TOL = dict(rtol=1e-5, atol=1e-6)
B, S, DECODE_STEPS, T = 2, 12, 3, 24
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


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    """arch: (jcfg, cfg, JAX params, port params), drawn once a module."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, cfg = _cfgs(arch)
        jparams = jax_tfm.init_params(jax.random.PRNGKey(20 + i), jcfg)
        out[arch] = (jcfg, cfg, jparams, from_jax_params(jparams, "cpu"))
    return out


def _x(cfg, seed, n=T):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.d_model)).astype(np.float32)


def _moe_pair(models, arch):
    jcfg, cfg, jparams, params = models[arch]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    return jcfg, cfg, jp, params["layers"][0]["moe"]


# ------------------------------------------------------------ the MoE FFN
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_carry_across(models, arch):
    """[L, E, in, out] stacked experts become per-layer [E, in, out]; the
    router stays f32 [E, d]; the port's own init draws the same tree."""
    _, cfg, jparams, params = models[arch]
    m = cfg.moe
    p = params["layers"][1]["moe"]
    assert p["we_gate"].shape == (m.num_experts, cfg.d_model, m.d_ff_expert)
    assert p["we_down"].shape == (m.num_experts, m.d_ff_expert, cfg.d_model)
    assert p["router"].shape == (m.num_experts, cfg.d_model)
    assert p["router"].dtype == torch.float32
    np.testing.assert_array_equal(
        p["we_up"].numpy(), np.asarray(jparams["layers"]["moe"]["we_up"][1]))
    assert ("ws_gate" in p) == m.shared_expert
    mine = tfm.init_params(dataclasses.replace(cfg, dtype=torch.bfloat16),
                           torch.Generator().manual_seed(0), "cpu")
    assert sorted(mine) == sorted(params)
    lp = mine["layers"][0]
    assert "w_up" not in lp and "w_gate" not in lp
    assert {k: tuple(v.shape) for k, v in lp["moe"].items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    assert lp["moe"]["router"].dtype == torch.float32
    assert lp["moe"]["we_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(models, arch):
    jcfg, cfg, jp, p = _moe_pair(models, arch)
    x = _x(cfg, 1)
    want = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    got = moe.moe_apply(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    # leading dims kept: [B, S, d]
    x3 = x.reshape(2, T // 2, cfg.d_model)
    got3 = moe.moe_apply(p, torch.from_numpy(x3), cfg)
    np.testing.assert_array_equal(got3.reshape(T, -1).numpy(), got.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(models, arch):
    """The chosen experts equal JAX's top-k (no ties on random inputs) and
    the renormalised weights sum to 1."""
    jcfg, cfg, jp, p = _moe_pair(models, arch)
    x = _x(cfg, 2)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"].T, axis=-1)
    jw, je = jax.lax.top_k(probs, jcfg.moe.top_k)
    jw = jw / jw.sum(-1, keepdims=True)
    w, e = moe.route(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **MOE_TOL)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_per_token_experts(models, arch):
    """Each token through its chosen experts one at a time, weighted and
    summed (``tests/test_models_smoke.py``'s manual reference), plus the
    shared expert: the sorted, grouped path computes the same."""
    _, cfg, _, p = _moe_pair(models, arch)
    x = torch.from_numpy(_x(cfg, 3))
    w, e = moe.route(p, x, cfg)
    want = torch.zeros_like(x)
    for t in range(T):
        for j in range(cfg.moe.top_k):
            k = int(e[t, j])
            h = torch.nn.functional.silu(x[t] @ p["we_gate"][k]) \
                * (x[t] @ p["we_up"][k])
            want[t] += w[t, j] * (h @ p["we_down"][k])
    if cfg.moe.shared_expert:
        h = torch.nn.functional.silu(x @ p["ws_gate"].T) * (x @ p["ws_up"].T)
        want += h @ p["ws_down"].T
    got = moe.moe_apply(p, x, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_moe_reads_only_routed_experts(models):
    """Experts no token routes to are never read: poisoning them with NaN
    changes nothing (no [T x k, d, ff] gather of every expert)."""
    _, cfg, _, p = _moe_pair(models, "llama4-maverick-400b-a17b")
    x = torch.from_numpy(_x(cfg, 4, n=3))
    _, e = moe.route(p, x, cfg)
    unused = sorted(set(range(cfg.moe.num_experts)) - set(e.flatten().tolist()))
    assert unused
    poisoned = dict(p)
    for name in ("we_gate", "we_up", "we_down"):
        poisoned[name] = p[name].clone()
        poisoned[name][unused] = float("nan")
    np.testing.assert_array_equal(moe.moe_apply(poisoned, x, cfg).numpy(),
                                  moe.moe_apply(p, x, cfg).numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches_jax(models, arch):
    jcfg, cfg, jp, p = _moe_pair(models, arch)
    x = _x(cfg, 5)
    want = jax_moe.aux_load_balance_loss(jp, jnp.asarray(x), jcfg)
    got = moe.aux_load_balance_loss(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# --------------------------------------------- the transformer with a moe
def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    labels = rng.integers(0, cfg.vocab, (B, S))
    labels[0, :3] = -1
    return tokens, labels


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(models, arch):
    jcfg, cfg, jparams, params = models[arch]
    tokens, labels = _batch(cfg, 6)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    jlogits, _ = jax_tfm.forward(jparams, jbatch, jcfg)
    jloss, jaux = jax_tfm.loss_fn(jparams, jbatch, jcfg)
    with torch.no_grad():
        logits, _ = tfm.forward(params, batch, cfg)
        loss, aux = tfm.loss_fn(params, batch, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert set(aux) == set(jaux) == {"lb_loss"}
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(jaux["lb_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_lockstep_match_jax(models, arch):
    jcfg, cfg, jparams, params = models[arch]
    tokens, _ = _batch(cfg, 7)
    jzoo, zoo = jax_zoo.get_model(jcfg), model_zoo.get_model(cfg, "cpu")
    jlast, jcaches = jzoo.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        last, caches = zoo.prefill(params, {"tokens":
                                            torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    jcaches = jax_zoo.grow_caches(jcaches, S + DECODE_STEPS)
    caches = model_zoo.grow_caches(caches, S + DECODE_STEPS)
    for _ in range(DECODE_STEPS):
        nxt = np.array(jnp.argmax(jlast, -1))[:, None]
        jlast, jcaches = jzoo.decode(jparams, jcaches,
                                     {"tokens": jnp.asarray(nxt)})
        with torch.no_grad():
            last, caches = zoo.decode(params, caches,
                                      {"tokens": torch.from_numpy(nxt)})
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(caches[key].numpy(),
                                   np.asarray(jcaches[key]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_unified_step_chunk_matches_jax(models, arch):
    """One chunk over a slot view (two lanes at different cursors, one
    padding lane) against JAX's ``unified_step``: logits of the real
    positions and the arenas."""
    from repro.serving.cache_pool import SlotPoolView as JaxSlotPoolView
    jcfg, cfg, jparams, params = models[arch]
    n_slots, max_len, Sc = 3, 24, 8
    rng = np.random.default_rng(8)
    shape = (cfg.n_layers, n_slots, max_len, cfg.n_kv_heads, cfg.hd)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    rows = np.array([2, 0, n_slots])
    cur = np.array([5, 0, 0])
    n_new = np.array([Sc, 6, 0])
    tokens = rng.integers(0, cfg.vocab, (3, Sc))
    jview = JaxSlotPoolView(k=jnp.asarray(k0), v=jnp.asarray(v0),
                            rows=jnp.asarray(rows, jnp.int32),
                            cursor=jnp.asarray(cur, jnp.int32),
                            n_new=jnp.asarray(n_new, jnp.int32))
    jlogits, (jk, jv) = jax_tfm.unified_step(
        jparams, jview, {"tokens": jnp.asarray(tokens)}, jcfg)
    view = SlotPoolView.build(torch.from_numpy(k0.copy()),
                              torch.from_numpy(v0.copy()), rows, cur, n_new,
                              Sc)
    with torch.no_grad():
        logits, (k, v) = tfm.unified_step(
            params, view, {"tokens": torch.from_numpy(tokens)}, cfg)
    for lane in range(2):
        n = n_new[lane]
        np.testing.assert_allclose(logits[lane, :n].numpy(),
                                   np.asarray(jlogits)[lane, :n], **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


# ------------------------------------------------------ compressed leaves
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


ATTN = {"wq", "wk", "wv", "wo"}
WANT_SPARSE = {
    "mixtral-8x7b": {f"layers/{n}" for n in ATTN},
    "llama4-maverick-400b-a17b": {f"layers/{n}" for n in ATTN}
    | {f"layers/moe/{n}" for n in ("ws_gate", "ws_up", "ws_down")},
    "whisper-medium": {f"enc/{n}" for n in ATTN | {"w_up", "w_down"}}
    | {f"dec/{n}" for n in ATTN | {"w_up", "w_down"}}
    | {f"dec/c_{n}" for n in ATTN}}


def _smoke_params(arch):
    jcfg, cfg = _cfgs(arch)
    init = jax_whi.init_params if cfg.family == "encdec" else \
        jax_tfm.init_params
    jparams = init(jax.random.PRNGKey(30), jcfg)
    return cfg, jparams, from_jax_params(jparams, "cpu")


@pytest.mark.parametrize("arch", sorted(WANT_SPARSE))
def test_sparsified_leaves_match_jax_at_smoke_width(arch):
    cfg, jparams, params = _smoke_params(arch)
    jsparse, jrep = jax_ss.sparsify_for_serving(jparams,
                                                JaxSparsifyConfig(**SPARSE))
    sparse, rep = ss.sparsify_for_serving(params, SparsifyConfig(**SPARSE))
    names = _sparse_names(sparse)
    assert names == _sparse_names(jsparse) == WANT_SPARSE[arch]
    n_layers = {"enc": cfg.enc_layers, "dec": cfg.n_layers,
                "layers": cfg.n_layers}
    assert rep["n_layers_sparsified"] == sum(n_layers[n.split("/")[0]]
                                             for n in names)
    assert jrep["n_layers_sparsified"] == len(names)
    if cfg.family == "moe":
        lp = sparse["layers"][0]["moe"]
        assert all(isinstance(lp[n], torch.Tensor)
                   for n in ("router", "we_gate", "we_up", "we_down"))


def _leaf_decision(c):
    return None if c is None else (c.weight_pattern, c.outlier_pattern)


@pytest.mark.parametrize("arch", sorted(WANT_SPARSE))
def test_sparsified_leaves_match_jax_at_published_width(arch):
    """Each leaf's decision at the published shapes, from shapes alone:
    JAX's ``_leaf_cfg`` on the stacked ``eval_shape`` leaves (a routed
    expert [L, E, in, out] is 4-D and stays dense), the port's ``leaf_cfg``
    on the per-layer shapes (meta tensors; [E, in, out] is 3-D and stays
    dense)."""
    jcfg = jax_configs.get(arch)
    init = jax_whi.init_params if jcfg.family == "encdec" else \
        jax_tfm.init_params
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
    jscfg, scfg = JaxSparsifyConfig(**SPARSE), SparsifyConfig(**SPARSE)
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    picked = set()
    for path, leaf in flat:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        want = _leaf_decision(jax_ss._leaf_cfg(name, leaf, jscfg))
        head = name.split("/")[0]
        stacked = head in ("layers", "enc", "dec")
        shape = leaf.shape[1:] if stacked else leaf.shape
        port_name = name.replace(f"{head}/", f"{head}/0/", 1) if stacked \
            else name
        got = _leaf_decision(ss.leaf_cfg(
            port_name, torch.empty(shape, device="meta"), scfg))
        assert got == want, name
        if got is not None:
            assert got == ("8:16", "16:256"), name   # whole 256-blocks
            picked.add(name)
    assert picked == WANT_SPARSE[arch]


def test_whisper_params_carry_across():
    """``enc``/``dec`` stacks become per-layer lists; ``enc_norm``,
    ``final_norm`` and ``lm_head`` stay; the port's own init draws the same
    tree."""
    cfg, jparams, params = _smoke_params("whisper-medium")
    assert len(params["enc"]) == cfg.enc_layers
    assert len(params["dec"]) == cfg.n_layers
    np.testing.assert_array_equal(params["dec"][1]["c_wk"].numpy(),
                                  np.asarray(jparams["dec"]["c_wk"][1]))
    mine = whi.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(mine) == sorted(params)
    for part in ("enc", "dec"):
        assert {k: tuple(v.shape) for k, v in mine[part][0].items()} == \
            {k: tuple(v.shape) for k, v in params[part][0].items()}
    for name in ("enc_norm", "final_norm", "lm_head", "embed"):
        assert mine[name].shape == params[name].shape
