"""The dense family's other members in the port against the JAX package, at
f32 on their smoke twins, with the JAX weights carried over by
``interchange``:

  qwen3-8b-smoke          qk_norm (per-head q/k RMSNorm before RoPE)
  gemma-7b-smoke          GeGLU, head dim 32 != d_model / heads, tied head
  internlm2-1.8b-smoke    GQA 4/2
  nemotron-4-340b-smoke   squared ReLU, non-gated MLP

``forward`` and ``loss_fn``, ``prefill`` and ``decode_lockstep`` (logits and
caches) at atol 1e-4; the set of leaves ``sparsify_for_serving`` compresses,
against JAX's, at the smoke widths and (by shape alone) at the published
widths; and qwen2-vl-72b-smoke's ``forward``/``loss_fn`` with ``embeds`` and
[3, B, S] M-RoPE positions.  The engines' streams are in
``test_torch_dense_family_engines.py``.
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
from repro.models import sparse_serving as jax_ss  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import SparsifyConfig  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models import sparse_serving as ss  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCHS = ["qwen3-8b", "gemma-7b", "internlm2-1.8b", "nemotron-4-340b"]
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


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    """arch: (jcfg, cfg, JAX params, port params), drawn once a module."""
    out = {}
    for i, arch in enumerate(ARCHS + ["qwen2-vl-72b"]):
        jcfg, cfg = _cfgs(arch)
        jparams = jax_tfm.init_params(jax.random.PRNGKey(10 + i), jcfg)
        out[arch] = (jcfg, cfg, jparams, from_jax_params(jparams, "cpu"))
    return out


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    labels = rng.integers(0, cfg.vocab, (B, S))
    labels[0, :3] = -1                       # masked positions
    return tokens, labels


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across(models, arch):
    jcfg, cfg, jparams, params = models[arch]
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert ("lm_head" in jparams) == (not jcfg.tie_embeddings)
    lp = params["layers"][0]
    assert ("q_norm" in lp) == cfg.qk_norm == ("k_norm" in lp)
    if cfg.qk_norm:
        assert lp["q_norm"].shape == (cfg.hd,)
        np.testing.assert_array_equal(
            params["layers"][1]["k_norm"].numpy(),
            np.asarray(jparams["layers"]["k_norm"][1]))
    assert ("w_gate" in lp) == cfg.glu
    # the port's own init draws the same tree
    mine = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(mine) == sorted(params)
    assert {k: tuple(v.shape) for k, v in mine["layers"][0].items()} == \
        {k: tuple(v.shape) for k, v in lp.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(models, arch):
    jcfg, cfg, jparams, params = models[arch]
    tokens, labels = _batch(cfg, 1)
    jlogits, _ = jax_tfm.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                 jcfg)
    jloss, _ = jax_tfm.loss_fn(jparams, {"tokens": jnp.asarray(tokens),
                                         "labels": jnp.asarray(labels)}, jcfg)
    with torch.no_grad():
        logits, _ = tfm.forward(params, {"tokens": torch.from_numpy(tokens)},
                                cfg)
        loss, aux = tfm.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                         "labels": torch.from_numpy(labels)},
                                cfg)
    assert logits.shape == (B, S, cfg.vocab) and aux == {}
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_lockstep_match_jax(models, arch):
    """``prefill`` of a prompt, ``grow_caches`` by the decode steps, then
    ``decode_lockstep`` a token at a time (the greedy token of JAX's
    logits fed to both): logits and caches at every step."""
    jcfg, cfg, jparams, params = models[arch]
    tokens, _ = _batch(cfg, 2)
    jzoo, zoo = jax_zoo.get_model(jcfg), model_zoo.get_model(cfg, "cpu")
    jlast, jcaches = jzoo.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        last, caches = zoo.prefill(params, {"tokens":
                                            torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    assert int(caches["pos"]) == int(jcaches["pos"]) == S
    jcaches = jax_zoo.grow_caches(jcaches, S + DECODE_STEPS)
    caches = model_zoo.grow_caches(caches, S + DECODE_STEPS)
    for step in range(DECODE_STEPS):
        for key in ("k", "v"):
            np.testing.assert_allclose(caches[key].numpy(),
                                       np.asarray(jcaches[key]), **TOL)
        nxt = np.array(jnp.argmax(jlast, -1))[:, None]
        jlast, jcaches = jzoo.decode(jparams, jcaches,
                                     {"tokens": jnp.asarray(nxt)})
        with torch.no_grad():
            last, caches = zoo.decode(params, caches,
                                      {"tokens": torch.from_numpy(nxt)})
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
        assert int(caches["pos"]) == int(jcaches["pos"]) == S + step + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(caches[key].numpy(),
                                   np.asarray(jcaches[key]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_lockstep_takes_per_row_positions(models, arch):
    """A [B] ``pos`` writes and masks each row at its own position, as a
    scalar ``pos`` of the same value for every row does."""
    _, cfg, _, params = models[arch]
    tokens, _ = _batch(cfg, 3)
    with torch.no_grad():
        _, caches = tfm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                cfg)
        caches = model_zoo.grow_caches(caches, S + 1)
        nxt = torch.from_numpy(tokens[:, :1])
        scalar = {k: v.clone() for k, v in caches.items()}
        vector = dict(scalar, k=caches["k"].clone(), v=caches["v"].clone(),
                      pos=torch.full((B,), S, dtype=torch.int32))
        a, ca = tfm.decode_lockstep(params, scalar, {"tokens": nxt}, cfg)
        b, cb = tfm.decode_lockstep(params, vector, {"tokens": nxt}, cfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(ca["k"].numpy(), cb["k"].numpy())
    assert cb["pos"].tolist() == [S + 1] * B


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


@pytest.mark.parametrize("arch", ARCHS)
def test_sparsified_leaves_match_jax_at_smoke_width(models, arch):
    jcfg, cfg, jparams, params = models[arch]
    jsparse, jrep = jax_ss.sparsify_for_serving(jparams,
                                                JaxSparsifyConfig(**SPARSE))
    sparse, rep = ss.sparsify_for_serving(params, SparsifyConfig(**SPARSE))
    names = _sparse_names(sparse)
    assert names == _sparse_names(jsparse)
    want = {"layers/wq", "layers/wk", "layers/wv", "layers/wo",
            "layers/w_up", "layers/w_down"} | (
                {"layers/w_gate"} if cfg.glu else set())
    assert names == want
    assert rep["n_layers_sparsified"] == len(want) * cfg.n_layers
    assert rep["n_layers_sparsified"] == jrep["n_layers_sparsified"] * \
        cfg.n_layers
    assert isinstance(sparse["embed"], torch.Tensor)     # the tied head too
    # outliers where the in-dim holds whole 256-blocks only, as in the
    # reference (the smoke widths keep them on nemotron's w_down alone)
    for name in names:
        leaf = name.split("/")[-1]
        has = jsparse["layers"][leaf].o_values is not None
        assert has == (sparse["layers"][0][leaf].in_dim % 256 == 0)
        assert all((lp[leaf].o_values is not None) == has
                   for lp in sparse["layers"])


def _leaf_decision(c):
    return None if c is None else (c.weight_pattern, c.outlier_pattern)


@pytest.mark.parametrize("arch", ARCHS + ["llama3-8b", "qwen2-vl-72b"])
def test_sparsified_leaves_match_jax_at_published_width(arch):
    """Each leaf's decision (dense, N:M, N:M + outliers) at the published
    shapes, from shapes alone: JAX's ``_leaf_cfg`` on the stacked
    ``eval_shape`` leaves, the port's ``leaf_cfg`` on the per-layer
    shapes (meta tensors)."""
    jcfg = jax_configs.get(arch)
    shapes = jax.eval_shape(lambda: jax_tfm.init_params(
        jax.random.PRNGKey(0), jcfg))
    jscfg, scfg = JaxSparsifyConfig(**SPARSE), SparsifyConfig(**SPARSE)
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    picked = set()
    for path, leaf in flat:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        want = _leaf_decision(jax_ss._leaf_cfg(name, leaf, jscfg))
        shape = leaf.shape[1:] if name.startswith("layers/") else leaf.shape
        port_name = name.replace("layers/", "layers/0/")
        got = _leaf_decision(ss.leaf_cfg(
            port_name, torch.empty(shape, device="meta"), scfg))
        assert got == want, name
        if got is not None:
            picked.add(name)
    assert "embed" not in picked and "layers/wq" in picked


def test_mrope_forward_and_loss_match_jax(models):
    """qwen2-vl-72b-smoke: ``embeds`` [B, S, d] and distinct t/h/w position
    rows [3, B, S] through ``forward`` and ``loss_fn``; and the default
    positions (a text batch) against JAX's."""
    jcfg, cfg, jparams, params = models["qwen2-vl-72b"]
    assert cfg.mrope_sections == (2, 3, 3) and cfg.family == "vlm"
    rng = np.random.default_rng(7)
    embeds = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    positions = np.stack([np.tile(np.arange(S), (B, 1)),
                          rng.integers(0, 6, (B, S)),
                          rng.integers(0, 6, (B, S))]).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S))
    jbatch = {"embeds": jnp.asarray(embeds),
              "positions": jnp.asarray(positions),
              "labels": jnp.asarray(labels)}
    batch = {"embeds": torch.from_numpy(embeds),
             "positions": torch.from_numpy(positions),
             "labels": torch.from_numpy(labels)}
    jlogits, _ = jax_tfm.forward(jparams, jbatch, jcfg)
    jloss, _ = jax_tfm.loss_fn(jparams, jbatch, jcfg)
    with torch.no_grad():
        logits, _ = tfm.forward(params, batch, cfg)
        loss, _ = tfm.loss_fn(params, batch, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    tokens, _ = _batch(cfg, 8)
    jlogits, _ = jax_tfm.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                 jcfg)
    with torch.no_grad():
        logits, _ = tfm.forward(params, {"tokens": torch.from_numpy(tokens)},
                                cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_mrope_rotation_matches_jax():
    """``apply_rope`` with sections against the reference's, and its
    refusal of sections that do not sum to hd / 2."""
    from repro.models import layers as jax_layers
    from repro_torch.models import layers
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 5)).astype(np.int32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                 (2, 3, 3))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="M-RoPE"):
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                          (2, 3, 2))


def test_mrope_unified_step_positions_match_jax():
    """On the serving path every section takes the text position: the
    [3, B, S] positions ``_pool_positions`` builds equal JAX's."""
    _, cfg = _cfgs("qwen2-vl-72b")
    cursor = np.array([0, 7], np.int32)
    want = jax_tfm._pool_positions(jnp.asarray(cursor), 4,
                                   jax_configs.get_smoke("qwen2-vl-72b"))
    got = tfm._pool_positions(torch.from_numpy(cursor), 4, cfg)
    assert got.shape == (3, 2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_step_splits_mrope_positions_along_the_batch(models):
    """``make_train_step`` with 2 microbatches on an ``embeds`` batch with
    [3, B, S] positions: the positions split along axis 1 with their rows,
    so the mean loss equals the one-batch loss."""
    from repro_torch.launch.steps import TrainOptions, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    _, cfg, _, params = models["qwen2-vl-72b"]
    rng = np.random.default_rng(11)
    batch = {"embeds": torch.from_numpy(rng.standard_normal(
                 (4, S, cfg.d_model)).astype(np.float32)),
             "positions": torch.from_numpy(
                 rng.integers(0, 9, (3, 4, S)).astype(np.int64)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (4, S)))}
    ocfg = AdamWConfig()
    losses = []
    for mb in (1, 2):
        step = make_train_step(cfg, ocfg, TrainOptions(microbatches=mb))
        _, _, m = step(params, adamw_init(params, ocfg), batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
