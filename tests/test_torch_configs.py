"""The port's ``configs`` package against the JAX package's: every
registered config and every smoke twin field by field (``dtype`` mapped to
its ``torch.dtype``), the parameter counts, the shapes and their
applicability, the model zoo's input and cache specs (the recurrent
families' nested state specs, the moe family's and encdec's ``embeds``
input and ``ck``/``cv`` caches too) and ``grow_caches``; every family
builds through the zoo, while vlm runs ``forward`` and is refused by the
engine, as the reference refuses it."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

SMOKE_IDS = sorted(configs.SMOKE_MODULES)


def _both_registries():
    """Every id of both registries, the smoke twins registered first."""
    for name in SMOKE_IDS:
        jax_configs.get_smoke(name)
        configs.get_smoke(name)
    return jax_configs.all_archs(), configs.all_archs()


def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = v if isinstance(v, torch.dtype) else \
                getattr(torch, jnp.dtype(v).name)
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


def test_smoke_ids_match_the_reference():
    import inspect
    src = inspect.getsource(jax_configs.get_smoke)
    for name in SMOKE_IDS:
        assert f'"{name}"' in src
    assert src.count('": "') == len(SMOKE_IDS)


def test_registries_hold_the_same_ids():
    jax_ids, ids = _both_registries()
    assert ids == jax_ids
    assert len(ids) == 14 + len(SMOKE_IDS)    # archs and smoke twins
    assert configs.ASSIGNED == jax_configs.ASSIGNED
    assert configs.PAPER_ARCHS == jax_configs.PAPER_ARCHS


@pytest.mark.parametrize("name", _both_registries()[1])
def test_config_matches_field_by_field(name):
    j, t = jax_configs.get(name), configs.get(name)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert _fields(t) == _fields(j)
    assert isinstance(t.dtype, torch.dtype)
    assert t.hd == j.hd
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("name", SMOKE_IDS)
def test_get_smoke_matches(name):
    assert _fields(configs.get_smoke(name)) == \
        _fields(jax_configs.get_smoke(name))


def test_moe_config_and_defaults_match():
    assert [f.name for f in dataclasses.fields(configs.MoEConfig)] == \
        [f.name for f in dataclasses.fields(jax_configs.MoEConfig)]
    for f, g in zip(dataclasses.fields(configs.ModelConfig),
                    dataclasses.fields(jax_configs.ModelConfig)):
        if f.name != "dtype":
            assert f.default == g.default, f.name
    assert configs.ModelConfig.__dataclass_fields__["dtype"].default \
        is torch.bfloat16


def test_shapes_and_applicability_match():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    assert configs.SUBQUADRATIC_FAMILIES == \
        jax_configs.base.SUBQUADRATIC_FAMILIES
    for name in _both_registries()[1]:
        for sname in configs.SHAPES:
            assert configs.shape_applicable(
                configs.get(name), configs.SHAPES[sname]) == \
                jax_configs.shape_applicable(jax_configs.get(name),
                                             jax_configs.SHAPES[sname])
        assert configs.SHAPES[sname].tokens == \
            jax_configs.SHAPES[sname].tokens


# ------------------------------------------------------------- model zoo
ZOO_ARCHS = ["qwen3-8b", "gemma-7b", "internlm2-1.8b", "nemotron-4-340b",
             "qwen2-vl-72b", "llama3-8b", "qwen3-8b-smoke", "gemma-7b-smoke",
             "qwen2-vl-72b-smoke", "mixtral-8x7b",
             "llama4-maverick-400b-a17b", "whisper-medium",
             "mixtral-8x7b-smoke", "llama4-maverick-400b-a17b-smoke",
             "whisper-medium-smoke"]


def _spec(s):
    return tuple(s.shape), getattr(torch, jnp.dtype(s.dtype).name)


@pytest.mark.parametrize("name", ZOO_ARCHS)
def test_input_and_cache_specs_match(name):
    _both_registries()
    j, t = jax_configs.get(name), configs.get(name)
    for sname, shape in configs.SHAPES.items():
        jshape = jax_configs.SHAPES[sname]
        want = {k: _spec(v) for k, v in
                jax_zoo.input_specs(j, jshape).items()}
        assert model_zoo.input_specs(t, shape) == want
        want = {k: _spec(v) for k, v in
                jax_zoo.cache_specs(j, jshape).items()}
        assert model_zoo.cache_specs(t, shape) == want


def _nested_spec(tree):
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return [_nested_spec(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _nested_spec(v) for k, v in tree.items()}
    return _spec(tree)


def _port_nested(tree):
    """The port's (shape, dtype) leaves as [shape, dtype] lists, the
    nesting kept, for comparison with ``_nested_spec`` of JAX's."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and len(tree) == 2 and \
            isinstance(tree[1], torch.dtype):
        return (tuple(tree[0]), tree[1])
    if isinstance(tree, (list, tuple)):
        return [_port_nested(t) for t in tree]
    return {k: _port_nested(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["xlstm-350m", "zamba2-2.7b",
                                  "xlstm-350m-smoke", "zamba2-2.7b-smoke"])
def test_recurrent_input_and_cache_specs_match(name):
    """ssm: per-layer mLSTM (C, n) and sLSTM (c, n, h, m) states; hybrid:
    per-layer (S, None) states and per-application (k, v)."""
    _both_registries()
    j, t = jax_configs.get(name), configs.get(name)
    for sname, shape in configs.SHAPES.items():
        jshape = jax_configs.SHAPES[sname]
        want = {k: _spec(v) for k, v in
                jax_zoo.input_specs(j, jshape).items()}
        assert model_zoo.input_specs(t, shape) == want
        got = _port_nested(model_zoo.cache_specs(t, shape))
        assert got == _nested_spec(jax_zoo.cache_specs(j, jshape))


def test_grow_caches_matches():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 3, 5, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 3, 5, 2, 4)).astype(np.float32)
    jout = jax_zoo.grow_caches({"k": jnp.asarray(k), "v": jnp.asarray(v),
                                "pos": jnp.asarray(5)}, 9)
    out = model_zoo.grow_caches({"k": torch.from_numpy(k),
                                 "v": torch.from_numpy(v),
                                 "pos": torch.tensor(5)}, 9)
    for key in ("k", "v"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]))
    assert int(out["pos"]) == 5
    same = model_zoo.grow_caches(out, 4)
    assert same["k"] is out["k"]


def test_grow_caches_keeps_encdec_context_at_encoder_length():
    """encdec's self-attention k/v grow; the cross-attention ck/cv stay at
    the encoder's length, as the reference's ``grow_caches`` keeps them."""
    rng = np.random.default_rng(1)
    arrs = {key: rng.standard_normal((2, 3, n, 2, 4)).astype(np.float32)
            for key, n in (("k", 5), ("v", 5), ("ck", 7), ("cv", 7))}
    jout = jax_zoo.grow_caches({**{k: jnp.asarray(a) for k, a in arrs.items()},
                                "pos": jnp.asarray(5)}, 9)
    out = model_zoo.grow_caches({**{k: torch.from_numpy(a)
                                    for k, a in arrs.items()},
                                 "pos": torch.tensor(5)}, 9)
    for key in arrs:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]))
    assert out["k"].shape[2] == 9 and out["ck"].shape[2] == 7


@pytest.mark.parametrize("name", ["mixtral-8x7b", "llama4-maverick-400b-a17b",
                                  "whisper-medium"])
def test_moe_and_encdec_build_through_the_zoo(name):
    """``get_model`` of the full config builds nothing, and of the smoke
    twin draws a tree whose loss is finite, for every family the reference
    serves."""
    assert model_zoo.get_model(configs.get(name), "cpu").cfg.name == name
    cfg = dataclasses.replace(configs.get_smoke(name), dtype=torch.float32)
    zoo = model_zoo.get_model(cfg, "cpu")
    params = zoo.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6)))}
    if cfg.family == "encdec":
        batch["embeds"] = torch.randn(2, 5, cfg.d_model)
    with torch.no_grad():
        loss, aux = zoo.loss(params, batch)
    assert bool(torch.isfinite(loss))
    assert set(aux) == ({"lb_loss"} if cfg.family == "moe" else set())


# ------------------------------------------------------------------ vlm
def test_vlm_is_refused_by_both_engines():
    jcfg = jax_configs.get_smoke("qwen2-vl-72b")
    cfg = configs.get_smoke("qwen2-vl-72b")
    jparams = jax_zoo.get_model(jcfg).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="'vlm'"):
        JaxServingEngine(jcfg, jparams)
    params = model_zoo.get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="'vlm'"):
        ServingEngine(cfg, params, device="cpu")
    # the CLI serves vlm through the one-shot loop, as the reference's does
    tokens = serve.main(["--arch", "qwen2-vl-72b", "--smoke-arch",
                         "--device", "cpu", "--batch", "1", "--prompt-len",
                         "4", "--gen", "1"])
    assert tokens.shape == (1, 1)
