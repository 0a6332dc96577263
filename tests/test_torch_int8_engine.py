"""The port's int8-KV ``ServingEngine`` against the JAX package's int8
engine on the same trace and weights, at f32 on the CPU: greedy token
streams identical, with equal prefill chunk counts, prefix-cache hits and
hit tokens, and preemptions.

- ``kv_dtype="int8"`` on the slot and paged layouts, on dense weights and
  on 8:16+16:256 weights with int8 N:M values, under a token budget that
  chunks the longer prompts.
- The prefix-hit scenario of ``test_kv_quantization.py:132``: requests on
  a 3-block system prompt, each submitted after the previous one finished.
- The preemption scenario of ``test_kv_quantization.py:154``: 4 requests
  in 10 blocks.  The JAX package's own test holds the preempted engine to
  a solo run and fails: a resumed request re-prefills its generated tokens
  as a chunk, whose KV projections round differently from the decode steps
  that first wrote them, so the requantized bytes differ (ROADMAP C).  The
  port is held to the JAX engine on the same trace instead.
- int8 against bf16 KV in the port: greedy agreement >= 0.6, as
  ``test_kv_quantization.py:115`` holds the JAX engine.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.serving import (SamplingParams, ServingEngine,  # noqa: E402
                                 Status)

SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=256, vocab=512)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-int8-engine", remat=False,
                           dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-int8-engine", dtype=torch.float32,
                          **SHAPE)
BS, GEN = 8, 8


@pytest.fixture(scope="module")
def param_pairs():
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    sparse8, _ = jax_sparsify(dense, scfg, quantize=True)
    return {"dense": (dense, from_jax_params(dense, device="cpu")),
            "int8_sparse": (sparse8, from_jax_params(sparse8, device="cpu"))}


def _prompts(n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, length).tolist() for _ in range(n)]


def _waves(scenario, kv_layout="paged"):
    """(engine kwargs, [wave of (prompt, max_new_tokens)]): each wave is
    submitted when the engine has drained the previous one."""
    int8 = dict(kv_dtype="int8", block_size=BS)
    if scenario == "chunked":
        prompts = _prompts(3, 12, seed=1) + _prompts(2, 29, seed=2)
        return (dict(n_slots=4, max_len=48, kv_layout=kv_layout,
                     token_budget=16, **int8),
                [[(p, GEN) for p in prompts]])
    if scenario == "prefix":
        system = _prompts(1, 3 * BS, seed=5)[0]
        return (dict(n_slots=4, max_len=64, kv_layout="paged", **int8),
                [[(system + t, GEN)] for t in _prompts(3, 6, seed=6)])
    if scenario == "preempt":
        return (dict(n_slots=4, max_len=40, kv_layout="paged", n_blocks=10,
                     token_budget=16, **int8),
                [[(p, 12) for p in _prompts(4, 16, seed=9)]])
    raise ValueError(scenario)


def _serve(engine, waves, sampling_cls):
    reqs = []
    for wave in waves:
        reqs += [engine.submit(p, sampling_cls(max_new_tokens=g))
                 for p, g in wave]
        engine.run(max_steps=300)
    return reqs


def _run_pair(param_pairs, which, kw, waves):
    jparams, tparams = param_pairs[which]
    jengine = JaxServingEngine(JCFG, jparams, **kw)
    jreqs = _serve(jengine, waves, JaxSamplingParams)
    tengine = ServingEngine(CFG, tparams, device="cpu", **kw)
    treqs = _serve(tengine, waves, SamplingParams)
    for j, t in zip(jreqs, treqs):
        assert t.status is Status.FINISHED and j.status.name == "FINISHED"
        assert t.tokens == j.tokens, f"request {t.request_id} diverged"
        assert t.metrics.prefill_chunks == j.metrics.prefill_chunks
        assert t.n_preempted == j.n_preempted
    assert tengine.n_preemptions == jengine.n_preemptions
    assert tengine.stats()["pool"]["kv_dtype"] == "int8"
    return jengine, tengine, treqs


@pytest.mark.parametrize("which", ["dense", "int8_sparse"])
@pytest.mark.parametrize("kv_layout", ["slot", "paged"])
def test_int8_streams_identical_to_jax_engine(param_pairs, kv_layout, which):
    kw, waves = _waves("chunked", kv_layout)
    _, tengine, treqs = _run_pair(param_pairs, which, kw, waves)
    assert max(t.metrics.prefill_chunks for t in treqs) > 1
    assert tengine.stats()["pool"]["scale_bytes"] > 0


def _cache_stats(engine):
    pc = engine.pool.prefix_cache.stats()
    return pc["hits"], pc["hit_tokens"]


@pytest.mark.parametrize("which", ["dense", "int8_sparse"])
def test_int8_prefix_hits_match_jax_engine(param_pairs, which):
    jengine, tengine, _ = _run_pair(param_pairs, which, *_waves("prefix"))
    assert _cache_stats(tengine) == _cache_stats(jengine)
    assert _cache_stats(tengine)[1] >= 2 * 2 * BS


def test_int8_preemption_matches_jax_engine(param_pairs):
    jengine, tengine, treqs = _run_pair(param_pairs, "dense",
                                        *_waves("preempt"))
    assert tengine.n_preemptions > 0, "scenario must actually preempt"
    assert _cache_stats(tengine) == _cache_stats(jengine)
    assert all(len(t.tokens) == 12 for t in treqs)


@pytest.mark.parametrize("which", ["dense", "int8_sparse"])
@pytest.mark.parametrize("kv_layout", ["slot", "paged"])
def test_int8_vs_bf16_greedy_agreement(param_pairs, kv_layout, which):
    _, tparams = param_pairs[which]
    prompts = _prompts(4, 12, seed=1)
    streams = {}
    for kv_dtype in ("bf16", "int8"):
        engine = ServingEngine(CFG, tparams, device="cpu", n_slots=4,
                               max_len=48, kv_layout=kv_layout, block_size=BS,
                               kv_dtype=kv_dtype)
        reqs = [engine.submit(p, SamplingParams(max_new_tokens=GEN))
                for p in prompts]
        engine.run()
        assert all(r.status is Status.FINISHED and len(r.tokens) == GEN
                   for r in reqs)
        streams[kv_dtype] = [r.tokens for r in reqs]
    matched = sum(a == b for r, g in zip(streams["bf16"], streams["int8"])
                  for a, b in zip(r, g))
    agree = matched / (len(prompts) * GEN)
    assert agree >= 0.6, f"int8 KV diverged from bf16: agreement {agree:.2f}"


def test_unknown_kv_dtype_raises(param_pairs):
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(CFG, param_pairs["dense"][1], device="cpu",
                      kv_dtype="fp8")
