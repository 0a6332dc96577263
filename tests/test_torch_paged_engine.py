"""The port's paged ``ServingEngine`` against the JAX package's paged engine
at f32, on dense and on 8:16+16:256 sparse weights: greedy token streams,
prefill chunk counts, prefix-cache hits and hit tokens, and preemptions
must all be identical, in the scenarios of ``tests/test_paged.py``:

  prefix      requests sharing a 3-block system prompt, submitted after the
              previous one finished (warm cache, suffix-only prefill);
  cow         the same full-block prompt twice, then extended: the repeat
              matches every block and copies the last one on write;
  preempt     a starved arena preempts decoding requests back to the queue;
              their written blocks go to the prefix cache and the resume
              matches them;
  deferred    a burst larger than the arena: admission waits for blocks;
  full        one request whose prompt and generation fill the arena,
              admitted despite the lookahead margin.

And the port's paged engine against its own slot engine, token for token.
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
                           name="torch-paged-engine", remat=False,
                           dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-paged-engine", dtype=torch.float32,
                          **SHAPE)
BS, GEN = 8, 6


@pytest.fixture(scope="module")
def param_pairs():
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    sparse, _ = jax_sparsify(dense, scfg)
    return {"dense": (dense, from_jax_params(dense, device="cpu")),
            "sparse": (sparse, from_jax_params(sparse, device="cpu"))}


def _prompts(n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, length).tolist() for _ in range(n)]


def _waves(scenario):
    """(engine kwargs, [wave of (prompt, max_new_tokens)]): each wave is
    submitted when the engine has drained the previous one."""
    paged = dict(kv_layout="paged", block_size=BS)
    if scenario == "prefix":
        system = _prompts(1, 3 * BS, seed=5)[0]
        tails = _prompts(3, 6, seed=6)
        return (dict(n_slots=4, max_len=64, **paged),
                [[(system + t, GEN)] for t in tails])
    if scenario == "cow":
        prompt = _prompts(1, 3 * BS, seed=7)[0]
        return (dict(n_slots=4, max_len=64, **paged),
                [[(prompt, GEN)], [(prompt, GEN)],
                 [(prompt + _prompts(1, 4, seed=8)[0], GEN)]])
    if scenario == "preempt":
        return (dict(n_slots=4, max_len=40, n_blocks=11, **paged),
                [[(p, 12) for p in _prompts(4, 16, seed=9)]])
    if scenario == "deferred":
        return (dict(n_slots=6, max_len=32, n_blocks=9, **paged),
                [[(p, GEN) for p in _prompts(6, 16, seed=10)]])
    if scenario == "full":
        return (dict(n_slots=1, max_len=32, **paged),
                [[(_prompts(1, 28, seed=14)[0], 4)]])
    raise ValueError(scenario)


def _serve(engine, waves, sampling_cls):
    reqs = []
    for wave in waves:
        reqs += [engine.submit(p, sampling_cls(max_new_tokens=g))
                 for p, g in wave]
        engine.run(max_steps=200)
    return reqs


def _run_pair(param_pairs, which, scenario):
    kw, waves = _waves(scenario)
    jparams, tparams = param_pairs[which]
    jengine = JaxServingEngine(JCFG, jparams, **kw)
    jreqs = _serve(jengine, waves, JaxSamplingParams)
    tengine = ServingEngine(CFG, tparams, device="cpu", **kw)
    treqs = _serve(tengine, waves, SamplingParams)
    return jengine, jreqs, tengine, treqs


def _cache_stats(engine):
    pc = engine.pool.prefix_cache.stats()
    return pc["hits"], pc["hit_tokens"]


@pytest.mark.parametrize("scenario,which", [
    ("prefix", "dense"), ("prefix", "sparse"), ("cow", "dense"),
    ("cow", "sparse"), ("preempt", "dense"), ("preempt", "sparse"),
    ("deferred", "dense"), ("full", "dense")])
def test_streams_identical_to_jax_paged_engine(param_pairs, scenario, which):
    jengine, jreqs, tengine, treqs = _run_pair(param_pairs, which, scenario)
    for j, t in zip(jreqs, treqs):
        assert t.status is Status.FINISHED and j.status.name == "FINISHED"
        assert t.tokens == j.tokens, f"request {t.request_id} diverged"
        assert t.metrics.prefill_chunks == j.metrics.prefill_chunks
        assert t.n_preempted == j.n_preempted
    assert tengine.n_preemptions == jengine.n_preemptions
    assert _cache_stats(tengine) == _cache_stats(jengine)
    hits, hit_tokens = _cache_stats(tengine)
    if scenario == "prefix":
        assert hit_tokens >= 2 * 3 * BS           # requests 2, 3: 3 blocks
    if scenario == "cow":
        assert treqs[0].tokens == treqs[1].tokens and hits == 2
    if scenario == "preempt":
        assert tengine.n_preemptions > 0 and hits > 0
    assert tengine.pool.stats()["n_preemptions"] == tengine.n_preemptions


@pytest.mark.parametrize("which", ["dense", "sparse"])
def test_paged_identical_to_slot(param_pairs, which):
    _, tparams = param_pairs[which]
    prompts = _prompts(4, 16, seed=1) + _prompts(2, 27, seed=2)
    streams = {}
    for layout in ("slot", "paged"):
        engine = ServingEngine(CFG, tparams, device="cpu", n_slots=4,
                               max_len=48, kv_layout=layout, block_size=BS,
                               token_budget=24)
        reqs = [engine.submit(p, SamplingParams(max_new_tokens=GEN))
                for p in prompts]
        engine.run()
        assert all(r.status is Status.FINISHED for r in reqs)
        streams[layout] = [r.tokens for r in reqs]
    assert streams["paged"] == streams["slot"]


def test_probe_and_reset_stats(param_pairs):
    _, tparams = param_pairs["dense"]
    kw, waves = _waves("prefix")
    engine = ServingEngine(CFG, tparams, device="cpu", **kw)
    _serve(engine, waves[:1], SamplingParams)
    system = waves[0][0][0][:3 * BS]
    assert engine.prefix_match_length(system + [1, 2]) == 3 * BS
    assert engine.pool.prefix_cache.stats()["probes"] == 1
    engine.reset_stats()
    st = engine.stats()
    assert st["n_steps"] == 0 and st["pool"]["prefix_cache"]["lookups"] == 0
    assert st["pool"]["prefix_cache"]["entries"] > 0      # content kept
