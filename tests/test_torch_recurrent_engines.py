"""The port's ``ServingEngine`` on the recurrent families against the JAX
package's engine, at f32 on the smoke twins (xlstm-350m-smoke: ssm;
zamba2-2.7b-smoke: hybrid), with the JAX weights carried over by
``interchange``: the counterparts of ``tests/test_family_engines.py``'s
ssm and hybrid cases.

  * greedy streams identical to the JAX engine's and to the lock-step
    reference (``prefill`` + ``decode_lockstep``), dense and 8:16 weights,
    on the slot layout and (hybrid) the paged layout, where prefix
    caching is off whatever was asked;
  * a forced preemption mid-generation resumes exactly (the adapters swap
    the recurrent state, and the hybrid's KV, out and back);
  * ssm's budget waiver: token budget 5 (under the chunk quantum) is
    legal, the chunk quantum widens to it, and odd chunk splits change no
    token; the same budget is refused for a dense model;
  * admission rules: ssm serves the slot layout whatever was asked and
    refuses ``embeds``; hybrid needs a shared-attention application;
    int8 KV is refused for both;
  * ``RecurrentStatePool`` against the JAX pool under a random op walk
    (free list, positions, swap round trips bitwise);
  * the traced engine's per-variant cost (``launch/step_cost.py``) and the
    serve CLI on both families.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import random  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                     # pragma: no cover
    from hypothesis_fallback import given, settings, st

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.serving import RecurrentStatePool as JaxStatePool  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import step_cost  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.serving import (DoubleFree, SamplingParams,  # noqa: E402
                                 ServingEngine, ServingTracer, Status)
from repro_torch.serving.state_pool import (RecurrentStatePool,  # noqa: E402
                                            state_leaves)

ARCHS = {"ssm": "xlstm-350m", "hybrid": "zamba2-2.7b"}
GEN, P_LEN = 6, 16
ENGINE = dict(n_slots=4, max_len=P_LEN + GEN, token_budget=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread each, so several test workers on
    one machine do not oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """family: (jcfg, cfg, {weights: (JAX params, port params)})."""
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    out = {}
    for i, (fam, arch) in enumerate(ARCHS.items()):
        jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                                   dtype=jnp.float32, remat=False)
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  dtype=torch.float32, remat=False)
        dense = jax_get_model(jcfg).init(jax.random.PRNGKey(40 + i))
        sparse, rep = jax_sparsify(dense, scfg)
        assert rep["n_layers_sparsified"] > 0
        out[fam] = (jcfg, cfg, {
            "dense": (dense, from_jax_params(dense, "cpu")),
            "sparse": (sparse, from_jax_params(sparse, "cpu"))})
    return out


def _prompts(cfg, n, length, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (n, length)).tolist()


def _lockstep(cfg, params, prompts, gen):
    """The port's one-shot loop: batched ``prefill`` + greedy
    ``decode_lockstep`` (the hybrid's KV grown by ``grow_caches``)."""
    zoo = model_zoo.get_model(cfg, "cpu")
    toks = torch.tensor(prompts)
    with torch.no_grad():
        logits, caches = zoo.prefill(params, {"tokens": toks})
        caches = model_zoo.grow_caches(caches, toks.shape[1] + gen)
        tok = logits.argmax(-1)[:, None]
        outs = [tok]
        for _ in range(gen - 1):
            logits, caches = zoo.decode(params, caches, {"tokens": tok})
            tok = logits.argmax(-1)[:, None]
            outs.append(tok)
    return torch.cat(outs, 1).tolist()


def _serve(engine, prompts, gen, sampling=SamplingParams):
    reqs = [engine.submit(p, sampling(max_new_tokens=gen)) for p in prompts]
    engine.run(max_steps=200)
    return reqs


def _jax_streams(jcfg, jparams, prompts, **kw):
    engine = JaxServingEngine(jcfg, jparams, **kw)
    reqs = _serve(engine, prompts, GEN, JaxSamplingParams)
    return [r.tokens for r in reqs], engine


# ------------------------------------------------------------- parity ---
@pytest.mark.parametrize("which", ["dense", "sparse"])
@pytest.mark.parametrize("family", list(ARCHS))
def test_engine_matches_lockstep(models, family, which):
    """Chunked, continuously batched engine == the JAX engine == the
    one-shot lock-step loop, token for token, dense and 8:16 weights."""
    jcfg, cfg, pairs = models[family]
    jparams, params = pairs[which]
    prompts = _prompts(cfg, 3, P_LEN, seed=1)
    want, jengine = _jax_streams(jcfg, jparams, prompts, **ENGINE)
    engine = ServingEngine(cfg, params, device="cpu", **ENGINE)
    reqs = _serve(engine, prompts, GEN)
    assert [r.tokens for r in reqs] == want
    assert all(r.status is Status.FINISHED for r in reqs)
    assert want == _lockstep(cfg, params, prompts, GEN)
    st_, jst = engine.stats(), jengine.stats()
    assert st_["family"] == jst["family"] == family
    assert st_["n_steps"] == jst["n_steps"]
    assert st_["pool"] == jst["pool"]


def test_hybrid_paged_matches_lockstep(models):
    """Paged shared-attention KV beside slot-indexed SSM state in one step:
    block-granular allocation changes no token; prefix caching is off
    (cached KV blocks cannot reconstruct the SSM state)."""
    jcfg, cfg, pairs = models["hybrid"]
    jparams, params = pairs["dense"]
    prompts = _prompts(cfg, 3, P_LEN, seed=1)
    kw = dict(ENGINE, kv_layout="paged", block_size=8)
    want, jengine = _jax_streams(jcfg, jparams, prompts, **kw)
    engine = ServingEngine(cfg, params, device="cpu", **kw)
    reqs = _serve(engine, prompts, GEN)
    assert [r.tokens for r in reqs] == want
    assert want == _lockstep(cfg, params, prompts, GEN)
    assert engine.pool.prefix_cache is None is jengine.pool.prefix_cache
    assert engine.stats()["pool"]["layout"] == "paged"
    assert "prefix_cache" not in engine.stats()["pool"]


@pytest.mark.parametrize("family", list(ARCHS))
def test_preempt_resume_exact(models, family):
    """A request preempted mid-generation and resumed reproduces the
    uninterrupted stream exactly: the adapters swap the recurrent state
    (and the hybrid's KV rows) out and back instead of recomputing; the
    JAX engine, preempted at the same step, emits the same tokens."""
    jcfg, cfg, pairs = models[family]
    jparams, params = pairs["dense"]
    prompts = _prompts(cfg, 3, P_LEN, seed=4)
    ref = _lockstep(cfg, params, prompts, GEN)
    streams = []
    for eng in (JaxServingEngine(jcfg, jparams, **ENGINE),
                ServingEngine(cfg, params, device="cpu", **ENGINE)):
        port = isinstance(eng, ServingEngine)
        sp = SamplingParams if port else JaxSamplingParams
        reqs = [eng.submit(p, sp(max_new_tokens=GEN)) for p in prompts]
        for _ in range(32):
            eng.step()
            if any(r.tokens for r in eng.running.values()):
                break
        eng._preempt_one({"preempted": 0})
        if port:
            victim = next(r for r in reqs if r.n_preempted == 1)
            assert victim.swap is not None and victim.slot is None
        eng.run()
        assert eng.n_preemptions == 1
        assert sum(r.n_preempted for r in reqs) == 1
        assert all(r.status is Status.FINISHED and r.swap is None
                   for r in reqs) if port else True
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1] == ref


def test_ssm_chunk_boundaries_are_invisible(models):
    """An O(1)-state family has no block math: any token budget is legal
    (the quantum floor is waived) and odd chunk splits change no token."""
    jcfg, cfg, pairs = models["ssm"]
    jparams, params = pairs["dense"]
    prompts = _prompts(cfg, 2, P_LEN, seed=5)
    kw = dict(ENGINE, token_budget=5)            # < CHUNK_QUANTUM: ssm only
    want, _ = _jax_streams(jcfg, jparams, prompts, **kw)
    engine = ServingEngine(cfg, params, device="cpu", **kw)
    assert engine.token_budget == 5
    assert engine.chunk_quantum == 5             # widened to the budget
    reqs = _serve(engine, prompts, GEN)
    assert [r.tokens for r in reqs] == want == \
        _lockstep(cfg, params, prompts, GEN)
    assert max(r.metrics.prefill_chunks for r in reqs) > 1
    dense_cfg = dataclasses.replace(configs.get_smoke("llama-paper"),
                                    n_layers=1, remat=False)
    with pytest.raises(ValueError, match="quantum|budget"):
        ServingEngine(dense_cfg, {"embed": torch.zeros(1)}, device="cpu",
                      token_budget=5)


# ----------------------------------------------- family admission rules ---
def test_ssm_coerces_layout_and_rejects_embeds(models):
    _, cfg, pairs = models["ssm"]
    engine = ServingEngine(cfg, pairs["dense"][1], device="cpu", n_slots=2,
                           max_len=32, kv_layout="paged")   # nothing to page
    assert engine.kv_layout == "slot"
    assert engine.stats()["pool"]["layout"] == "state"
    with pytest.raises(ValueError, match="embeds"):
        engine.submit([1, 2, 3], SamplingParams(max_new_tokens=2),
                      embeds=np.zeros((4, cfg.d_model), np.float32))


def test_hybrid_requires_shared_attention(models):
    _, cfg, pairs = models["hybrid"]
    with pytest.raises(ValueError, match="attn_every"):
        ServingEngine(dataclasses.replace(cfg, attn_every=0),
                      pairs["dense"][1], device="cpu", n_slots=2, max_len=32)


@pytest.mark.parametrize("family", list(ARCHS))
def test_int8_kv_refused(models, family):
    _, cfg, pairs = models[family]
    for layout in ("slot", "paged"):
        with pytest.raises(ValueError, match="kv_dtype"):
            ServingEngine(cfg, pairs["dense"][1], device="cpu", n_slots=2,
                          max_len=32, kv_layout=layout, kv_dtype="int8")


# ------------------------------------ RecurrentStatePool lifecycle walk ---
def _tiny_pools(n_slots=4):
    return (RecurrentStatePool(None, n_slots, 32, lambda _c, n: [
                (torch.zeros((n, 2, 3)), torch.full((n, 3), -1.0))]),
            JaxStatePool(None, n_slots, 32, lambda _c, n: [
                (jnp.zeros((n, 2, 3)), jnp.full((n, 3), -1.0))]))


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_recurrent_pool_invariant_walk(seed):
    """A random alloc/release/save/restore/adopt/advance walk, replayed on
    the port's pool and the JAX pool: the free lists, positions and state
    contents stay equal, slot ids are stable, double frees raise, and a
    save/restore round trip is bitwise."""
    rng = random.Random(seed)
    pool, jpool = _tiny_pools()
    held, saved = [], {}
    for _ in range(30):
        op = rng.choice(["alloc", "release", "save", "restore", "adopt",
                         "advance"])
        if op == "alloc":
            slot = pool.alloc()
            assert slot == jpool.alloc()
            if len(held) == pool.n_slots:
                assert slot is None
            else:
                assert slot is not None and slot not in held
                held.append(slot)
        elif op == "release" and held:
            slot = held.pop(rng.randrange(len(held)))
            pool.release(slot)
            jpool.release(slot)
            saved.pop(slot, None)
            with pytest.raises(DoubleFree):
                pool.release(slot)
        elif op == "save" and held:
            slot = rng.choice(held)
            saved[slot] = (pool.save_slot(slot), jpool.save_slot(slot),
                           [a[slot].clone()
                            for a in state_leaves(pool.states)])
        elif op == "restore" and saved:
            slot = rng.choice(list(saved))
            blob, jblob, want = saved[slot]
            pool.restore_slot(slot, blob)
            jpool.restore_slot(slot, jblob)
            for g, w in zip(state_leaves(pool.states), want):
                assert torch.equal(g[slot], w)
        elif op == "adopt":
            pool.adopt([tuple(a + 1.0 for a in layer)
                        for layer in pool.states])
            jpool.adopt(jax.tree.map(lambda a: a + 1.0, jpool.states))
        elif op == "advance" and held:
            ends = [rng.randrange(32) for _ in held]
            pool.advance_prefill(held, ends)
            jpool.advance_prefill(held, ends)
            mask = np.zeros((pool.n_slots,), bool)
            mask[held] = True
            pos = pool.pos.copy()
            pool.advance_decode(mask)
            jpool.advance_decode(mask)
            assert np.array_equal(pool.pos, pos + mask)
        assert pool.n_free == jpool.n_free == pool.n_slots - len(held)
        assert pool._free == list(jpool._free)
        assert pool.pos.tolist() == np.asarray(jpool.pos).tolist()
        for a, b in zip(state_leaves(pool.states),
                        jax.tree.leaves(jpool.states)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(held + pool._free) == list(range(pool.n_slots))
    assert pool.stats() == jpool.stats()


# ------------------------------------------------- tracing and the CLI ---
@pytest.mark.parametrize("family", list(ARCHS))
def test_traced_engine_costs_recurrent_state(models, family):
    """Under a tracer the streams are unchanged and every model call is
    costed: weights (the projections a step reads), plus each lane's
    recurrent state read and written, plus (hybrid) the shared attention's
    KV."""
    _, cfg, pairs = models[family]
    params = pairs["sparse"][1]
    prompts = _prompts(cfg, 3, P_LEN, seed=1)
    plain = _serve(ServingEngine(cfg, params, device="cpu", **ENGINE),
                   prompts, GEN)
    tracer = ServingTracer()
    engine = ServingEngine(cfg, params, device="cpu", tracer=tracer,
                           **ENGINE)
    traced = _serve(engine, prompts, GEN)
    assert [r.tokens for r in traced] == [r.tokens for r in plain]
    kept, w_bytes = step_cost.weight_totals(params, cfg)
    state_bytes, rec_flops = step_cost.recurrent_state(cfg)
    assert kept > 0 and w_bytes > 0 and state_bytes > 0 and rec_flops > 0
    variants = list(tracer._variants.values())
    assert {v["kind"] for v in variants} == {"step", "decode"}
    for v in variants:
        assert v["costed"] and v["calls"] > 0
        assert v["bytes_accessed"] >= v["calls"] * (w_bytes + 2 * state_bytes)
        assert v["flops"] >= v["calls"] * 2 * kept
    n_attn = step_cost.attention_layers(cfg)
    assert n_attn == (0 if family == "ssm" else cfg.n_layers // cfg.attn_every)


def test_step_cost_counts_the_projections_a_step_reads(models):
    """xlstm: an mLSTM layer's six projections, an sLSTM layer's four
    (``r_gates`` among them); zamba: two a mamba layer and the shared
    block's seven once per application."""
    _, cfg, pairs = models["ssm"]
    p = pairs["dense"][1]
    want = sum(lp[n].numel() for i, lp in enumerate(p["layers"])
               for n in (step_cost.SLSTM_PROJECTIONS if i % 2 == 1
                         else step_cost.MLSTM_PROJECTIONS))
    assert step_cost.weight_totals(p, cfg)[0] == want
    _, cfg, pairs = models["hybrid"]
    p = pairs["dense"][1]
    shared = sum(p["shared_attn"][n].numel()
                 for n in step_cost.PROJECTIONS)
    want = sum(lp["in_proj"].numel() + lp["out_proj"].numel()
               for lp in p["mamba"]) + 2 * shared
    assert step_cost.weight_totals(p, cfg)[0] == want


@pytest.mark.parametrize("args", [
    ["--arch", "xlstm-350m"],
    ["--arch", "xlstm-350m", "--kv-layout", "paged"],
    ["--arch", "zamba2-2.7b"],
    ["--arch", "zamba2-2.7b", "--kv-layout", "paged", "--block-size", "8"]])
def test_serve_cli_serves_recurrent_families(args, capsys):
    """``--arch xlstm-350m`` / ``zamba2-2.7b`` with ``--smoke-arch`` serve
    through the engine, 8:16 weights; the hybrid's slot and paged samples
    agree; ssm prints its state slots."""
    reqs = serve.main(args + ["--smoke-arch", "--device", "cpu", "--batch",
                              "2", "--prompt-len", "12", "--gen", "3",
                              "--sparse"])
    out = capsys.readouterr().out
    assert len(reqs) == 2 and all(len(r.tokens) == 3 for r in reqs)
    assert "sparse deploy:" in out
    assert ("state slots:" in out) == ("xlstm" in args[1])
    layout = "paged" if "zamba" in args[1] and "paged" in args else "slot"
    assert f"engine[{layout}]" in out


def test_one_shot_hybrid_path(models):
    """The one-shot path the reference's ``serve --legacy`` takes
    (``tests/test_serving.py``'s hybrid case): prefill, ``grow_caches`` of
    the per-application KV, then decode; finite tokens of the right
    shape, equal to the engine's."""
    _, cfg, pairs = models["hybrid"]
    params = pairs["dense"][1]
    prompts = _prompts(cfg, 2, 8, seed=9)
    toks = _lockstep(cfg, params, prompts, 3)
    assert np.asarray(toks).shape == (2, 3)
    engine = ServingEngine(cfg, params, device="cpu", n_slots=2, max_len=11)
    assert [r.tokens for r in _serve(engine, prompts, 3)] == toks
