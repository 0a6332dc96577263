"""The port's speculative ``ServingEngine`` against the JAX package's, on the
reference test's tiny config (2 layers, d_model 128, vocab 512) at f32 with
the JAX weights carried over by ``interchange``.

Four JAX speculative engine runs, computed once for the module:

  dense target, a draft model of another init, paged layout;
  densified target, its 8:16+16:256 sparse draft, slot layout;
  sparse target, n-gram drafting, paged layout;
  dense target, a draft model of another init, slot layout, int8 KV.

For each, the port's speculative greedy streams must equal the port's
plain engine's and JAX's speculative engine's; ``stats()["speculative"]``
must equal JAX's dict, and each request's ``spec_drafted``,
``spec_accepted`` and ``draft_k`` JAX's.  Then port-only tests:
preemption mid-speculation, copy-on-write across the verify write range,
prefix-cache hits, the budget reserve, the adaptive k walk, the tracer's
spans and ``jit:draft_*`` attribution, and the CLI's spec line.
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
from repro.models.sparse_serving import densify_params as jax_densify  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import \
    SpeculativeConfig as JaxSpeculativeConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import (PagedKVPool, PagedPoolView,  # noqa: E402
                                 SamplingParams, ServingEngine,
                                 ServingTracer, SpeculativeConfig, Status)

SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
             d_ff=256, vocab=512)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-spec", remat=False, dtype=jnp.float32,
                           **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"), name="torch-spec",
                          dtype=torch.float32, **SHAPE)
ENGINE = dict(n_slots=4, max_len=48)
GEN = 10
# the four JAX runs: (target, proposer, layout, kv_dtype)
CASES = [("dense", "other", "paged", "bf16"),
         ("densified", "sparse", "slot", "bf16"),
         ("sparse", "ngram", "paged", "bf16"),
         ("dense", "other", "slot", "int8")]



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread each, so several test workers on
    one machine do not oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _prompts():
    """Two random prompts and one periodic one (n-gram matches exist)."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, CFG.vocab, 16).tolist(),
            rng.integers(0, CFG.vocab, 21).tolist(),
            ([5, 6, 7, 8] * 5)[:18]]


@pytest.fixture(scope="module")
def params():
    """name -> (JAX params, port params on the CPU)."""
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    other = jax_tfm.init_params(jax.random.PRNGKey(7), JCFG)
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    sparse, _ = jax_sparsify(dense, scfg)
    out = {"dense": dense, "other": other, "sparse": sparse,
           "densified": jax_densify(sparse)}
    return {k: (v, from_jax_params(v, device="cpu")) for k, v in out.items()}


def _draft(proposer, params, k=3):
    if proposer == "ngram":
        return (JaxSpeculativeConfig(k=k, method="ngram"),
                SpeculativeConfig(k=k, method="ngram"))
    jp, tp = params[proposer]
    return (JaxSpeculativeConfig(k=k, method="model", params=jp, cfg=JCFG),
            SpeculativeConfig(k=k, method="model", params=tp, cfg=CFG))


def _run_port(p, prompts=None, gen=GEN, draft=None, samplings=None, **kw):
    kw = dict(ENGINE, **kw)
    engine = ServingEngine(CFG, p, device="cpu", draft=draft, **kw)
    prompts = prompts or _prompts()
    samplings = samplings or \
        [SamplingParams(max_new_tokens=gen)] * len(prompts)
    reqs = [engine.submit(q, s) for q, s in zip(prompts, samplings)]
    engine.run()
    assert all(r.status is Status.FINISHED for r in reqs)
    return engine, reqs


@pytest.fixture(scope="module")
def jax_runs(params):
    """case -> (stats()["speculative"], [(tokens, drafted, accepted,
    draft_k)]) of the JAX speculative engine."""
    out = {}
    for case in CASES:
        target, proposer, layout, kv_dtype = case
        jd, _ = _draft(proposer, params)
        engine = JaxServingEngine(JCFG, params[target][0], draft=jd,
                                  kv_layout=layout, kv_dtype=kv_dtype,
                                  **ENGINE)
        reqs = [engine.submit(q, JaxSamplingParams(max_new_tokens=GEN))
                for q in _prompts()]
        engine.run()
        out[case] = (engine.stats()["speculative"],
                     [(list(r.tokens), r.metrics.spec_drafted,
                       r.metrics.spec_accepted, r.draft_k) for r in reqs])
    return out


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_streams_and_stats_match_jax(case, params, jax_runs):
    target, proposer, layout, kv_dtype = case
    _, td = _draft(proposer, params)
    tp = params[target][1]
    _, plain = _run_port(tp, kv_layout=layout, kv_dtype=kv_dtype)
    engine, reqs = _run_port(tp, draft=td, kv_layout=layout,
                             kv_dtype=kv_dtype)
    jax_stats, jax_reqs = jax_runs[case]
    assert [r.tokens for r in reqs] == [r.tokens for r in plain]
    assert [(r.tokens, r.metrics.spec_drafted, r.metrics.spec_accepted,
             r.draft_k) for r in reqs] == jax_reqs
    assert engine.stats()["speculative"] == jax_stats
    assert jax_stats["drafted"] > 0
    for r, p in zip(reqs, plain):
        assert len(r.logprobs) == len(r.tokens)
        np.testing.assert_allclose(r.logprobs, p.logprobs, atol=1e-5)


def test_densified_pair_accepts_nearly_everything(params, jax_runs):
    """The paper's pair: the sparse draft runs the compressed containers,
    the target their densification, and agrees almost everywhere."""
    st, _ = jax_runs[("densified", "sparse", "slot", "bf16")]
    assert st["acceptance_rate"] > 0.9 and st["accepted_per_step"] > 1.0


def test_other_draft_exercises_rollback(jax_runs):
    """A draft of another init disagrees with the target: verification
    rejects and the cursors roll back."""
    st, _ = jax_runs[("dense", "other", "paged", "bf16")]
    assert st["accepted"] < st["drafted"]


def test_preemption_mid_speculation(params):
    """A paged arena too small for every request's speculative burst:
    the k+1-token ``prepare_decode`` preempts mid-speculation, the drafter
    resets the slot on re-admission, and every stream is unchanged."""
    tp = params["dense"][1]
    prompts = [np.random.default_rng(s).integers(0, CFG.vocab, 16).tolist()
               for s in range(4)]
    _, base = _run_port(tp, prompts)
    _, td = _draft("other", params, k=4)
    engine, reqs = _run_port(tp, prompts, draft=td, kv_layout="paged",
                             block_size=4, n_blocks=24, prefix_caching=False)
    assert engine.n_preemptions > 0
    assert [r.tokens for r in reqs] == [r.tokens for r in base]


def test_verify_write_range_copies_shared_blocks_on_write():
    """A verify writes k+1 positions: ``prepare_decode(rows, n_tokens)``
    copies every shared block of [pos, pos + n) on write and appends the
    missing ones, and the verify-shaped view writes exactly the pairs
    i < n_new of each lane, into the row's private blocks."""
    pool = PagedKVPool(CFG, 2, 32, device="cpu", block_size=4, n_blocks=12,
                       prefix_caching=False)
    k0 = torch.randn(pool.k.shape, generator=torch.Generator().manual_seed(0))
    pool.k.copy_(k0)
    row, _ = pool.admit(list(range(10)))
    pool.advance_prefill([row], [10])
    child = pool.fork(row)                     # shares blocks 0..2
    shared = list(pool.tables[row].blocks)
    # the first writer of a shared block takes the copy
    pool.prepare_decode([child, row], [5, 1])  # child writes [10, 15)
    mine = pool.tables[child].blocks
    assert pool.tables[row].blocks == shared
    assert mine[:2] == shared[:2] and mine[2] not in shared
    assert len(mine) == 4
    # the copy carries the parent's written positions 8, 9 of block 2
    torch.testing.assert_close(pool.k[:, mine[2], :2], k0[:, shared[2], :2])
    view = PagedPoolView.build(pool.k, pool.v, pool.lane_tables(
        [row, child], 2), [10, 10], [1, 5], 8, trash=pool.trash_block)
    assert view.write_src.tolist() == [0, 8, 9, 10, 11, 12]
    bs = pool.block_size
    assert view.write_dst.tolist() == [
        shared[2] * bs + 2, mine[2] * bs + 2, mine[2] * bs + 3,
        mine[3] * bs, mine[3] * bs + 1, mine[3] * bs + 2]


def test_prefix_hits_under_speculation(params):
    """Requests whose prompts are one full-block prompt: the repeats hit
    the prefix cache (their recomputed tail's block copied on write at
    admission) and every stream is the plain engine's."""
    tp = params["dense"][1]
    prompt = np.random.default_rng(3).integers(0, CFG.vocab, 16).tolist()
    waves = [[prompt], [prompt], [prompt + [9, 8, 7]]]
    kw = dict(kv_layout="paged", block_size=8)

    def drive(draft):
        engine = ServingEngine(CFG, tp, device="cpu", draft=draft,
                               **dict(ENGINE, **kw))
        cows = []
        cow = engine.pool.blocks.copy_on_write
        engine.pool.blocks.copy_on_write = lambda b: cows.append(b) or cow(b)
        streams = []
        for wave in waves:
            reqs = [engine.submit(q, SamplingParams(max_new_tokens=GEN))
                    for q in wave]
            engine.run()
            streams += [r.tokens for r in reqs]
        return engine, streams, cows

    _, base, _ = drive(None)
    _, td = _draft("other", params)
    engine, spec, cows = drive(td)
    assert spec == base
    pc = engine.stats()["pool"]["prefix_cache"]
    assert pc["hits"] >= 2 and pc["hit_tokens"] >= 16
    assert cows


def test_budget_reserve_charges_verify_tokens(params):
    """Each step reserves draft_k + 1 verify tokens per decoding request;
    a late prompt then chunks through the remainder and every stream is
    the plain engine's."""
    tp = params["dense"][1]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, CFG.vocab, n).tolist() for n in (16, 16, 24)]
    _, base = _run_port(tp, prompts, token_budget=16)
    _, td = _draft("other", params)
    engine = ServingEngine(CFG, tp, device="cpu", draft=td, token_budget=16,
                           **ENGINE)
    reqs = [engine.submit(q, SamplingParams(max_new_tokens=GEN))
            for q in prompts[:2]]
    reserved = []
    while engine.has_work:
        if engine.n_steps == 3:
            reqs.append(engine.submit(prompts[2],
                                      SamplingParams(max_new_tokens=GEN)))
        want = sum(r.draft_k + 1 for r in engine.running.values()
                   if r.status is Status.RUNNING)
        st = engine.step()
        assert st["spec_reserved"] == min(want, 16)
        assert st["prefill_tokens"] <= 16 - st["spec_reserved"]
        reserved.append(st["spec_reserved"])
    assert max(reserved) >= 2 * 2 and reqs[2].metrics.prefill_chunks > 1
    assert [r.tokens for r in reqs] == [r.tokens for r in base]


def test_adaptive_k_walks_with_acceptance(params):
    tp = params["dense"][1]
    up = SpeculativeConfig(k=2, min_k=1, max_k=8, method="model", params=tp)
    _, reqs = _run_port(tp, gen=16, max_len=64, draft=up)
    assert all(r.draft_k > 2 for r in reqs)
    down = SpeculativeConfig(k=4, min_k=1, max_k=8, method="model",
                             params=params["other"][1])
    _, reqs = _run_port(tp, gen=16, max_len=64, draft=down)
    assert any(r.draft_k < 4 for r in reqs)
    fixed = dataclasses.replace(down, adaptive=False)
    _, reqs = _run_port(tp, gen=16, max_len=64, draft=fixed)
    assert all(r.draft_k == 4 for r in reqs)


def test_stochastic_speculation_is_keyed_and_valid(params):
    """Sampled rows speculate too: the leave-one-in draws are keyed by
    (seed, token index), so a run repeats itself, another seed differs,
    and every token and logprob is valid."""
    tp = params["dense"][1]
    _, td = _draft("other", params)

    def run(seed):
        sp = [SamplingParams(max_new_tokens=GEN, temperature=0.8, top_k=20,
                             seed=seed + i) for i in range(3)]
        engine, reqs = _run_port(tp, draft=td, samplings=sp,
                                 kv_layout="paged")
        assert engine.stats()["speculative"]["drafted"] > 0
        return [r.tokens for r in reqs], [r.logprobs for r in reqs]
    toks, lps = run(0)
    assert run(0) == (toks, lps)
    assert run(100)[0] != toks
    assert all(len(t) == GEN and all(0 <= x < CFG.vocab for x in t)
               for t in toks)
    assert all(lp <= 1e-6 for row in lps for lp in row)


def test_tracer_spans_and_draft_attribution(params):
    tp = params["sparse"][1]
    tracer = ServingTracer()
    draft = SpeculativeConfig(k=3, method="model", params=tp)
    engine, reqs = _run_port(tp, draft=draft, tracer=tracer,
                             kv_layout="paged")
    names = {e["name"] for e in tracer.buffer.events}
    assert {"draft", "verify", "emit", "jit:step", "jit:draft_step",
            "jit:draft_decode"} <= names
    attr = tracer.attribution()
    kinds = {v["kind"] for v in attr.values()}
    assert {"step", "draft_step", "draft_decode"} <= kinds
    calls = sum(v["calls"] for v in attr.values())
    drafter = engine.spec.drafter.adapter
    assert calls == engine.adapter.n_model_calls + drafter.n_model_calls
    # a draft call is costed by the draft's own weights and arena
    for v in attr.values():
        assert v["flops"] > 0 and v["bytes_accessed"] > 0
    text = tracer.counters_text()
    for name in ("serving_spec_tokens_drafted_total",
                 "serving_spec_tokens_accepted_total",
                 "serving_spec_tokens_emitted_total",
                 "serving_spec_acceptance_rate"):
        assert name in text
    assert [r.tokens for r in reqs] == \
        [r.tokens for r in _run_port(tp, kv_layout="paged")[1]]


def test_draft_params_on_another_device_raise(params):
    meta = {"embed": torch.empty((CFG.vocab, 1), device="meta")}
    with pytest.raises(ValueError, match="draft params live on meta"):
        ServingEngine(CFG, params["dense"][1], device="cpu", **ENGINE,
                      draft=SpeculativeConfig(method="model", params=meta))


@pytest.mark.parametrize("draft", ["ngram", "self", "sparse"])
def test_cli_spec_line(draft, capsys):
    serve.main(["--arch", "llama-paper", "--smoke-arch", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--gen", "6",
                "--kv-layout", "paged", "--block-size", "8",
                "--draft", draft, "--spec-k", "3"])
    out = capsys.readouterr().out
    method = "ngram" if draft == "ngram" else "model"
    assert f"speculative[{method} k=3]: acceptance" in out
    if draft == "self":
        assert "acceptance 1.00" in out
