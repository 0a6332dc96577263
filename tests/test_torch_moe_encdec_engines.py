"""The port's ``ServingEngine`` on the moe and encdec families against the
JAX package's engine, at f32 on the smoke twins (mixtral-8x7b-smoke and
llama4-maverick-400b-a17b-smoke: moe; whisper-medium-smoke: encdec), with
the JAX weights carried over by ``interchange``:

  * moe: greedy streams identical to the JAX engine's on the slot layout,
    the paged layout and the paged layout with int8 KV, dense and
    8:16+16:256 weights, and to the port's lock-step loop;
  * encdec: streams identical to the JAX engine's with encoder lengths
    below and at ``max_ctx``, dense and 8:16+16:256 weights, and to the
    lock-step loop; a forced preemption resumes exactly (context rows, KV
    and position swapped out and back: ``tests/test_family_engines.py``'s
    ``test_preempt_resume_exact``); the three refusals of
    ``test_encdec_requires_embeds_and_bounds_ctx``, int8 KV refused, and
    ``embeds`` refused by a moe engine;
  * a 2-replica ``ReplicaSet`` serving encdec with ``embeds=``: streams
    equal one engine's;
  * every request tagged with its family, and ``summarize``'s
    ``"families"`` block against the reference's
    (``tests/test_observe.py``'s ``test_summarize_mixed_family_keys``);
  * the traced engines' per-variant cost (``launch/step_cost.py``: routed
    experts, cross-attention, the "encode" calls) and the serve CLI on the
    three archs.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.runtime import metrics as jax_metrics  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import step_cost  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.runtime import metrics  # noqa: E402
from repro_torch.serving import (ReplicaSet, SamplingParams,  # noqa: E402
                                 ServingEngine, ServingTracer, Status)

ARCHS = {"mixtral": "mixtral-8x7b", "maverick": "llama4-maverick-400b-a17b",
         "whisper": "whisper-medium"}
GEN, P_LEN, MAX_CTX = 5, 12, 7
ENGINE = dict(n_slots=4, max_len=P_LEN + GEN, token_budget=8)
MOE_LAYOUTS = {"slot": {}, "paged": dict(kv_layout="paged", block_size=4),
               "paged_int8": dict(kv_layout="paged", block_size=4,
                                  kv_dtype="int8")}


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
    """name: (jcfg, cfg, {weights: (JAX params, port params)})."""
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    out = {}
    for i, (name, arch) in enumerate(ARCHS.items()):
        jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                                   dtype=jnp.float32, remat=False)
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  dtype=torch.float32, remat=False)
        dense = jax_get_model(jcfg).init(jax.random.PRNGKey(60 + i))
        sparse, rep = jax_sparsify(dense, scfg)
        assert rep["n_layers_sparsified"] > 0
        out[name] = (jcfg, cfg, {
            "dense": (dense, from_jax_params(dense, "cpu")),
            "sparse": (sparse, from_jax_params(sparse, "cpu"))})
    return out


def _prompts(cfg, n, seed, length=P_LEN):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (n, length)).tolist()


def _embeds(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, cfg.d_model)).astype(np.float32)
            for n in lens]


def _serve(engine, prompts, embeds=None, sampling=SamplingParams):
    embeds = embeds or [None] * len(prompts)
    reqs = [engine.submit(p, sampling(max_new_tokens=GEN), embeds=e)
            for p, e in zip(prompts, embeds)]
    engine.run(max_steps=200)
    return reqs


def _lockstep(cfg, params, prompts, embeds=None):
    """The port's one-shot loop: batched ``prefill`` + greedy
    ``decode_lockstep`` (the encoder's ``embeds`` in the batch, one
    length for every row)."""
    zoo = model_zoo.get_model(cfg, "cpu")
    toks = torch.tensor(prompts)
    batch = {"tokens": toks}
    if embeds is not None:
        batch["embeds"] = torch.from_numpy(np.stack(embeds))
    with torch.no_grad():
        logits, caches = zoo.prefill(params, batch)
        caches = model_zoo.grow_caches(caches, toks.shape[1] + GEN)
        tok = logits.argmax(-1)[:, None]
        outs = [tok]
        for _ in range(GEN - 1):
            logits, caches = zoo.decode(params, caches, {"tokens": tok})
            tok = logits.argmax(-1)[:, None]
            outs.append(tok)
    return torch.cat(outs, 1).tolist()


# ------------------------------------------------------------------ moe ---
@pytest.mark.parametrize("which", ["dense", "sparse"])
@pytest.mark.parametrize("layout", list(MOE_LAYOUTS))
@pytest.mark.parametrize("name", ["mixtral", "maverick"])
def test_moe_engine_matches_jax(models, name, layout, which):
    jcfg, cfg, pairs = models[name]
    jparams, params = pairs[which]
    prompts = _prompts(cfg, 3, seed=1)
    kw = dict(ENGINE, **MOE_LAYOUTS[layout])
    jengine = JaxServingEngine(jcfg, jparams, **kw)
    want = [r.tokens for r in _serve(jengine, prompts,
                                     sampling=JaxSamplingParams)]
    engine = ServingEngine(cfg, params, device="cpu", **kw)
    reqs = _serve(engine, prompts)
    assert [r.tokens for r in reqs] == want
    assert all(r.status is Status.FINISHED for r in reqs)
    assert all(r.metrics.family == "moe" for r in reqs)
    if layout == "slot":
        assert want == _lockstep(cfg, params, prompts)
    st, jst = engine.stats(), jengine.stats()
    assert st["family"] == jst["family"] == "moe"
    assert st["n_steps"] == jst["n_steps"]
    assert st["pool"] == jst["pool"]


def test_moe_engine_refuses_embeds(models):
    _, cfg, pairs = models["mixtral"]
    engine = ServingEngine(cfg, pairs["dense"][1], device="cpu", n_slots=2,
                           max_len=32)
    with pytest.raises(ValueError, match="embeds"):
        engine.submit([1, 2, 3], SamplingParams(max_new_tokens=2),
                      embeds=np.zeros((4, cfg.d_model), np.float32))


# --------------------------------------------------------------- encdec ---
CTX_LENS = {"below": [3, 5, 6], "at": [MAX_CTX] * 3}


@pytest.mark.parametrize("which", ["dense", "sparse"])
@pytest.mark.parametrize("ctx", list(CTX_LENS))
def test_encdec_engine_matches_jax(models, ctx, which):
    """Chunked, continuously batched engine == the JAX engine, token for
    token, with encoder contexts shorter than the arena (rows past each
    length masked) and filling it; == the lock-step loop where every
    request's context has one length."""
    jcfg, cfg, pairs = models["whisper"]
    jparams, params = pairs[which]
    prompts = _prompts(cfg, 3, seed=2)
    embeds = _embeds(cfg, CTX_LENS[ctx], seed=3)
    kw = dict(ENGINE, max_ctx=MAX_CTX)
    jengine = JaxServingEngine(jcfg, jparams, **kw)
    want = [r.tokens for r in _serve(jengine, prompts, embeds,
                                     JaxSamplingParams)]
    engine = ServingEngine(cfg, params, device="cpu", **kw)
    reqs = _serve(engine, prompts, embeds)
    assert [r.tokens for r in reqs] == want
    assert all(r.status is Status.FINISHED and r.metrics.family == "encdec"
               for r in reqs)
    assert engine.adapter.n_encode_calls == len(prompts)
    if ctx == "at":
        assert want == _lockstep(cfg, params, prompts, embeds)
    st, jst = engine.stats(), jengine.stats()
    assert st["family"] == jst["family"] == "encdec"
    assert st["n_steps"] == jst["n_steps"]
    assert st["pool"] == jst["pool"]


def test_encdec_preempt_resume_exact(models):
    """A request preempted mid-generation and resumed reproduces the
    uninterrupted stream exactly: the adapter swaps its context rows,
    decoder KV and position out and back (no second encoder call); the
    JAX engine, preempted at the same step, emits the same tokens."""
    jcfg, cfg, pairs = models["whisper"]
    jparams, params = pairs["dense"]
    prompts = _prompts(cfg, 3, seed=4)
    embeds = _embeds(cfg, [MAX_CTX] * 3, seed=5)
    ref = _lockstep(cfg, params, prompts, embeds)
    streams = []
    kw = dict(ENGINE, max_ctx=MAX_CTX)
    for eng in (JaxServingEngine(jcfg, jparams, **kw),
                ServingEngine(cfg, params, device="cpu", **kw)):
        port = isinstance(eng, ServingEngine)
        sp = SamplingParams if port else JaxSamplingParams
        reqs = [eng.submit(p, sp(max_new_tokens=GEN), embeds=e)
                for p, e in zip(prompts, embeds)]
        for _ in range(32):
            eng.step()
            if any(r.tokens for r in eng.running.values()):
                break
        eng._preempt_one({"preempted": 0})
        if port:
            victim = next(r for r in reqs if r.n_preempted == 1)
            assert victim.swap is not None and victim.slot is None
            assert set(victim.swap) == {"ctx", "k", "v", "pos"}
        eng.run()
        assert eng.n_preemptions == 1
        if port:
            assert all(r.status is Status.FINISHED and r.swap is None
                       for r in reqs)
            assert eng.adapter.n_encode_calls == len(prompts)
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1] == ref


def test_encdec_refusals(models):
    """``embeds`` required, frames bounded by ``max_ctx``, no paged layout
    (the reference's three refusals), and no int8 KV."""
    _, cfg, pairs = models["whisper"]
    params = pairs["dense"][1]
    engine = ServingEngine(cfg, params, device="cpu", n_slots=2, max_len=32,
                           max_ctx=8)
    with pytest.raises(ValueError, match="embeds"):
        engine.submit([1, 2, 3], SamplingParams(max_new_tokens=2))
    with pytest.raises(ValueError, match="max_ctx"):
        engine.submit([1, 2, 3], SamplingParams(max_new_tokens=2),
                      embeds=np.zeros((9, cfg.d_model), np.float32))
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, params, device="cpu", n_slots=2, max_len=32,
                      kv_layout="paged")
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(cfg, params, device="cpu", n_slots=2, max_len=32,
                      kv_dtype="int8")
    # max_ctx defaults to max_len, as the reference's
    assert ServingEngine(cfg, params, device="cpu", n_slots=2,
                         max_len=32).adapter.ctx.max_ctx == 32


def test_encdec_fleet_matches_one_engine(models):
    """Two replicas behind the router, each request's ``embeds`` routed
    with it: the streams equal one engine's holding both replicas'
    slots."""
    _, cfg, pairs = models["whisper"]
    params = pairs["sparse"][1]
    prompts = _prompts(cfg, 6, seed=6)
    embeds = _embeds(cfg, [7, 4, 6, 7, 2, 5], seed=7)
    kw = dict(max_len=P_LEN + GEN, token_budget=8, max_ctx=MAX_CTX)
    fleet = ReplicaSet(cfg, params, n_replicas=2, routing="round_robin",
                       device="cpu", n_slots=2, **kw)
    got = _serve(fleet, prompts, embeds)
    assert all(e.adapter.n_encode_calls > 0 for e in fleet.replicas)
    one = _serve(ServingEngine(cfg, params, device="cpu", n_slots=4, **kw),
                 prompts, embeds)
    assert [r.tokens for r in got] == [r.tokens for r in one]
    assert all(r.status is Status.FINISHED for r in got)


# --------------------------------------------------------------- summary ---
def _req(mod, n_tokens, family=""):
    m = mod.RequestMetrics(family=family, arrival=0.0, admitted=0.1,
                           first_token=0.2, finished=1.0, n_tokens=n_tokens,
                           prefill_chunks=1)
    m.itl = [0.01 * (i + 1) for i in range(max(n_tokens - 1, 0))]
    return m


@pytest.mark.parametrize("families", [("dense", "ssm"), ("moe",),
                                      ("encdec", "moe", "dense"), ("",)])
def test_summarize_families_block(families):
    """Per-family requests, tokens, tok/s over the shared wall, TTFT and
    ITL percentiles: present for any named family, absent when every
    request's family is "", and equal to the reference's."""
    sizes = [4, 3, 6]
    reqs = [(f, sizes[i % 3]) for i, f in enumerate(families * 2)]
    s = metrics.summarize([_req(metrics, n, f) for f, n in reqs], 2.0)
    js = jax_metrics.summarize([_req(jax_metrics, n, f) for f, n in reqs],
                               2.0)
    named = {f for f in families if f}
    if not named:
        assert "families" not in s and "families" not in js
        return
    assert set(s["families"]) == named
    assert s["families"] == js["families"]
    for fam in named:
        sub = [n for f, n in reqs if f == fam]
        block = s["families"][fam]
        assert block["n_requests"] == len(sub)
        assert block["total_tokens"] == sum(sub)
        assert block["tok_per_s"] == sum(sub) / 2.0
        assert set(block["ttft"]) == set(block["itl"]) == {"p50", "p99"}


def test_engine_summary_has_the_family(models):
    _, cfg, pairs = models["maverick"]
    engine = ServingEngine(cfg, pairs["dense"][1], device="cpu", **ENGINE)
    reqs = _serve(engine, _prompts(cfg, 2, seed=8))
    s = metrics.summarize([r.metrics for r in reqs], 1.0)
    assert set(s["families"]) == {"moe"}
    assert s["families"]["moe"]["total_tokens"] == 2 * GEN


# ------------------------------------------------ tracing and the CLI ---
def test_traced_moe_engine_costs_routed_experts(models):
    """Under a tracer the streams are unchanged and each call's cost holds
    the routed experts: 2 flops a weight for T x k pairs, the bytes of
    min(E, T x k) experts a layer."""
    _, cfg, pairs = models["maverick"]
    params = pairs["sparse"][1]
    prompts = _prompts(cfg, 3, seed=9)
    plain = _serve(ServingEngine(cfg, params, device="cpu", **ENGINE),
                   prompts)
    tracer = ServingTracer()
    engine = ServingEngine(cfg, params, device="cpu", tracer=tracer,
                           **ENGINE)
    assert [r.tokens for r in _serve(engine, prompts)] == \
        [r.tokens for r in plain]
    kept, w_bytes = step_cost.weight_totals(params, cfg)
    lp = params["layers"][0]["moe"]
    assert kept > sum(params["layers"][0][n].nm_values.numel()
                      for n in ("wq", "wk", "wv", "wo"))
    flops1, bytes1 = step_cost.routed_experts(cfg, 1)
    per_expert = sum(lp[n][0].numel() for n in ("we_gate", "we_up",
                                                "we_down"))
    assert flops1 == cfg.n_layers * 2 * per_expert * cfg.moe.top_k
    assert bytes1 == cfg.n_layers * per_expert * 4          # f32 smoke
    E = cfg.moe.num_experts
    assert step_cost.routed_experts(cfg, 100)[1] == \
        cfg.n_layers * E * per_expert * 4
    variants = list(tracer._variants.values())
    assert {v["kind"] for v in variants} == {"step", "decode"}
    for v in variants:
        rows = int(np.prod(v["shapes"][-1]))
        f, b = step_cost.routed_experts(cfg, rows)
        assert v["flops"] >= v["calls"] * (2 * kept * rows + f)
        assert v["bytes_accessed"] >= v["calls"] * (w_bytes + b)


def test_traced_encdec_engine_attributes_encode_calls(models):
    """The encoder runs as "encode" calls (one a request), costed by
    ``encode_cost``; decoder calls add their cross-attention."""
    _, cfg, pairs = models["whisper"]
    params = pairs["sparse"][1]
    prompts = _prompts(cfg, 3, seed=10)
    embeds = _embeds(cfg, [7, 4, 7], seed=11)
    kw = dict(ENGINE, max_ctx=MAX_CTX)
    plain = _serve(ServingEngine(cfg, params, device="cpu", **kw), prompts,
                   embeds)
    tracer = ServingTracer()
    engine = ServingEngine(cfg, params, device="cpu", tracer=tracer, **kw)
    assert [r.tokens for r in _serve(engine, prompts, embeds)] == \
        [r.tokens for r in plain]
    enc = step_cost.weight_totals(params, cfg, kind="encode")
    dec = step_cost.weight_totals(params, cfg)
    n_enc = sum(lp[n].nm_values.numel() for lp in params["enc"]
                for n in step_cost.ENCODER_PROJECTIONS)
    assert enc[0] > n_enc and dec[0] > 0
    variants = list(tracer._variants.values())
    assert {v["kind"] for v in variants} == {"encode", "step", "decode"}
    encodes = [v for v in variants if v["kind"] == "encode"]
    assert sum(v["calls"] for v in encodes) == len(prompts)
    assert sorted(v["shapes"][0][1] for v in encodes) == [4, 7]
    for v in encodes:
        s_enc = v["shapes"][0][1]
        want = step_cost.encode_cost(cfg, enc, s_enc)
        assert v["flops"] == v["calls"] * want["flops"]
        assert v["bytes_accessed"] == v["calls"] * want["bytes_accessed"]
        assert want["flops"] > 2 * enc[0] * s_enc
    for v in variants:
        assert v["costed"]
        if v["kind"] != "encode":
            assert v["flops"] >= v["calls"] * 2 * dec[0]


@pytest.mark.parametrize("args", [
    ["--arch", "mixtral-8x7b"],
    ["--arch", "mixtral-8x7b", "--kv-layout", "paged", "--block-size", "8",
     "--kv-dtype", "int8"],
    ["--arch", "llama4-maverick-400b-a17b", "--kv-layout", "paged",
     "--block-size", "8"],
    ["--arch", "whisper-medium"],
    ["--arch", "whisper-medium", "--replicas", "2"]])
def test_serve_cli_serves_moe_and_encdec(args, capsys):
    """``--smoke-arch`` serves the three archs through the engine on 8:16
    weights (whisper's requests with random ``embeds``)."""
    reqs = serve.main(args + ["--smoke-arch", "--device", "cpu", "--batch",
                              "2", "--prompt-len", "8", "--gen", "3",
                              "--sparse"])
    out = capsys.readouterr().out
    assert len(reqs) == 2 and all(len(r.tokens) == 3 for r in reqs)
    assert "sparse deploy:" in out
    if "whisper-medium" in args:
        assert all(r.embeds is not None and len(r.embeds) == 8
                   for r in reqs)


def test_serve_cli_refuses_encdec_trace(tmp_path):
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "whisper-medium", "--smoke-arch",
                          "--trace", str(tmp_path / "t.json")])
