"""The port's serving observability (``serving/observe.py``) against the JAX
package's, on a 2-layer f32 llama-paper smoke model with JAX's weights
carried across by ``interchange``.

Both engines serve the same prompts, all submitted at once, under a
virtual clock advanced only between steps, so both traces are exact:

- the traced port engine's greedy streams equal the untraced port's and
  the JAX engine's;
- the "requests" process's events equal JAX's event for event (names,
  tids, timestamps, args);
- the "engine" process's events equal JAX's but for the model calls'
  variant ids (``jit:*`` spans, compile and retrace instants) and their
  cost fields (XLA's figure against ``launch/step_cost.py``'s);
- the counter registries' snapshots are equal but for ``serving_jit_*``
  (a compile per jitted variant against a first call per shape variant).

Then the preemption and prefix-hit lifecycles of ``tests/test_observe.py``,
the null tracer (the default; no synchronize and no CUDA event on its
path), the blocking order of ``jit_call`` and the cost function against a
hand count.  Token streams are compared exactly, events and snapshots with
``==`` (the virtual clock makes every timestamp exact).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.runtime.telemetry import \
    validate_trace_events as jax_validate  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import ServingTracer as JaxServingTracer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.launch import step_cost  # noqa: E402
from repro_torch.models.sparse_serving import SparseWeight  # noqa: E402
from repro_torch.runtime.telemetry import validate_trace_events  # noqa: E402
from repro_torch.serving import (NULL_TRACER, NullTracer,  # noqa: E402
                                 SamplingParams, ServingEngine,
                                 ServingTracer, Status)
from repro_torch.serving.observe import NULL_SPAN  # noqa: E402

SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
             d_ff=256, vocab=512)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-observe", remat=False,
                           dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-observe", dtype=torch.float32, **SHAPE)
GEN = 6
# the model calls' variant ids and cost fields differ by design (module
# docstring); every other field of every event is compared
JIT_ARGS = ("variant", "flops", "bytes_accessed")


@pytest.fixture(scope="module")
def param_pairs():
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    sparse, report = jax_sparsify(dense, scfg)
    assert report["n_layers_sparsified"] > 0
    return {"dense": (dense, from_jax_params(dense, device="cpu")),
            "sparse": (sparse, from_jax_params(sparse, device="cpu"))}


def _prompts(n, length, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, length).tolist() for _ in range(n)]


def _serve(make, sampling, prompts, gen, traced, waves=1, **kw):
    """Serve ``prompts`` (in ``waves`` submitted one after another, each
    once the engine drained) under a virtual clock that moves 1 s between
    steps.  Returns (engine, tracer or None, requests)."""
    t = [0.0]
    tracer = make[1]() if traced else None
    engine = make[0](tracer=tracer, clock=lambda: t[0], **kw)
    reqs = []
    per = len(prompts) // waves
    for w in range(waves):
        reqs += [engine.submit(p, sampling(max_new_tokens=gen))
                 for p in prompts[w * per:(w + 1) * per]]
        while engine.has_work:
            engine.step()
            t[0] += 1.0
    return engine, tracer, reqs


def _pair(param_pairs, which, prompts, gen, waves=1, **kw):
    """The JAX engine traced, the port's traced and untraced."""
    jparams, tparams = param_pairs[which]
    jax_make = (lambda **a: JaxServingEngine(JCFG, jparams, **a),
                JaxServingTracer)
    port_make = (lambda **a: ServingEngine(CFG, tparams, device="cpu", **a),
                 ServingTracer)
    jax_run = _serve(jax_make, JaxSamplingParams, prompts, gen, True,
                     waves, **kw)
    port_run = _serve(port_make, SamplingParams, prompts, gen, True, waves,
                      **kw)
    plain_run = _serve(port_make, SamplingParams, prompts, gen, False,
                       waves, **kw)
    return jax_run, port_run, plain_run


def _strip(ev):
    """An event without the model calls' variant ids and cost fields."""
    ev = dict(ev)
    if ev.get("cat") == "jit" or ev.get("name") in ("compile", "retrace"):
        ev["args"] = {k: v for k, v in ev.get("args", {}).items()
                      if k not in JIT_ARGS}
    return ev


def _events(tracer, pid):
    return [e for e in tracer.buffer.events if e["pid"] == pid]


def _summaries(tracer):
    return {e["args"]["id"]: e["args"] for e in tracer.buffer.events
            if e.get("name") == "request_summary"}


def _check_lifecycle_agreement(tracer, reqs):
    """Every request_summary restates its request's RequestMetrics
    (tests/test_observe.py's check)."""
    summaries = _summaries(tracer)
    for r in reqs:
        m, s = r.metrics, summaries[r.request_id]
        assert s["status"] == r.status.value
        assert s["admitted"] == m.admitted
        assert s["first_token"] == m.first_token
        assert s["finished"] == m.finished
        assert s["n_tokens"] == m.n_tokens == len(r.tokens)
        assert s["prefill_chunks"] == m.prefill_chunks
        assert s["n_preemptions"] == m.n_preemptions
        assert s["last_preempt_reason"] == m.last_preempt_reason


def _check_against_jax(jax_run, port_run, plain_run):
    (jengine, jtr, jreqs), (tengine, ttr, treqs) = jax_run, port_run
    _, _, preqs = plain_run
    for j, t, p in zip(jreqs, treqs, preqs):
        assert t.status is Status.FINISHED
        assert t.tokens == p.tokens, "tracing changed the token stream"
        assert t.tokens == j.tokens, f"request {t.request_id} diverged"
    _check_lifecycle_agreement(ttr, treqs)
    assert (ttr._pid_engine, ttr._pid_requests) == \
        (jtr._pid_engine, jtr._pid_requests)
    assert _events(ttr, ttr._pid_requests) == _events(jtr, jtr._pid_requests)
    assert [_strip(e) for e in _events(ttr, ttr._pid_engine)] == \
        [_strip(e) for e in _events(jtr, jtr._pid_engine)]
    jsnap, tsnap = jtr.registry.snapshot(), ttr.registry.snapshot()
    assert {k: v for k, v in tsnap.items()
            if not k.startswith("serving_jit_")} == \
        {k: v for k, v in jsnap.items() if not k.startswith("serving_jit_")}
    assert set(tsnap) == set(jsnap)
    # both files load in both validators
    for tr in (jtr, ttr):
        obj = json.loads(json.dumps(tr.buffer.to_json()))
        assert len(validate_trace_events(obj)) == len(jax_validate(obj))


# --------------------------------------------------------------------------
# the port's traced engine against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("which", ["dense", "sparse"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_traced_engine_matches_jax(layout, which, kv_dtype, param_pairs):
    """Mixed prompt lengths under a 16-token budget chunk the long ones;
    four requests in three slots queue the last."""
    prompts = [p[:n] for p, n in zip(_prompts(4, 40), (12, 40, 9, 23))]
    runs = _pair(param_pairs, which, prompts, GEN, n_slots=3, max_len=64,
                 token_budget=16, kv_layout=layout, block_size=8,
                 kv_dtype=kv_dtype)
    _check_against_jax(*runs)
    ttr = runs[1][1]
    names = {e["name"] for e in ttr.buffer.events}
    assert {"step", "plan", "chunk", "decode", "emit", "queued", "prefill",
            "request_summary", "jit:step", "jit:decode"} <= names
    assert max(r.metrics.prefill_chunks for r in runs[1][2]) > 1


def test_preemption_lifecycle_matches_jax(param_pairs):
    """A starved paged arena preempts decoding requests back to the queue;
    the trace carries the preemption instants, and every event and counter
    equals the JAX engine's (tests/test_observe.py's scenario)."""
    prompts = _prompts(4, 16, seed=9)
    runs = _pair(param_pairs, "dense", prompts, 12, n_slots=4, max_len=40,
                 kv_layout="paged", block_size=8, n_blocks=10,
                 prefix_caching=False)
    _check_against_jax(*runs)
    engine, tracer, reqs = runs[1]
    assert engine.n_preemptions > 0
    summaries = _summaries(tracer)
    preempted = [r for r in reqs if r.metrics.n_preemptions > 0]
    assert preempted
    for r in preempted:
        assert summaries[r.request_id]["last_preempt_reason"] != ""
    ev_names = [(e["name"], e.get("cat")) for e in tracer.buffer.events]
    assert ("preempt", "engine") in ev_names
    assert ("preempted", "request") in ev_names
    total = sum(tracer.registry.snapshot()["serving_preemptions_total"]
                .values())
    assert total == engine.n_preemptions


def test_prefix_cache_hit_lifecycle_matches_jax(param_pairs):
    """The same prompt twice, the second after the first finished: the
    second hits the prefix cache; lookups, hits and cached tokens in the
    trace and the counters equal the JAX engine's."""
    prompt = _prompts(1, 16, seed=3)[0]
    runs = _pair(param_pairs, "dense", [prompt, prompt], GEN, waves=2,
                 n_slots=2, max_len=40, kv_layout="paged", block_size=8,
                 n_blocks=16, prefix_caching=True)
    _check_against_jax(*runs)
    engine, tracer, (r1, r2) = runs[1]
    assert r1.tokens == r2.tokens
    summaries = _summaries(tracer)
    assert summaries[r1.request_id]["cached_tokens"] == 0
    assert summaries[r2.request_id]["cached_tokens"] > 0
    reg, lb = tracer.registry, dict(engine=tracer.name, family="dense")
    assert reg.counter("serving_prefix_cache_lookups_total").get(**lb) == 2
    assert reg.counter("serving_prefix_cache_hits_total").get(**lb) == 1
    assert reg.counter("serving_prefix_cache_hit_tokens_total").get(**lb) \
        == summaries[r2.request_id]["cached_tokens"]
    hits = [e for e in tracer.buffer.events
            if e.get("name") == "prefix_cache" and e["args"]["hit"]]
    assert len(hits) == 1


def test_counters_and_attribution(param_pairs):
    prompts = _prompts(3, 16)
    t = [0.0]
    tracer = ServingTracer()
    engine = ServingEngine(CFG, param_pairs["dense"][1], device="cpu",
                           n_slots=3, max_len=32, kv_layout="paged",
                           block_size=8, tracer=tracer,
                           clock=lambda: t[0])
    reqs = [engine.submit(p, SamplingParams(max_new_tokens=GEN))
            for p in prompts]
    engine.run()
    lb = dict(engine=tracer.name, family="dense")
    reg = tracer.registry
    assert reg.counter("serving_tokens_decoded_total").get(**lb) == \
        sum(len(r.tokens) for r in reqs)
    assert reg.counter("serving_tokens_prefilled_total").get(**lb) == \
        sum(len(p) for p in prompts) == engine.stats()["n_prefill_tokens"]
    assert reg.counter("serving_requests_finished_total").get(
        status="finished", **lb) == len(reqs)
    assert reg.counter("serving_steps_total").get(**lb) == engine.n_steps
    attr = tracer.attribution()
    assert {v["kind"] for v in attr.values()} == {"step", "decode"}
    assert sum(v["calls"] for v in attr.values()) == \
        engine.adapter.n_model_calls
    for v in attr.values():
        assert v["calls"] > 0 and v["flops"] > 0 and v["bytes_accessed"] > 0
        assert v["issue_s"] == v["total_s"] == 0.0     # the virtual clock
    compiles = sum(reg.counter("serving_jit_compiles_total")
                   .series().values())
    retraces = sum(reg.counter("serving_jit_retraces_total")
                   .series().values())
    assert compiles + retraces == len(attr)
    assert compiles == 2                 # one per kind
    text = tracer.counters_text()
    assert "# TYPE serving_tokens_decoded_total counter" in text
    assert f'engine="{tracer.name}"' in text


# --------------------------------------------------------------------------
# the null tracer and the blocking order
# --------------------------------------------------------------------------

def test_null_tracer_is_default_and_allocation_free(param_pairs):
    engine = ServingEngine(CFG, param_pairs["dense"][1], device="cpu",
                           n_slots=2, max_len=32)
    assert engine.tracer is NULL_TRACER
    assert engine.adapter.tracer is NULL_TRACER
    t = NullTracer()
    assert t.enabled is False
    assert t.begin_step(3, 0.0) is NULL_SPAN
    assert t.begin_phase("plan", tokens=7) is NULL_SPAN
    assert t.attach(engine) is t
    assert t.end_phase() is None
    assert t.instant("x", a=1) is None
    assert t.jit_call("step", lambda a, b: a + b, (2, 3)) == 5
    with NULL_SPAN:
        pass


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_cpu_step_path_never_synchronizes(layout, traced, param_pairs,
                                          monkeypatch):
    """On the CPU neither the untraced nor the traced step path calls
    ``torch.cuda.synchronize`` or makes a CUDA event: both are patched to
    raise."""
    def boom(*a, **k):
        raise AssertionError("the step path touched the CUDA runtime")
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    engine = ServingEngine(CFG, param_pairs["dense"][1], device="cpu",
                           n_slots=2, max_len=32, kv_layout=layout,
                           tracer=ServingTracer() if traced else None)
    reqs = [engine.submit(p, SamplingParams(max_new_tokens=3))
            for p in _prompts(3, 9)]
    engine.run()
    assert all(r.status is Status.FINISHED for r in reqs)


def test_jit_call_blocks_before_the_second_clock_read(monkeypatch):
    """On the card the call's wall time ends after a synchronize, and
    issue_s ends when ``fn`` returned."""
    order = []
    reads = iter([10.0, 10.0, 10.25, 11.0])    # the first stamps "compile"

    def clock():
        order.append("clock")
        return next(reads)

    def fn(x):
        order.append("fn")
        return x
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: order.append(("sync", device)))
    tracer = ServingTracer(clock=clock)
    tracer.t0 = 10.0
    tracer._pid_engine = tracer._pid_requests = 1
    tracer._make_counters()
    tracer._device = torch.device("cuda", 0)
    assert tracer.jit_call("decode", fn, (np.zeros((4, 1)),)) is not None
    assert order == ["clock", "clock", "fn", "clock",
                     ("sync", torch.device("cuda", 0)), "clock"]
    rec = tracer.attribution()["decode#0"]
    assert rec["total_s"] == 1.0 and rec["issue_s"] == 0.25
    assert rec["flops"] is None               # no adapter: no cost


# --------------------------------------------------------------------------
# the cost of a step
# --------------------------------------------------------------------------

def _hand_weights(params):
    """Kept weights and bytes of the smoke model's projections, from the
    8:16 + 16:256 layout: values [out, in/2], 4-bit indices packed 8 to an
    int32 word ([out, in/16]), and where in % 256 == 0, 16 outliers of each
    256 columns with their 8-bit indices packed 4 to a word."""
    d, f, hd = SHAPE["d_model"], SHAPE["d_ff"], SHAPE["head_dim"]
    shapes = [(SHAPE["n_heads"] * hd, d), (SHAPE["n_kv_heads"] * hd, d),
              (SHAPE["n_kv_heads"] * hd, d), (d, SHAPE["n_heads"] * hd),
              (f, d), (f, d), (d, f)]
    elem = torch.finfo(CFG.dtype).bits // 8
    kept = nbytes = 0
    for out, k in shapes:
        kept += out * k // 2
        nbytes += out * k // 2 * elem + out * k // 16 * 4
        if k % 256 == 0:
            kept += out * k // 256 * 16
            nbytes += out * k // 256 * (16 * elem + 4 * 4)
    return SHAPE["n_layers"] * kept, SHAPE["n_layers"] * nbytes


def test_step_cost_hand_count(param_pairs):
    params = param_pairs["sparse"][1]
    assert isinstance(params["layers"][0]["w_down"], SparseWeight)
    kept, w_bytes = _hand_weights(params)
    assert step_cost.weight_totals(params) == (kept, w_bytes)
    L, H, KV, hd = (SHAPE["n_layers"], SHAPE["n_heads"], SHAPE["n_kv_heads"],
                    SHAPE["head_dim"])
    per_pos = 2 * KV * hd * 4            # K and V in the model's f32
    # a chunk variant: 2 lanes of a [4, 16] bucket, cursors 8 and 0, 16 and
    # 5 new tokens; padding lanes have n_new 0
    cur, n_new = np.array([8, 0, 0, 0]), np.array([16, 5, 0, 0])
    got = step_cost.step_cost(CFG, (kept, w_bytes), cur, n_new, 4 * 16)
    keys = sum(range(9, 25)) + sum(range(1, 6))       # visible, row by row
    assert got == {
        "flops": 2 * kept * 64 + L * 4 * H * hd * keys,
        "bytes_accessed": w_bytes + L * per_pos * ((24 + 5) + (16 + 5))}
    # a decode variant on int8 arenas: 3 of 4 lanes active at cursors
    # 10, 3 and 30; the int8 position carries an f32 scale a KV head
    cur, n_new = np.array([10, 3, 7, 30]), np.array([1, 1, 0, 1])
    got = step_cost.step_cost(CFG, (kept, w_bytes), cur, n_new, 4, "int8")
    per_pos8 = 2 * (KV * hd + 4 * KV)
    assert got == {
        "flops": 2 * kept * 4 + L * 4 * H * hd * (11 + 4 + 31),
        "bytes_accessed": w_bytes + L * per_pos8 * ((11 + 4 + 31) + 3)}


def test_step_cost_window():
    """A sliding window bounds the keys a row sees and a lane reads."""
    cfg = dataclasses.replace(CFG, window=4)
    cur, n_new = np.array([10]), np.array([3])
    got = step_cost.step_cost(cfg, (0, 0), cur, n_new, 3)
    L, H, KV, hd = (SHAPE["n_layers"], SHAPE["n_heads"], SHAPE["n_kv_heads"],
                    SHAPE["head_dim"])
    # rows at 10, 11, 12 see 4 keys each; the lane reads positions 7..12
    assert got == {"flops": L * 4 * H * hd * 12,
                   "bytes_accessed": L * 2 * KV * hd * 4 * (6 + 3)}
