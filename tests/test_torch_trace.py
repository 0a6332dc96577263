"""The port's request traces, telemetry primitives, ``format_summary`` and
trace-replay CLI against the JAX package's.

- ``poisson_trace``, ``long_prompt_trace`` and ``fleet_trace`` give
  field-for-field identical requests for the same arguments and seed (both
  draw from one ``np.random.default_rng(seed)`` in one order);
- a trace written by either package's ``save_trace`` loads in the other;
- ``format_summary`` gives the same line for the same summary dict, the
  empty-window and NaN paths included, and the port's ``summarize`` +
  ``format_summary`` the reference's line for the same metrics;
- the same ``inc``/``set`` calls give identical ``prometheus_text`` and
  ``snapshot``; the same ``TraceBuffer`` calls an identical ``to_json``;
  the two ``validate_trace_events`` accept and reject the same objects;
- ``replay`` at time scale 0 through the port's engine gives the JAX
  engine's greedy streams and rejected count on the same trace (f32);
- ``python -m repro_torch.launch.serve --trace`` replays a JAX-written
  trace on the CPU; with ``--trace-out`` it and the batch mode write a
  trace both validators accept and a counters file; without ``--device
  cpu`` it raises where there is no CUDA.

Everything is compared exactly (strings, dicts, token ids).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.runtime import metrics as jax_metrics  # noqa: E402
from repro.runtime import telemetry as jax_tel  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import trace as jax_trace  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.runtime import metrics  # noqa: E402
from repro_torch.runtime import telemetry as tel  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import trace  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
             d_ff=256, vocab=512)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-trace", remat=False,
                           dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-trace", dtype=torch.float32, **SHAPE)


def _fields(reqs):
    return [dataclasses.asdict(r) for r in reqs]


# --------------------------------------------------------------------------
# traces
# --------------------------------------------------------------------------

GENERATORS = [
    ("poisson_trace", dict(n_requests=12, rate_per_s=4.0, vocab=512)),
    ("poisson_trace", dict(n_requests=16, rate_per_s=4.0, vocab=128256,
                           prompt_len=(64, 768), max_new_tokens=32,
                           temperature=0.0, seed=0)),
    ("poisson_trace", dict(n_requests=5, rate_per_s=50.0, vocab=32000,
                           prompt_len=(1, 3), temperature=0.7, seed=9)),
    ("long_prompt_trace", dict(n_short=6, short_len=12, gen_short=8,
                               n_long=2, long_len=200, gen_long=4,
                               vocab=512, seed=3)),
    ("fleet_trace", dict(n_requests=40, n_tenants=4, vocab=512, seed=5)),
    ("fleet_trace", dict(n_requests=17, n_tenants=2, vocab=1000,
                         sys_len=8, rate_per_s=5.0, burst_mean=2.0,
                         gen_max=12, temperature=0.5, seed=11)),
]


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(GENERATORS)])
def test_generators_match_jax(name, kw):
    want = _fields(getattr(jax_trace, name)(**kw))
    got = _fields(getattr(trace, name)(**kw))
    assert got == want
    assert len(got) == kw.get("n_requests", len(want))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_across_packages(writer, tmp_path):
    kw = GENERATORS[4][1]
    path = str(tmp_path / "t.json")
    if writer == "jax":
        jax_trace.save_trace(path, jax_trace.fleet_trace(**kw))
        loaded = trace.load_trace(path)
        assert all(isinstance(r, trace.TraceRequest) for r in loaded)
        assert _fields(loaded) == _fields(jax_trace.fleet_trace(**kw))
    else:
        trace.save_trace(path, trace.fleet_trace(**kw))
        loaded = jax_trace.load_trace(path)
        assert _fields(loaded) == _fields(trace.fleet_trace(**kw))
    assert loaded[0].sampling().seed == 0
    # a pre-fleet file without "session" still loads
    with open(path) as f:
        rows = json.load(f)
    for r in rows:
        r.pop("session")
    with open(path, "w") as f:
        json.dump(rows, f)
    assert [r.session for r in trace.load_trace(path)] == [-1] * len(rows)


# --------------------------------------------------------------------------
# format_summary
# --------------------------------------------------------------------------

def _metrics(mod, n_tokens, family="", n_pre=0, reason="", chunks=1,
             t0=0.0):
    m = mod.RequestMetrics(family=family, arrival=t0, admitted=t0 + 0.1,
                           first_token=t0 + 0.2, finished=t0 + 1.0,
                           n_tokens=n_tokens, prefill_chunks=chunks,
                           n_preemptions=n_pre, last_preempt_reason=reason)
    m.itl = [0.01 * (1 + i % 3) for i in range(max(n_tokens - 1, 0))]
    return m


WINDOWS = {
    "empty": ([], 0.0),
    "single_token": ([dict(n_tokens=1), dict(n_tokens=1)], 2.0),
    "mixed": ([dict(n_tokens=4, chunks=3), dict(n_tokens=9, t0=0.5),
               dict(n_tokens=1)], 1.5),
    "preempted": ([dict(n_tokens=4, n_pre=2, reason="decode_pressure"),
                   dict(n_tokens=4, n_pre=1, reason="prefill_pressure"),
                   dict(n_tokens=4)], 1.0),
    "zero_wall": ([dict(n_tokens=3)], 0.0),
}


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_format_summary_matches_jax(window):
    reqs, wall = WINDOWS[window]
    js = jax_metrics.summarize([_metrics(jax_metrics, **r) for r in reqs],
                               wall)
    ts = metrics.summarize([_metrics(metrics, **r) for r in reqs], wall)
    line = jax_metrics.format_summary(window, js)
    assert metrics.format_summary(window, js) == line
    assert metrics.format_summary(window, ts) == line
    assert "nan" not in line


def test_format_summary_speculative_and_nan_segments():
    """The speculative segment (A8 fills its keys) and NaN percentiles:
    the same dict, the same line."""
    nan = {"p50": math.nan, "p99": math.nan}
    s = {"n_requests": 3, "total_tokens": 30, "wall_s": 2.0,
         "tok_per_s": 15.0, "ttft": {"p50": 0.1, "p99": 0.2}, "tpot": nan,
         "e2e": {"p50": 1.0, "p99": 1.5}, "itl": nan,
         "prefill_chunks": {"max": 4}, "preemptions": {"total": 2},
         "speculative": {"drafted": 10, "accepted": 7,
                         "acceptance_rate": 0.7}}
    line = metrics.format_summary("spec", s)
    assert line == jax_metrics.format_summary("spec", s)
    assert "spec accept 0.70" in line and "tpot" not in line
    s = dict(s, tok_per_s=math.nan, ttft=nan, e2e=nan)
    assert metrics.format_summary("x", s) == \
        jax_metrics.format_summary("x", s)


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------

def _registry_ops(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("serving_tokens_total", "tokens")
    c.inc()
    c.inc(2.5, family="dense", engine="a/slot")
    c.inc(1, engine="a/slot", family="dense")          # label order
    reg.counter("serving_tokens_total").inc(4, family="ssm")
    g = reg.gauge("serving_queue_depth", "queued")
    g.set(3, engine="b")
    g.set(1, engine="b")
    g.set(7)
    reg.gauge("bare")
    reg.counter("z_total", "last").inc(1e9, q='x"y')
    with pytest.raises(ValueError):
        reg.gauge("serving_tokens_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    return reg


def test_registry_text_and_snapshot_match_jax():
    t, j = _registry_ops(tel), _registry_ops(jax_tel)
    assert t.prometheus_text() == j.prometheus_text()
    assert t.snapshot() == j.snapshot()
    assert json.dumps(t.snapshot()) == json.dumps(j.snapshot())


def _buffer_ops(mod):
    buf = mod.TraceBuffer()
    buf.set_process_name(1, "engine x")
    buf.set_process_name(1, "again")                   # deduped
    buf.set_thread_name(1, 0, "steps")
    buf.set_thread_name(1, 0, "again")                 # deduped
    buf.complete("step", 0.0, 12.5, pid=1, cat="step", args={"a": 1})
    buf.complete("neg", 3.0, -2.0, pid=1)              # clamps to 0
    buf.instant("compile", 4.0, pid=1, cat="engine", args={"fn": "step"})
    buf.instant("g", 5.0, scope="g")
    buf.counter("engine", 6.0, {"queue_depth": 2}, pid=1)
    return buf


def test_trace_buffer_json_matches_jax(tmp_path):
    t, j = _buffer_ops(tel), _buffer_ops(jax_tel)
    assert len(t) == len(j) == 7
    assert t.to_json() == j.to_json()
    t.write(str(tmp_path / "t.json"))
    j.write(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


VALIDATE = [
    ({"traceEvents": [
        {"ph": "X", "name": "s", "ts": 0, "dur": 1, "pid": 1, "tid": 0},
        {"ph": "i", "name": "e", "ts": 2, "pid": 1, "tid": 0, "s": "t"},
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "p"}}]}, 3),
    ([{"ph": "C", "name": "c", "ts": 1, "args": {"x": 1}}], 1),
    ([], 0),
    ({"notTrace": 1}, None),
    ({"traceEvents": {"ph": "X"}}, None),
    ("string", None),
    ([{"name": "no-ph"}], None),
    ([{"ph": "X", "name": "s", "ts": 0}], None),
    ([{"ph": "i", "name": "s"}], None),
    ([{"ph": "b", "name": "s"}], None),
    ([7], None),
]


@pytest.mark.parametrize("obj,n", VALIDATE, ids=range(len(VALIDATE)))
def test_validators_agree(obj, n):
    for validate in (tel.validate_trace_events,
                     jax_tel.validate_trace_events):
        if n is None:
            with pytest.raises(ValueError):
                validate(obj)
        else:
            assert len(validate(obj)) == n


# --------------------------------------------------------------------------
# replay through the engines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_replay_matches_jax_engine(layout):
    """Time scale 0 submits the whole trace at the first iteration: a
    4-deep queue behind 2 slots admits 4 of the 6 requests in both
    packages (the rest are rejected), and the streams are identical."""
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    tparams = from_jax_params(jparams, device="cpu")
    kw = dict(n_slots=2, max_len=40, max_queue=4, token_budget=16,
              kv_layout=layout, block_size=8)
    tr = trace.poisson_trace(n_requests=6, rate_per_s=4.0, vocab=CFG.vocab,
                             prompt_len=(6, 24), max_new_tokens=5, seed=2)
    jres = jax_trace.replay(JaxServingEngine(JCFG, jparams, **kw),
                            [jax_trace.TraceRequest(**dataclasses.asdict(r))
                             for r in tr], time_scale=0.0)
    tres = trace.replay(ServingEngine(CFG, tparams, device="cpu", **kw), tr,
                        time_scale=0.0)
    assert tres["rejected"] == jres["rejected"] == 2
    assert [(r.request_id, r.tokens) for r in tres["finished"]] == \
        [(r.request_id, r.tokens) for r in jres["finished"]]
    assert tres["wall_s"] > 0


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _serve(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama-paper", "--smoke-arch", *args], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("mode", ["trace", "batch"])
def test_cli_writes_observability(mode, tmp_path):
    """--trace replays a JAX-written trace; either mode with --trace-out
    writes a trace both validators accept and a counters file."""
    path = tmp_path / "t.json"
    jax_trace.save_trace(str(path), jax_trace.poisson_trace(
        n_requests=5, rate_per_s=20.0, vocab=512, prompt_len=(8, 16),
        max_new_tokens=4, seed=4))
    out = tmp_path / "out.json"
    args = (["--trace", str(path), "--max-len", "32", "--time-scale", "0.1"]
            if mode == "trace" else
            ["--batch", "5", "--prompt-len", "12", "--gen", "4"])
    run = _serve(["--device", "cpu", "--sparse", "--kv-layout", "paged",
                  *args, "--trace-out", str(out)], tmp_path)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    if mode == "trace":
        assert any(line.lstrip().startswith("trace: 5 req, 20 tok")
                   for line in lines), run.stdout
    assert any(line.startswith("trace written to") for line in lines)
    obj = json.loads(out.read_text())
    events = tel.validate_trace_events(obj)
    assert len(jax_tel.validate_trace_events(obj)) == len(events)
    names = {e["name"] for e in events}
    assert {"step", "decode", "request_summary", "jit:step",
            "jit:decode"} <= names
    assert sum(e["name"] == "request_summary" for e in events) == 5
    text = (tmp_path / "out.json.counters.txt").read_text()
    assert 'serving_tokens_decoded_total{engine="dense/paged",' \
           'family="dense"} 20' in text


def test_cli_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    path = tmp_path / "t.json"
    trace.save_trace(str(path), trace.poisson_trace(
        n_requests=2, rate_per_s=4.0, vocab=512))
    run = _serve(["--trace", str(path)], tmp_path)
    assert run.returncode != 0
    assert "device='cpu'" in run.stderr
