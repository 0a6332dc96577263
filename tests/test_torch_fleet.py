"""The port's fleet (``serving/fleet/``, the engine's migration hooks, the
router tracers and ``launch/serve.py``'s ``--replicas``/``--routing``)
against the JAX package's, at ``tests/test_fleet.py``'s sizes: a 2-layer
f32 llama-paper model (d 128, vocab 512) with JAX's weights carried over
by ``interchange``, that file's ``TRACE_KW`` and ``ENGINE_KW``.

- ``Router``: the port's and JAX's decisions and stats are equal on the
  same fake replica states, for every policy, on the cases of
  ``tests/test_fleet.py``;
- ``ReplicaSet``: the fleet trace submitted under a virtual clock (no wall
  clock), then ``run()``: per-request streams, the ``home`` map, steals,
  drains and the router's stats equal the JAX set's, and the streams
  equal one port engine's holding the fleet's total KV; the drain case;
- ``RequestQueue.pop_back``/``remove`` and ``ServingEngine.ingest``/
  ``withdraw``/``steal_youngest``, their errors equal to JAX's;
- validation (``meshes=`` of the wrong length), ``stats()`` keys equal to
  JAX's, ``reset_stats``, replicas sharing the params' tensors and owning
  their pools, an n-gram speculative fleet, the ``RouterTracer``'s events
  and counters against JAX's, and the CLI.

Token streams and events are compared exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro import serving as jax_serving  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.runtime import telemetry as jax_tel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime import telemetry as tel  # noqa: E402
from repro_torch.serving import (QueueFull, ReplicaSet, Request,  # noqa: E402
                                 Router, RouterTracer, SamplingParams,
                                 ServingEngine, SpeculativeConfig, Status,
                                 fleet_trace)
from repro_torch.serving.fleet import replica_set  # noqa: E402
from repro_torch.serving.observe import NullTracer  # noqa: E402

SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
             d_ff=256, vocab=512)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="fleet-test", remat=False, dtype=jnp.float32,
                           **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="fleet-test", dtype=torch.float32, **SHAPE)
TRACE_KW = dict(n_requests=16, n_tenants=4, vocab=CFG.vocab, sys_len=16,
                rate_per_s=200.0, burst_mean=3.0, prompt_median=6,
                prompt_sigma=0.5, prompt_max=16, gen_median=5,
                gen_sigma=0.8, gen_max=12, seed=11)
ENGINE_KW = dict(kv_layout="paged", block_size=4, max_len=48,
                 prefix_caching=True, max_queue=64, token_budget=32)
# virtual seconds between fleet steps: short enough that the trace's bursts
# queue up (steals at threshold 1, preemptions and drains)
DT = 0.005
# name -> (routing, steal_threshold)
FLEETS = {"prefix": ("prefix", 4), "round_robin": ("round_robin", 4),
          "prefix_steal": ("prefix", 1)}


@pytest.fixture(scope="module")
def params():
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    return dense, from_jax_params(dense, device="cpu")


def _drive(target, trace, clock):
    """Submit ``trace`` in arrival order under the virtual ``clock`` (a
    one-element list), stepping the target and advancing the clock by DT
    between submissions, then ``run()`` to the end.  Sessions go to
    targets that take them, as ``replay`` does."""
    pending = sorted(trace, key=lambda t: t.arrival_s)
    i = 0
    while i < len(pending):
        while i < len(pending) and pending[i].arrival_s <= clock[0]:
            tr = pending[i]
            i += 1
            if getattr(target, "accepts_session", False):
                target.submit(tr.prompt, tr.sampling(), session=tr.session)
            else:
                target.submit(tr.prompt, tr.sampling())
        if target.has_work:
            target.step()
        clock[0] += DT
    target.run()
    return {r.request_id: list(r.tokens) for r in target.finished}


def _jax_fleet(jparams, routing, steal_threshold, **kw):
    clock = [0.0]
    rs = jax_serving.ReplicaSet(
        JCFG, jparams, n_replicas=2, routing=routing,
        steal_threshold=steal_threshold, clock=lambda: clock[0], n_slots=4,
        n_blocks=16, **ENGINE_KW, **kw)
    return rs, clock


def _port_fleet(tparams, routing, steal_threshold, **kw):
    clock = [0.0]
    rs = ReplicaSet(CFG, tparams, n_replicas=2, routing=routing,
                    steal_threshold=steal_threshold,
                    clock=lambda: clock[0], device="cpu", n_slots=4,
                    n_blocks=16, **ENGINE_KW, **kw)
    return rs, clock


def _summary(rs, streams):
    st = rs.stats()
    return {"streams": streams, "home": dict(rs.home),
            "n_steals": rs.n_steals, "n_drains": rs.n_drains,
            "router": st["router"],
            "n_finished": [p["n_finished"] for p in st["replicas"]],
            "preemptions": [p["n_preemptions"] for p in st["replicas"]]}


@pytest.fixture(scope="module")
def jax_runs(params):
    """Each FLEETS entry through the JAX ReplicaSet, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            rs, clock = _jax_fleet(params[0], *FLEETS[name])
            streams = _drive(rs, jax_serving.fleet_trace(**TRACE_KW), clock)
            cache[name] = (rs, _summary(rs, streams))
        return cache[name]
    return get


@pytest.fixture(scope="module")
def single_streams(params):
    """One port engine holding the fleet's total KV (16 blocks x 2)."""
    clock = [0.0]
    eng = ServingEngine(CFG, params[1], device="cpu", n_slots=4, n_blocks=32,
                        clock=lambda: clock[0], **ENGINE_KW)
    return _drive(eng, fleet_trace(**TRACE_KW), clock)


# --------------------------------------------------------------------------
# router decisions on fake replicas (the router reads queue, pool, cache)
# --------------------------------------------------------------------------

class _FakeQueue(list):
    def __init__(self, n, max_size=8):
        super().__init__(range(n))
        self.max_size = max_size


class _FakePool:
    def __init__(self, n_slots):
        self.n_slots = n_slots


class _Fake:
    def __init__(self, *, slots=4, running=0, queued=0, max_queue=8,
                 cached=0):
        self.pool = _FakePool(slots)
        self.running = list(range(running))
        self.queue = _FakeQueue(queued, max_queue)
        self._cached = cached

    def prefix_match_length(self, prompt):
        return min(self._cached, len(prompt))


# (replica states, routes as (prompt, session)): tests/test_fleet.py's
# router cases, each run under every policy
ROUTER_CASES = {
    "skips_full": ([{}, {"queued": 8, "max_queue": 8}, {}],
                   [([1, 2, 3], None)] * 4),
    "loads": ([{"running": 4, "queued": 2}, {"running": 1},
               {"running": 2}], [(list(range(8)), None)] * 2),
    "cached_prompt": ([{}, {"cached": 16}, {}],
                      [(list(range(16)), None)]),
    "load_counterweight": ([{}, {"cached": 16, "running": 4, "queued": 4}],
                           [(list(range(16)), None)]),
    "affinity": ([{}, {}, {}], [(list(range(8)), 7), (list(range(8)), 7),
                                (list(range(8)), 8)]),
    "all_full": ([{"queued": 2, "max_queue": 2}] * 2, [([1, 2], None)]),
    "stats": ([{"cached": 4}, {}], [(list(range(4)), 1),
                                    (list(range(4)), 2)]),
}


def _route_all(router_cls, policy, states, routes):
    """Every route's decision (or QueueFull), the stats before and after
    ``reset_stats``, and the routing state left behind."""
    r = router_cls([_Fake(**s) for s in states], policy)
    out = []
    for prompt, session in routes:
        try:
            d = r.route(prompt, session=session)
        except (QueueFull, jax_serving.QueueFull) as e:
            out.append(("QueueFull", str(e)))
            continue
        out.append(dataclasses.astuple(d))
    st = r.stats()
    r.reset_stats()
    return out, st, r.stats(), dict(r.affinity), r._rr_next


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
@pytest.mark.parametrize("policy", serving.ROUTING_POLICIES)
def test_router_decisions_match_jax(policy, case):
    assert serving.ROUTING_POLICIES == jax_serving.ROUTING_POLICIES
    states, routes = ROUTER_CASES[case]
    port = _route_all(Router, policy, states, routes)
    ref = _route_all(jax_serving.Router, policy, states, routes)
    assert port == ref
    if case == "all_full":
        assert port[0] == [("QueueFull", "every replica's queue is at "
                            "capacity")]


@pytest.mark.parametrize("args, match", [
    (([_Fake()], "random"), "unknown routing policy"),
    (([], "prefix"), "at least one replica")])
def test_router_validation_matches_jax(args, match):
    with pytest.raises(ValueError, match=match) as port:
        Router(*args)
    with pytest.raises(ValueError) as ref:
        jax_serving.Router(*args)
    assert str(port.value) == str(ref.value)


def test_router_weights_and_decision_fields_match_jax():
    r = Router([_Fake()], "prefix")
    j = jax_serving.Router([_Fake()], "prefix")
    assert (r.w_prefix, r.w_load, r.w_affinity) == (2.0, 1.0, 0.25) == \
        (j.w_prefix, j.w_load, j.w_affinity)
    assert [f.name for f in dataclasses.fields(serving.RouteDecision)] == \
        [f.name for f in dataclasses.fields(jax_serving.RouteDecision)]


# --------------------------------------------------------------------------
# fleets against the JAX fleet and against one engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_matches_jax_and_single_engine(name, params, jax_runs,
                                             single_streams):
    rs, clock = _port_fleet(params[1], *FLEETS[name])
    streams = _drive(rs, fleet_trace(**TRACE_KW), clock)
    port = _summary(rs, streams)
    _, ref = jax_runs(name)
    assert port == ref
    assert streams == single_streams
    assert len(streams) == TRACE_KW["n_requests"]
    assert all(n > 0 for n in port["n_finished"])     # both replicas served
    if name == "prefix_steal":
        assert port["n_steals"] > 0


def test_drain_readmits_stuck_preempted_request(params):
    """tests/test_fleet.py's drain case in both packages."""
    kw = dict(n_replicas=2, routing="least_loaded", n_slots=1, n_blocks=8,
              kv_layout="paged", block_size=4, max_len=32,
              prefix_caching=True, max_queue=8)
    out = []
    for pkg, cfg, p, extra in ((serving, CFG, params[1], {"device": "cpu"}),
                               (jax_serving, JCFG, params[0], {})):
        rs = pkg.ReplicaSet(cfg, p, **kw, **extra)
        rs.replicas[0].submit(list(range(8)),
                              pkg.SamplingParams(max_new_tokens=16))
        rs.replicas[0].step()
        assert rs.replicas[0].pool.n_free == 0
        stuck = rs.replicas[0].submit(list(range(8)),
                                      pkg.SamplingParams(max_new_tokens=4))
        stuck.n_preempted = 1                # a prior eviction
        moved = rs._rebalance()
        assert stuck not in rs.replicas[0].queue
        assert stuck in rs.replicas[1].queue
        out.append((moved, rs.n_drains, rs.n_steals, dict(rs.home),
                    stuck.request_id, len(rs.replicas[1].queue)))
    assert out[0] == out[1]
    assert out[0][:3] == (1, 1, 0)


# --------------------------------------------------------------------------
# queue and engine hooks
# --------------------------------------------------------------------------

def _reqs(pkg, n, **kw):
    return [pkg.Request(i, [1, 2, 3], pkg.SamplingParams(**kw))
            for i in range(n)]


def test_queue_pop_back_and_remove_match_jax():
    out = []
    for pkg in (serving, jax_serving):
        q = pkg.RequestQueue(max_size=4)
        reqs = _reqs(pkg, 4)
        for r in reqs:
            assert q.try_push(r)
        got = [q.pop_back().request_id, q.remove(reqs[1]),
               q.remove(reqs[1]), q.remove(reqs[3]),
               [r.request_id for r in q], q.pop_back().request_id,
               q.pop_back().request_id, q.pop_back()]
        out.append(got)
    assert out[0] == out[1] == [3, True, False, False, [0, 2], 2, 0, None]


class _Recording(NullTracer):
    """An enabled tracer that records the migration hooks' calls."""
    enabled = True

    def __init__(self):
        self.calls = []

    def on_submit(self, req):
        self.calls.append(("submit", req.request_id))

    def on_withdraw(self, req):
        self.calls.append(("withdraw", req.request_id))


def _engine(params, **kw):
    return ServingEngine(CFG, params[1], device="cpu", n_slots=2, n_blocks=16,
                         **{**ENGINE_KW, "max_queue": 2, **kw})


def test_ingest_withdraw_steal_youngest(params):
    tracer = _Recording()
    src, dst = _engine(params), _engine(params, tracer=tracer)
    a = src.submit([5, 6, 7], SamplingParams(max_new_tokens=4),
                   request_id=40)
    b = src.submit([5, 6, 8], SamplingParams(max_new_tokens=4))
    assert b.request_id == 41
    a.metrics.n_preemptions = 2
    arrival = a.metrics.arrival
    assert src.withdraw(a) and not src.withdraw(a)
    dst.ingest(a)
    assert a.metrics.arrival == arrival and a.metrics.n_preemptions == 2
    assert dst._next_id == 41
    assert dst.submit([1], SamplingParams()).request_id == 41
    assert dst.withdraw(a)
    assert src.steal_youngest() is b and src.steal_youngest() is None
    assert tracer.calls == [("submit", 40), ("submit", 41),
                            ("withdraw", 40)]
    dst.ingest(b)
    assert tracer.calls[-1] == ("submit", 41)
    assert [r.request_id for r in dst.queue] == [41, 41]
    with pytest.raises(QueueFull, match=r"queue at capacity \(2\)"):
        dst.ingest(a)
    assert dst.steal_youngest() is b
    assert tracer.calls[-1] == ("withdraw", 41)
    dst.run()
    assert [r.status for r in dst.finished] == [Status.FINISHED]


@pytest.mark.parametrize("case", ["running", "slotted", "too_long"])
def test_ingest_errors_match_jax(case, params):
    msgs = []
    for pkg, eng in ((serving, _engine(params)),
                     (jax_serving, jax_serving.ServingEngine(
                         JCFG, params[0], n_slots=2, n_blocks=16,
                         **{**ENGINE_KW, "max_queue": 2}))):
        # capacity min(max_len 48, 16 blocks x 4) = 48
        prompt = list(range(40)) if case == "too_long" else [1, 2, 3]
        req = pkg.Request(7, prompt, pkg.SamplingParams(max_new_tokens=12))
        if case == "running":
            req.status = pkg.Status.RUNNING
        elif case == "slotted":
            req.slot = 1
        with pytest.raises(ValueError) as e:
            eng.ingest(req)
        msgs.append(str(e.value))
        assert len(eng.queue) == 0
    assert msgs[0] == msgs[1]


def test_ingest_counts_generated_tokens_against_capacity(params):
    eng = _engine(params)
    req = Request(3, list(range(30)), SamplingParams(max_new_tokens=18))
    req.tokens = [1] * 10                    # 10 of 18 already generated
    eng.ingest(req)                          # needs 30 + 10 + 8 = 48
    req2 = Request(4, list(range(31)), SamplingParams(max_new_tokens=18))
    req2.tokens = [1] * 10
    with pytest.raises(ValueError, match="needs 49 tokens, over this "
                       "engine's KV capacity 48"):
        eng.ingest(req2)


# --------------------------------------------------------------------------
# ReplicaSet surface
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw, exc, match", [
    ({"n_replicas": 0}, ValueError, "n_replicas must be >= 1"),
    ({"tracers": [None]}, ValueError, "1 tracers for 2 replicas"),
    # the reference's len(meshes) != n_replicas check (the id is the one
    # this case had while replica meshes were not ported)
    pytest.param({"meshes": [None]}, ValueError, "1 meshes for 2 replicas",
                 id="kw2-NotImplementedError-ROADMAP A12"),
    ({"routing": "random"}, ValueError, "unknown routing policy")])
def test_replica_set_validation(kw, exc, match, params):
    with pytest.raises(exc, match=match):
        ReplicaSet(CFG, params[1], **{"n_replicas": 2, "device": "cpu",
                                      "n_slots": 1, "max_len": 16, **kw})


def test_stats_keys_match_jax_and_reset(params, jax_runs):
    jrs, _ = jax_runs("prefix")
    rs, clock = _port_fleet(params[1], "prefix", 4)
    _drive(rs, fleet_trace(**TRACE_KW), clock)
    st, jst = rs.stats(), jrs.stats()
    assert st.keys() == jst.keys()
    assert st["router"].keys() == jst["router"].keys()
    assert st["prefix_cache"].keys() == jst["prefix_cache"].keys()
    for k in ("lookups", "hits", "hit_tokens", "probes", "hit_rate"):
        assert st["prefix_cache"][k] == jst["prefix_cache"][k], k
    assert st["n_steps"] == jst["n_steps"]
    assert st["critical_path_s"] == \
        pytest.approx(max(st["busy_s"]) + st["router_busy_s"])
    assert st["router"]["n_decisions"] == TRACE_KW["n_requests"]
    probes = [rs.prefix_match_length(r.prompt) for r in rs.finished]
    assert probes == [jrs.prefix_match_length(r.prompt)
                      for r in jrs.finished]
    assert max(probes) > 0
    rs.clear_finished()
    assert rs.finished == [] and not rs.has_work
    rs.reset_stats()
    st = rs.stats()
    assert st["busy_s"] == [0.0, 0.0] and st["router_busy_s"] == 0.0
    assert st["router"]["n_decisions"] == 0 and st["router"]["sessions"] > 0
    assert st["n_steals"] == st["n_drains"] == st["n_steps"] == 0
    assert st["prefix_cache"]["lookups"] == 0


def test_replicas_share_params_and_own_pools(params):
    tparams = params[1]
    rs = ReplicaSet(CFG, tparams, n_replicas=3, device="cpu", n_slots=2,
                    n_blocks=8, **ENGINE_KW)
    leaves = [t.data_ptr() for t in _tensors(tparams)]
    for e in rs.replicas:
        assert e.params is tparams and e.adapter.params is tparams
        assert [t.data_ptr() for t in _tensors(e.adapter.params)] == leaves
    pools = [e.pool for e in rs.replicas]
    assert len({id(p) for p in pools}) == 3
    assert len({p.k.data_ptr() for p in pools}) == 3
    assert len({id(e.queue) for e in rs.replicas}) == 3


def _tensors(tree):
    from repro_torch.tree import flatten
    out = []
    for leaf in flatten(tree):
        out.extend(leaf.buffers() if hasattr(leaf, "buffers") else [leaf])
    return out


def test_speculative_fleet_matches_single_engine(params):
    draft = SpeculativeConfig(k=3, max_k=4, method="ngram")
    rs, clock = _port_fleet(params[1], "prefix", 1, draft=draft)
    streams = _drive(rs, fleet_trace(**TRACE_KW), clock)
    clock = [0.0]
    eng = ServingEngine(CFG, params[1], device="cpu", n_slots=4, n_blocks=32,
                        clock=lambda: clock[0], draft=draft, **ENGINE_KW)
    assert streams == _drive(eng, fleet_trace(**TRACE_KW), clock)
    assert sum(e.stats()["speculative"]["n_spec_steps"]
               for e in rs.replicas) > 0


def test_max_moves_per_step_matches_jax():
    from repro.serving.fleet import replica_set as jax_replica_set
    assert replica_set._MAX_MOVES_PER_STEP == \
        jax_replica_set._MAX_MOVES_PER_STEP == 8


# --------------------------------------------------------------------------
# router tracer
# --------------------------------------------------------------------------

def _traced_fleet(pkg, cfg, p, extra):
    t0 = pkg.ServingTracer(name="r0")
    t1 = pkg.ServingTracer(buffer=t0.buffer, registry=t0.registry, name="r1")
    rt = pkg.RouterTracer(buffer=t0.buffer, registry=t0.registry)
    clock = [0.0]
    rs = pkg.ReplicaSet(cfg, p, n_replicas=2, routing="prefix",
                        steal_threshold=1, tracers=[t0, t1],
                        router_tracer=rt, clock=lambda: clock[0], n_slots=4,
                        n_blocks=16, **ENGINE_KW, **extra)
    streams = _drive(rs, pkg.fleet_trace(**TRACE_KW), clock)
    return rs, t0, rt, streams


def _fleet_lines(text):
    return [line for line in text.splitlines() if "fleet_" in line]


def test_router_tracer_matches_jax(params):
    rs, t0, rt, streams = _traced_fleet(serving, CFG, params[1],
                                        {"device": "cpu"})
    jrs, jt0, jrt, jstreams = _traced_fleet(jax_serving, JCFG, params[0], {})
    assert streams == jstreams
    events = t0.buffer.events
    obj = json.loads(json.dumps(t0.buffer.to_json()))
    assert len(tel.validate_trace_events(obj)) == \
        len(jax_tel.validate_trace_events(obj)) == len(events)
    routing = [e for e in events if e.get("cat") == "routing"]
    jrouting = [e for e in jt0.buffer.events if e.get("cat") == "routing"]
    assert routing == jrouting
    routes = [e for e in routing if e["name"] == "route"]
    assert len(routes) == TRACE_KW["n_requests"]
    assert {"route", "steal"} <= {e["name"] for e in routing} \
        <= {"route", "steal", "drain"}
    # 2 x (4 processes named by r0's and r1's pairs) + 1
    assert rt._pid == jrt._pid == 9
    names = {e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    jnames = {e["args"]["name"] for e in jt0.buffer.events
              if e.get("name") == "process_name"}
    assert names == jnames == {"engine r0", "requests r0", "engine r1",
                               "requests r1", "fleet router"}
    text, jtext = t0.counters_text(), jt0.counters_text()
    assert _fleet_lines(text) == _fleet_lines(jtext)
    for name in ("fleet_routing_decisions_total", "fleet_reroutes_total",
                 "fleet_route_prefix_tokens_total", "fleet_queue_imbalance"):
        assert f"# TYPE {name}" in text
    decisions = t0.registry.counter("fleet_routing_decisions_total")
    assert sum(decisions.series().values()) == TRACE_KW["n_requests"]
    # each withdrawn request shows one "queued" span per engine it visited
    assert sum(e.get("name") == "withdrawn" for e in events) == \
        rs.n_steals + rs.n_drains > 0


def test_null_router_tracer_is_the_default(params):
    rs = ReplicaSet(CFG, params[1], n_replicas=2, device="cpu", n_slots=1,
                    max_len=16)
    assert rs.tracer is serving.NULL_ROUTER_TRACER
    assert not serving.NullRouterTracer.enabled
    assert isinstance(RouterTracer().attach(rs), RouterTracer)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

@pytest.fixture
def f32_smoke(monkeypatch):
    """The CLI's smoke config at f32, where streams are exact."""
    get_smoke = serve.get_smoke
    monkeypatch.setattr(serve, "get_smoke", lambda arch: dataclasses.replace(
        get_smoke(arch), dtype=torch.float32))


CLI = ["--arch", "llama-paper", "--smoke-arch", "--device", "cpu",
       "--kv-layout", "paged", "--block-size", "8", "--slots", "2"]


def test_cli_replicas_batch(f32_smoke, capsys):
    argv = CLI + ["--batch", "5", "--prompt-len", "12", "--gen", "4"]
    one = [r.tokens for r in serve.main(argv)]
    two = [r.tokens for r in serve.main(argv + ["--replicas", "2",
                                                "--routing", "round_robin"])]
    assert one == two
    out = capsys.readouterr().out
    assert "fleet[round_robin]: 2 replicas" in out
    assert out.count("kv arena:") == 3


def test_cli_replicas_trace(f32_smoke, tmp_path, capsys):
    path, out = tmp_path / "t.json", tmp_path / "out.json"
    serving.save_trace(str(path), fleet_trace(**{**TRACE_KW,
                                                 "n_requests": 8}))
    argv = CLI + ["--trace", str(path), "--max-len", "48",
                  "--time-scale", "0"]
    one = serve.main(argv)
    two = serve.main(argv + ["--replicas", "2", "--routing", "prefix",
                             "--trace-out", str(out)])
    assert {r.request_id: r.tokens for r in one["finished"]} == \
        {r.request_id: r.tokens for r in two["finished"]}
    assert two["rejected"] == 0 and len(two["finished"]) == 8
    assert isinstance(two["engine"], ReplicaSet)
    events = tel.validate_trace_events(json.loads(out.read_text()))
    assert sum(e["name"] == "route" for e in events) == 8
    names = {e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert {"engine r0", "engine r1", "fleet router"} <= names
    text = (tmp_path / "out.json.counters.txt").read_text()
    assert "fleet_routing_decisions_total" in text
    assert "fleet[prefix]: 2 replicas" in capsys.readouterr().out


def test_cli_rejects_zero_replicas(capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(CLI + ["--replicas", "0"])
    assert "--replicas must be >= 1" in capsys.readouterr().err
