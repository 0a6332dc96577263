"""The moe and enc-dec families' fixed-shape decode steps (the counterparts
of the reference's jitted decode, ``serving/families.CapturedStep``) and
the grouped expert products under them, on the CPU at f32 (bf16 where
stated), smoke twins, one torch intra-op thread.

- ``moe._grouped`` (``torch._grouped_mm`` on group ends kept on the
  device: the reference's ``ragged_dot``) against its plain version, the
  per-expert loop, bit for bit at f32 and bf16, with empty experts, on a
  whole stack and on a mesh rank's columns (``ColShard`` stacks through
  ``_expert_ffn``, two ranks run as threads).
- ``moe._moe_local`` against the JAX package's ``_moe_local`` at rtol 1e-5
  / atol 1e-6 (f32 sums in another order); its gradients through the
  grouped products equal the loop's bit for bit.
- The op record of the moe and enc-dec fixed-shape decode steps: no
  ``aten._local_scalar_dense``, ``nonzero`` or ``bincount`` dispatched and
  no ``Tensor.tolist``/``numpy`` called, so nothing is read to the host (a
  read would break a capture), and every expert product is grouped.
- The enc-dec fixed-shape view (``EncDecPoolView.decode``) against the
  host-built one: arenas bit-identical and logits identical.
- mixtral (slot and paged, bf16 and int8 KV, under slot-end and
  decode-pressure preemption) and whisper (swap preemptions) engines
  through the fixed-shape step: streams equal the JAX engine's.
- ``storage_key`` separates operands at one address by dtype and shape,
  and an adapter walks it once per (params, arenas) objects.
- ``aten._grouped_mm``'s FLOP formula (``launch/hlo_analysis``): a
  mixtral smoke step's recorded FLOPs on the grouped path equal the
  per-expert loop's under ``FlopCounterMode``, real and fake.

The graphs themselves need a card: ``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import threading  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.models import model_zoo, moe  # noqa: E402
from repro_torch.parallel.tensor_parallel import ColShard  # noqa: E402
from repro_torch.serving import (SamplingParams, ServingEngine,  # noqa: E402
                                 Status)
from repro_torch.serving import families  # noqa: E402
from repro_torch.serving.families import (EncDecAdapter,  # noqa: E402
                                          TransformerAdapter, storage_key)
from repro_torch.serving.scheduler import \
    PREEMPT_DECODE_PRESSURE  # noqa: E402

ARCHS = {"mixtral": "mixtral-8x7b", "maverick": "llama4-maverick-400b-a17b",
         "whisper": "whisper-medium"}
MOE_TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device("cpu")
# host reads: what a capture cannot hold
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.bincount")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread, so several test workers on one
    machine do not oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """name: (jcfg, cfg, JAX params, port params), f32, drawn once."""
    out = {}
    for i, (name, arch) in enumerate(ARCHS.items()):
        jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                                   dtype=jnp.float32, remat=False)
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  dtype=torch.float32, remat=False)
        jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(70 + i))
        out[name] = (jcfg, cfg, jparams, from_jax_params(jparams, "cpu"))
    return out


def _offs(counts):
    return torch.tensor(counts).cumsum(0).to(torch.int32)


# --------------------------------------------------------------------------
# the grouped products
# --------------------------------------------------------------------------

COUNTS = {"ragged": [3, 0, 5, 2, 0, 1], "one_expert": [0, 0, 7, 0, 0, 0],
          "even": [2, 2, 2, 2, 2, 2]}


@pytest.mark.parametrize("counts", list(COUNTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_equals_the_plain_loop(counts, dtype):
    """The grouped product equals one ``torch.matmul`` per expert bit for
    bit, and never reads an empty expert's weights (NaN there stays out
    of the output)."""
    g = torch.Generator().manual_seed(0)
    c = COUNTS[counts]
    xs = torch.randn((sum(c), 24), generator=g).to(dtype)
    w = torch.randn((len(c), 24, 40), generator=g).to(dtype)
    offs = _offs(c)
    assert moe.takes_grouped(xs, w)
    want = moe._grouped_plain(xs, w, offs)
    assert torch.equal(moe._grouped(xs, w, offs), want)
    empty = [e for e, n in enumerate(c) if n == 0]
    if empty:
        w[empty] = float("nan")
        got = moe._grouped(xs, w, offs)
        assert torch.isfinite(got).all() and torch.equal(got, want)


class _Ranks:
    """A model axis of ``size`` ranks run as threads of one process: each
    rank's ``gather`` hands its piece to the others through a barrier."""

    def __init__(self, size):
        self.size, self.parts = size, [None] * size
        self.barrier = threading.Barrier(size)

    def axis(self, rank):
        ranks = self

        class Axis:
            size = ranks.size

            def gather(self, t, dim=-1):
                ranks.parts[rank] = t
                ranks.barrier.wait()
                out = torch.cat(ranks.parts, dim=dim)
                ranks.barrier.wait()        # read before the next gather
                return out
        return Axis()

    def run(self, fn):
        out = [None] * self.size

        def body(r):
            out[r] = fn(r)
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        return out


def _rank_stacks(p, ranks, r, contiguous):
    """Rank ``r``'s ``ColShard`` columns of the expert stacks of ``p``."""
    out = dict(p)
    for name in ("we_gate", "we_up", "we_down"):
        w = p[name]
        n = w.shape[-1] // ranks.size
        cols = w.narrow(-1, r * n, n)
        out[name] = ColShard(cols.contiguous() if contiguous else cols,
                             ranks.axis(r))
    return out


@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_on_a_rank_s_columns(models, dtype, contiguous):
    """Two ranks' ``ColShard`` columns of mixtral's stacks through
    ``_expert_ffn`` (two gathers a layer): the grouped products equal the
    per-expert loop bit for bit on each rank, every rank gets the same
    rows, and they match the whole stacks' FFN (another GEMM blocking)."""
    _, cfg, _, params = models["mixtral"]
    cfg = dataclasses.replace(cfg, dtype=dtype)
    p = {k: v.to(dtype) if v.dtype.is_floating_point and k != "router"
         else v for k, v in params["layers"][0]["moe"].items()}
    g = torch.Generator().manual_seed(1)
    c = [4, 0, 3, 2]
    assert len(c) == cfg.moe.num_experts
    xs = torch.randn((sum(c), cfg.d_model), generator=g).to(dtype)
    offs = _offs(c)

    def ffn(plain):
        ranks = _Ranks(2)
        with pytest.MonkeyPatch.context() as mp:
            if plain:
                mp.setattr(moe, "_grouped", moe._grouped_plain)
            return ranks.run(lambda r: moe._expert_ffn(
                _rank_stacks(p, ranks, r, contiguous), xs, offs, cfg))
    got, want = ffn(False), ffn(True)
    for a, b in zip(got, want):
        assert a is not None and torch.equal(a, b)
    assert torch.equal(got[0], got[1])
    whole = moe._expert_ffn(p, xs, offs, cfg).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert float((got[0].float() - whole).abs().max()) \
        <= tol * float(whole.abs().max())


@pytest.mark.parametrize("T", [1, 5, 24])
@pytest.mark.parametrize("name", ["mixtral", "maverick"])
def test_moe_local_matches_jax(models, name, T):
    """``_moe_local`` (route, sort, grouped products on device group ends,
    weighted scatter-add) against the reference's, at decode and chunk
    token counts; a single token leaves most experts empty."""
    jcfg, cfg, jparams, params = models[name]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    p = params["layers"][0]["moe"]
    x = np.random.default_rng(T).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    want = jax_moe._moe_local(jp, jnp.asarray(x), jcfg)
    got = moe._moe_local(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_local_gradients_equal_the_plain_loop(models, monkeypatch,
                                                  dtype):
    """Training through ``_moe_local`` backpropagates through the grouped
    products: every gradient (tokens, router, expert stacks) equals the
    per-expert loop's bit for bit."""
    _, cfg, _, params = models["mixtral"]
    cfg = dataclasses.replace(cfg, dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (12, cfg.d_model)).astype(np.float32)).to(dtype)

    def grads():
        p = {k: v.to(dtype if k != "router" else v.dtype).detach()
             .requires_grad_() for k, v in params["layers"][0]["moe"].items()}
        xr = x.clone().requires_grad_()
        moe._moe_local(p, xr, cfg).float().square().mean().backward()
        return [xr.grad] + [p[k].grad for k in sorted(p)]
    got = grads()
    monkeypatch.setattr(moe, "takes_grouped", lambda xs, w: False)
    want = grads()
    for a, b in zip(got, want):
        assert a is not None and torch.equal(a, b)


def test_expert_stacks_take_the_grouped_product():
    """``experts_grouped``: f32 and bf16 stacks on the CPU do; bf16 fake
    stacks with 16-byte rows do, f32 fake stacks (the meta kernel takes
    bf16 only) and misaligned bf16 ones do not."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def tree(make):
        return {"layers": [{"moe": {n: make() for n in
                                    ("we_gate", "we_up", "we_down")}},
                           {"mlp": {}}]}
    for dt in (torch.float32, torch.bfloat16):
        assert moe.experts_grouped(tree(lambda: torch.zeros((2, 8, 16),
                                                            dtype=dt)))
    with FakeTensorMode():
        assert moe.experts_grouped(tree(lambda: torch.empty(
            (2, 8, 16), dtype=torch.bfloat16)))
        assert not moe.experts_grouped(tree(lambda: torch.empty((2, 8, 16))))
        assert not moe.experts_grouped(tree(lambda: torch.empty(
            (2, 12, 20), dtype=torch.bfloat16)))
    assert moe.experts_grouped({"layers": [{"mlp": {}}]})


# --------------------------------------------------------------------------
# the fixed-shape decode steps
# --------------------------------------------------------------------------

class _OpRecord(TorchDispatchMode):
    """Every aten op dispatched within, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _record(monkeypatch, fn):
    """(ops dispatched, ``Tensor.tolist``/``numpy`` calls) while ``fn``
    runs: a tolist reads a CPU tensor without dispatching an op."""
    reads = []
    for name in ("tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    with _OpRecord() as rec:
        out = fn()
    monkeypatch.undo()
    return out, rec.ops, reads


def _decoding(engine, n, seed, embeds=None):
    """Submit ``n`` requests and step until every one decodes (the other
    lanes stay free); returns the requests."""
    rng = np.random.default_rng(seed)
    reqs = [engine.submit(rng.integers(0, engine.cfg.vocab, 6 + 3 * i)
                          .tolist(), SamplingParams(max_new_tokens=8),
                          embeds=None if embeds is None else embeds[i])
            for i in range(n)]
    while not all(r.status is Status.RUNNING for r in reqs):
        engine.step()
    return reqs


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_moe_decode_step_reads_nothing_to_the_host(models, monkeypatch,
                                                   layout, kv_dtype):
    _, cfg, _, params = models["mixtral"]
    kw = dict(kv_layout="paged", block_size=4) if layout == "paged" else {}
    engine = ServingEngine(cfg, params, device="cpu", n_slots=4, max_len=32,
                           token_budget=16, kv_dtype=kv_dtype, **kw)
    _decoding(engine, 3, seed=1)
    ad = engine.adapter
    active = engine._decode_rows()
    if layout == "paged":
        ad.pool.prepare_decode(active)
    p = ad.pool
    n_new = np.zeros_like(p.pos)
    n_new[active] = 1
    inputs = torch.from_numpy(np.stack([engine._last_token, p.pos, n_new]))
    logits, ops, reads = _record(monkeypatch,
                                 lambda: ad._decode_step(inputs))
    assert logits.shape == (4, 1, cfg.vocab)
    assert not [o for o in ops if o.startswith(HOST_READS)]
    assert reads == []
    grouped = [o for o in ops if o.startswith("aten._grouped_mm")]
    assert len(grouped) == 3 * cfg.n_layers


def test_encdec_decode_step_reads_nothing_to_the_host(models, monkeypatch):
    _, cfg, _, params = models["whisper"]
    engine = ServingEngine(cfg, params, device="cpu", n_slots=4, max_len=32,
                           token_budget=16, max_ctx=8)
    rng = np.random.default_rng(2)
    embeds = [rng.standard_normal((n, cfg.d_model)).astype(np.float32)
              for n in (8, 5, 3)]
    _decoding(engine, 3, seed=3, embeds=embeds)
    ad = engine.adapter
    p = ad.pool
    inputs = torch.from_numpy(np.stack([engine._last_token, p.pos,
                                        np.ones_like(p.pos), ad.ctx.lens]))
    logits, ops, reads = _record(monkeypatch,
                                 lambda: ad._decode_step(inputs))
    assert logits.shape == (4, 1, cfg.vocab)
    assert not [o for o in ops if o.startswith(HOST_READS)]
    assert reads == []


def test_encdec_fixed_shape_view_equals_host_built_view(models):
    """Random arenas and context rows; lanes active at 9, at the arena's
    last position, past it, and free at 0; context lengths 0 to max_ctx:
    the fixed-shape step writes every arena position as the host-built
    view's step does (the lane past its arena writes nothing new) and
    gives the same logits on every lane."""
    _, cfg, _, params = models["whisper"]
    ml = 16
    ad = EncDecAdapter(cfg, params, n_slots=4, max_len=ml, max_ctx=6,
                       device=CPU)
    assert not ad.graphed and ad.decode_key(None) is None
    g = torch.Generator().manual_seed(4)
    p, c = ad.pool, ad.ctx
    for a in (p.k, p.v, c.ck, c.cv):
        a.copy_(torch.randn(a.shape, generator=g))
    p.pos[:] = [9, ml - 1, ml, 0]
    c.lens[:] = [6, 3, 1, 0]
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (4, 1))
    before = [a.clone() for a in (p.k, p.v)]
    want = ad._run(None, p.pos, np.ones_like(p.pos), tokens, c.lens.copy())
    want_arenas = [a.clone() for a in (p.k, p.v)]
    for a, b in zip((p.k, p.v), before):
        a.copy_(b)
    got = ad.step_decode(tokens, [0, 1])
    assert ad.captured_decode.graphs == {}
    assert torch.equal(got, want)
    for a, w, b in zip((p.k, p.v), want_arenas, before):
        assert torch.equal(a, w)
        assert not torch.equal(a, b)                     # the step wrote
        assert torch.equal(a[:, 2], b[:, 2])     # the lane past its arena


# --------------------------------------------------------------------------
# engines against the JAX engine
# --------------------------------------------------------------------------

def _through_fixed_step(adapter):
    """Count the adapter's decode calls and its fixed-shape decode steps:
    [calls, steps]."""
    n = [0, 0]
    call, step = adapter.step_decode, adapter._decode_step

    def counted_call(*a):
        n[0] += 1
        return call(*a)

    def counted_step(inputs):
        n[1] += 1
        return step(inputs)
    adapter.step_decode, adapter._decode_step = counted_call, counted_step
    return n


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_moe_engine_streams_equal_the_jax_engine(models, layout, kv_dtype):
    """mixtral (top-2: lanes coupled through the routing) under pressure:
    paged, a block pool that runs dry mid-decode (decode-pressure
    preemptions); slot, one request filling its slot to the last
    position while free lanes decode with stale cursors.  Every decode
    call runs the fixed-shape step; streams and preemptions equal the JAX
    engine's."""
    jcfg, cfg, jparams, params = models["mixtral"]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, 5 + 2 * i).tolist()
               for i in range(5)]
    gens = [9, 7, 11, 6, 8]
    if layout == "paged":
        kw = dict(n_slots=4, max_len=24, kv_layout="paged", block_size=4,
                  n_blocks=12, token_budget=8)
    else:
        kw = dict(n_slots=3, max_len=24, token_budget=8)
        gens[0] = 24 - len(prompts[0])
    streams, engines = [], []
    for port in (False, True):
        eng = (ServingEngine(cfg, params, device="cpu", kv_dtype=kv_dtype,
                             **kw) if port else
               JaxServingEngine(jcfg, jparams, kv_dtype=kv_dtype, **kw))
        if port:
            n = _through_fixed_step(eng.adapter)
        sp = SamplingParams if port else JaxSamplingParams
        reqs = [eng.submit(p, sp(max_new_tokens=g))
                for p, g in zip(prompts, gens)]
        eng.run(max_steps=400)
        streams.append([r.tokens for r in reqs])
        engines.append(eng)
        if port:
            assert all(r.status is Status.FINISHED for r in reqs)
    jeng, eng = engines
    assert streams[1] == streams[0]
    assert n[0] > 0 and n[1] == n[0]
    assert eng.n_preemptions == jeng.n_preemptions
    if layout == "paged":
        assert eng.n_preemptions > 0
        assert any(r.metrics.last_preempt_reason == PREEMPT_DECODE_PRESSURE
                   for r in reqs)


def test_encdec_engine_streams_equal_the_jax_engine_with_swaps(models):
    """whisper with more requests than slots and context lengths from 2 to
    max_ctx, the youngest running request swap-preempted at fixed steps on
    both engines: every decode call runs the fixed-shape step, and the
    streams equal the JAX engine's and the uninterrupted serve's."""
    jcfg, cfg, jparams, params = models["whisper"]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, 4 + i).tolist() for i in range(5)]
    embeds = [rng.standard_normal((n, cfg.d_model)).astype(np.float32)
              for n in (7, 2, 5, 7, 3)]
    kw = dict(n_slots=3, max_len=20, token_budget=8, max_ctx=7)
    preempt_at = (3, 6, 10)
    runs = []
    for port, pressed in ((False, True), (True, True), (True, False)):
        eng = (ServingEngine(cfg, params, device="cpu", **kw) if port
               else JaxServingEngine(jcfg, jparams, **kw))
        n = _through_fixed_step(eng.adapter) if port else None
        sp = SamplingParams if port else JaxSamplingParams
        reqs = [eng.submit(p, sp(max_new_tokens=7), embeds=e)
                for p, e in zip(prompts, embeds)]
        for step in range(200):
            if not eng.has_work:
                break
            if pressed and step in preempt_at and eng.running:
                eng._preempt_one({"preempted": 0})
            eng.step()
        runs.append(([r.tokens for r in reqs], eng.n_preemptions))
        if port:
            assert all(r.status is Status.FINISHED and r.swap is None
                       for r in reqs)
            assert n[0] > 0 and n[1] == n[0]
            assert eng.adapter.n_encode_calls == len(prompts)
    (want, jn), (got, gn), (plain, _) = runs
    assert got == want == plain
    assert gn == jn == len(preempt_at)


# --------------------------------------------------------------------------
# keys and FLOPs
# --------------------------------------------------------------------------

def test_storage_key_separates_dtype_and_shape_at_one_address():
    w = torch.randn(8, 4)
    other = torch.randn(3)
    base = storage_key({"a": w, "b": [other]})
    assert base == storage_key({"a": w, "b": [other]})
    for swapped in (w.view(torch.int16), w[:4], w.t()):
        assert swapped.data_ptr() == w.data_ptr()
        assert storage_key({"a": swapped, "b": [other]}) != base


def test_adapter_walks_its_key_once_per_params_and_arenas(models,
                                                          monkeypatch):
    """The storage key is walked at the first call, again when the params
    or an arena is replaced, and not for calls in between."""
    _, cfg, _, params = models["mixtral"]
    ad = TransformerAdapter(cfg, params, n_slots=2, max_len=16, device=CPU)
    walks = [0]
    real = families.storage_key

    def counted(*trees):
        walks[0] += 1
        return real(*trees)
    monkeypatch.setattr(families, "storage_key", counted)
    p = ad.pool
    key = ad.storage([p.k, p.v])
    for _ in range(3):
        assert ad.storage([p.k, p.v]) == key
    assert walks == [1]
    ad.params = dict(params)
    assert ad.storage([p.k, p.v]) == key           # the same leaves
    p.k = p.k.clone()
    assert ad.storage([p.k, p.v]) != key
    assert walks == [3]


@pytest.mark.parametrize("fake", [False, True])
def test_grouped_mm_flops_equal_the_per_expert_loop(monkeypatch, fake):
    """A mixtral smoke prefill step (bf16): its FLOPs recorded on the
    grouped path (``hlo_analysis.record_step``, ``grouped_mm_flop``) equal
    the per-expert loop's under ``FlopCounterMode``; on fake tensors (the
    dry run's, routing split evenly) too."""
    cfg = configs.get_smoke("mixtral-8x7b")
    assert cfg.dtype == torch.bfloat16
    shape = configs.ShapeConfig("prefill_32k", 16, 2, "prefill")
    built = dryrun.build_step(cfg, shape, None, sparse=False, device="cpu")
    calls = [0]
    real = torch._grouped_mm

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(torch, "_grouped_mm", counted)
    if fake:
        with built.mode:
            rec = hlo_analysis.record_step(built.step, built.args)
        args = built.args
    else:
        g = torch.Generator().manual_seed(0)
        args = (model_zoo.get_model(cfg, "cpu").init(g),
                {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g,
                                         dtype=torch.int32)})
        rec = hlo_analysis.record_step(built.step, args)
    assert calls[0] == 3 * cfg.n_layers
    monkeypatch.setattr(moe, "takes_grouped", lambda xs, w: False)
    with contextlib.ExitStack() as stack:
        if fake:
            stack.enter_context(built.mode)
        with FlopCounterMode(display=False) as counter:
            built.step(*args)
    assert calls[0] == 3 * cfg.n_layers             # the loop ran instead
    assert rec.flops == counter.get_total_flops() > 0
