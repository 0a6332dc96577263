"""The dense family's fixed-shape decode step (the counterpart of the
reference's jitted decode, ``serving/families.CapturedStep``) on the CPU at
f32, smoke llama-paper, one torch intra-op thread.

- The fixed-shape decode views (``SlotPoolView.decode``,
  ``PagedPoolView.decode``: write indices computed from [B] cursor and
  ``n_new`` tensors) against the host-built views the decode used before
  (``build``), slot and paged, bf16 and int8 KV, over lanes that are
  active, mid-prefill, free, at the table's end and on a copied-on-write
  shared prefix block: every arena position (scales included; the trash
  block too, which an invalid pair writes back unchanged) bit-identical
  after the step, and the active lanes' logits identical.
- The write indices against the reference's own rules on the same tables
  and cursors: the paged view's are ``_write_slots``
  (``src/repro/serving/paged/pool.py:84``), the trash block's first
  position for every padding pair, and only the valid pairs write new
  bytes; the slot view's equal ``_flat_write_idx`` wherever that is inside
  the arena.
- Engine streams with prefix sharing and decode-pressure preemption equal
  the JAX engine's greedy streams, slot and paged, bf16 and int8 KV.
- The launch-counter bookkeeping a capture replays, and ``eager()``.

The graphs themselves need a card: ``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.cache_pool import SlotPoolView as JaxSlotPoolView  # noqa: E402
from repro.serving.paged import PagedPoolView as JaxPagedPoolView  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import fused_sparse_linear as fsl  # noqa: E402
from repro_torch.kernels import outlier_spmm  # noqa: E402, F401
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import (SamplingParams, ServingEngine,  # noqa: E402
                                 Status)
from repro_torch.serving import families  # noqa: E402
from repro_torch.serving.cache_pool import SlotPoolView  # noqa: E402
from repro_torch.serving.families import TransformerAdapter  # noqa: E402
from repro_torch.serving.paged import PagedPoolView  # noqa: E402
from repro_torch.serving.scheduler import \
    PREEMPT_DECODE_PRESSURE  # noqa: E402

JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           remat=False, dtype=jnp.float32)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          dtype=torch.float32)
N_SLOTS, MAX_LEN, BS = 5, 32, 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A small model: one intra-op thread, so several test workers on one
    machine do not oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def param_pair():
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, from_jax_params(jparams, device="cpu")


def _randomize(pool, seed):
    """Random arena contents (and positive scales), so that every read
    position carries a value of its own."""
    g = torch.Generator().manual_seed(seed)
    for a in (pool.k, pool.v):
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=g,
                                  dtype=torch.int8))
        else:
            a.copy_(torch.randn(a.shape, generator=g))
    for s in (pool.k_scale, pool.v_scale):
        if s is not None:
            s.copy_(torch.rand(s.shape, generator=g) * 0.05 + 0.01)


def _arenas(pool):
    return [a for a in (pool.k, pool.v, pool.k_scale, pool.v_scale)
            if a is not None]


def _slot_state(adapter):
    """Lanes: 0 active at 9, 1 mid-prefill at 5, 2 free at 0, 3 active at
    the arena's last position, 4 a stale cursor past the arena."""
    p = adapter.pool
    for _ in range(N_SLOTS):
        p.alloc()
    p.pos[:] = [9, 5, 0, MAX_LEN - 1, MAX_LEN]
    return [0, 3]


def _paged_state(adapter):
    """Row 0 decodes after a 13-token prefill (its prefix registered); row
    1 is mid-prefill at 8 on row 0's cached first block; row 2 is free;
    row 3 decodes at the table's last position; row 4 is a fork of row 0
    whose decode copies their shared second block on write."""
    p = adapter.pool
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, CFG.vocab, 13).tolist()
    row0, _ = p.admit(prompt)
    p.advance_prefill([row0], [13])
    p.register_prefix(row0, prompt)
    row1, n_cached = p.admit(prompt[:8] + [1, 2, 3, 4, 5], alloc_tokens=8)
    assert n_cached == 8
    p.advance_prefill([row1], [8])
    row2, _ = p.admit([7, 7, 7])
    row3, _ = p.admit(rng.integers(0, CFG.vocab, MAX_LEN - 1).tolist())
    p.advance_prefill([row3], [MAX_LEN - 1])
    row4 = p.fork(row0)
    p.release(row2)
    assert (row0, row1, row2, row3, row4) == (0, 1, 2, 3, 4)
    shared = p.tables[row0].blocks[1]
    cows = p.blocks.n_free
    p.prepare_decode([row0, row3, row4])
    assert p.tables[row0].blocks[1] != shared or \
        p.tables[row4].blocks[1] != shared
    assert p.blocks.n_free < cows
    return [row0, row3, row4]


def _host_view_step(adapter, tokens, active):
    """The decode as it ran before: the host-built view (``build``), only
    the real pairs written."""
    p = adapter.pool
    scales = dict(k_scale=p.k_scale, v_scale=p.v_scale)
    if adapter.kv_layout == "paged":
        n_new = np.zeros_like(p.pos)
        n_new[active] = 1
        view = PagedPoolView.build(p.k, p.v, p.host_tables, p.pos, n_new, 1,
                                   trash=p.trash_block,
                                   device_tables=p.block_tables, **scales)
    else:
        view = SlotPoolView.build(p.k, p.v, None, p.pos, np.ones_like(p.pos),
                                  1, **scales)
    with torch.no_grad():
        logits, _ = tfm.unified_step(adapter.params, view,
                                     {"tokens": torch.as_tensor(tokens)},
                                     CFG)
    return logits


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_fixed_shape_view_equals_host_built_view(param_pair, layout,
                                                 kv_dtype):
    adapter = TransformerAdapter(CFG, param_pair[1], n_slots=N_SLOTS,
                                 max_len=MAX_LEN, device=CPU,
                                 kv_layout=layout, block_size=BS,
                                 kv_dtype=kv_dtype)
    assert not adapter.graphed and adapter.decode_key(None) is None
    p = adapter.pool
    _randomize(p, seed=3)
    active = (_paged_state if layout == "paged" else _slot_state)(adapter)
    tokens = np.random.default_rng(2).integers(
        0, CFG.vocab, (N_SLOTS, 1)).astype(np.int64)
    before = [a.clone() for a in _arenas(p)]
    want = _host_view_step(adapter, tokens, active)
    want_arenas = [a.clone() for a in _arenas(p)]
    for a, b in zip(_arenas(p), before):
        a.copy_(b)
    got = adapter.step_decode(tokens, active)
    assert adapter.captured_decode.graphs == {}
    assert torch.equal(got[active], want[active])
    for a, w, b in zip(_arenas(p), want_arenas, before):
        assert torch.equal(a, w)
        assert not torch.equal(a, b)                     # the step wrote
        # the stale slot lane's row, the paged trash block: as they were
        untouched = 4 if layout == "slot" else p.trash_block
        assert torch.equal(a[:, untouched], b[:, untouched])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_write_indices_are_the_reference_write_slots(seed):
    """Random tables (trash-padded), cursors on, past and beyond the table
    and ``n_new`` of 0 and 1: the fixed-shape paged view writes where the
    reference's ``_write_slots`` does, padding into the trash block."""
    rng = np.random.default_rng(seed)
    B, nb, n_blocks, trash = 9, 4, 30, 0
    tables = rng.integers(1, n_blocks, (B, nb)).astype(np.int32)
    tables[rng.random((B, nb)) < 0.3] = trash
    cursor = rng.integers(0, nb * BS + 6, B).astype(np.int32)
    cursor[:3] = [nb * BS - 1, nb * BS, 0]
    n_new = rng.integers(0, 2, B).astype(np.int32)
    k = torch.zeros((1, n_blocks, BS, 1, 4))
    view = PagedPoolView.decode(k, k, torch.from_numpy(tables),
                                torch.from_numpy(cursor),
                                torch.from_numpy(n_new), trash=trash)
    ref = JaxPagedPoolView(None, None, jnp.asarray(tables),
                           jnp.asarray(cursor), jnp.asarray(n_new),
                           trash)._write_slots(BS, 1)
    assert view.write_src is None
    np.testing.assert_array_equal(view.write_dst.numpy(), np.asarray(ref))
    invalid = (n_new == 0) | (cursor // BS >= nb)
    assert invalid.any() and (~invalid).any()
    assert (view.write_dst.numpy()[invalid] == trash * BS).all()
    np.testing.assert_array_equal(view.write_keep.numpy(), ~invalid)


def test_paged_write_indices_on_the_pool_tables(param_pair):
    """The same rule on the lane patterns' own tables and cursors."""
    adapter = TransformerAdapter(CFG, param_pair[1], n_slots=N_SLOTS,
                                 max_len=MAX_LEN, device=CPU,
                                 kv_layout="paged", block_size=BS)
    p = adapter.pool
    active = _paged_state(adapter)
    n_new = np.zeros(N_SLOTS, np.int32)
    n_new[active] = 1
    view = PagedPoolView.decode(p.k, p.v, p.block_tables,
                                torch.from_numpy(p.pos),
                                torch.from_numpy(n_new), trash=p.trash_block)
    ref = JaxPagedPoolView(None, None, jnp.asarray(p.host_tables),
                           jnp.asarray(p.pos), jnp.asarray(n_new),
                           p.trash_block)._write_slots(BS, 1)
    np.testing.assert_array_equal(view.write_dst.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_write_indices_are_the_reference_flat_write_idx(seed):
    """Where the reference's ``_flat_write_idx`` lies inside the arena the
    slot view writes there; where it drops a pair (past the arena, or
    ``n_new`` 0) the view writes back inside the lane's own row."""
    rng = np.random.default_rng(seed)
    B, ml = 7, 16
    cursor = rng.integers(0, ml + 4, B)
    cursor[:2] = [ml - 1, ml]
    n_new = rng.integers(0, 2, B)
    n_new[:2] = 1
    k = torch.zeros((1, B, ml, 1, 4))
    view = SlotPoolView.decode(k, k, torch.from_numpy(cursor),
                               torch.from_numpy(n_new))
    ref = np.asarray(JaxSlotPoolView(
        None, None, None, jnp.asarray(cursor), jnp.asarray(n_new)
    )._flat_write_idx(B, ml, 1))
    keep = view.write_keep.numpy()
    inside = ref < B * ml
    np.testing.assert_array_equal(keep, inside)
    np.testing.assert_array_equal(view.write_dst.numpy()[keep], ref[keep])
    dst = view.write_dst.numpy()
    assert ((dst // ml) == np.arange(B)).all()
    assert (~keep).any()


# --------------------------------------------------------------------------
# engines against the JAX engine
# --------------------------------------------------------------------------

def _waves(layout):
    """(engine kwargs, waves of (prompt, max_new_tokens)).  Paged: one
    request registers a 16-token system prompt, then four sharing it run
    the arena dry mid-decode; slot: the same prompts in a slot pool, one
    of them filling its slot to the last position."""
    rng = np.random.default_rng(4)
    system = rng.integers(0, CFG.vocab, 2 * BS).tolist()
    tails = [rng.integers(0, CFG.vocab, 4 + i).tolist() for i in range(5)]
    first = [(system + tails[0], 6)]
    second = [(system + t, 14) for t in tails[1:]]
    if layout == "paged":
        kw = dict(n_slots=4, max_len=48, kv_layout="paged", block_size=BS,
                  n_blocks=12)
    else:
        kw = dict(n_slots=4, max_len=40)
        second[-1] = (second[-1][0], 40 - len(second[-1][0]))
    return kw, [first, second]


def _serve(engine, waves, sampling_cls):
    reqs = []
    for wave in waves:
        reqs += [engine.submit(p, sampling_cls(max_new_tokens=g))
                 for p, g in wave]
        engine.run(max_steps=400)
    return reqs


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_engine_streams_equal_the_jax_engine(param_pair, layout, kv_dtype):
    kw, waves = _waves(layout)
    jengine = JaxServingEngine(JCFG, param_pair[0], kv_dtype=kv_dtype, **kw)
    jreqs = _serve(jengine, waves, JaxSamplingParams)
    tengine = ServingEngine(CFG, param_pair[1], device="cpu",
                            kv_dtype=kv_dtype, **kw)
    treqs = _serve(tengine, waves, SamplingParams)
    for j, t in zip(jreqs, treqs):
        assert t.status is Status.FINISHED and j.status.name == "FINISHED"
        assert t.tokens == j.tokens, f"request {t.request_id} diverged"
    assert tengine.n_preemptions == jengine.n_preemptions
    if layout == "paged":
        pc = tengine.pool.prefix_cache.stats()
        assert pc["hits"] > 0 and pc["hit_tokens"] >= 4 * 2 * BS
        assert tengine.n_preemptions > 0
        assert any(r.metrics.last_preempt_reason == PREEMPT_DECODE_PRESSURE
                   for r in treqs)
        assert pc["hits"] == jengine.pool.prefix_cache.stats()["hits"]


# --------------------------------------------------------------------------
# what a capture replays
# --------------------------------------------------------------------------

def test_launch_counts_cover_every_wrapper_and_add_back():
    counts = common.launch_counts()
    mods = {m for m, _ in counts}
    assert mods == {"repro_torch.kernels.fused_sparse_linear",
                    "repro_torch.kernels.nm_spmm",
                    "repro_torch.kernels.outlier_spmm",
                    "repro_torch.serving.paged.paged_attention"}
    key = ("repro_torch.kernels.fused_sparse_linear", "launches_decode")
    assert counts[key] == fsl.launches_decode
    before = fsl.launches_decode
    try:
        common.add_launch_counts({key: 7})
        assert fsl.launches_decode == before + 7
        common.set_launch_counts(counts)
        assert fsl.launches_decode == before
    finally:
        fsl.launches_decode = before


def test_eager_nests_and_a_cpu_step_never_captures(param_pair):
    """``eager()`` nests and restores; on the CPU a decode call has no key,
    so it runs the fixed-shape step eagerly whatever the context."""
    adapter = TransformerAdapter(CFG, param_pair[1], n_slots=2,
                                 max_len=16, device=CPU, kv_layout="paged",
                                 block_size=BS)
    step = adapter.captured_decode
    assert step.captures(None) is None and step.captures((1,)) is True
    with families.eager():
        with families.eager():
            assert step.captures((1,)) is None
        assert step.captures((1,)) is None
    assert step.captures((1,)) is True
    tokens = np.zeros((2, 1), np.int64)
    with families.eager():
        a = adapter.step_decode(tokens, [])
    b = adapter.step_decode(tokens, [])
    assert torch.equal(a, b) and step.graphs == {} and step.n_replays == 0
