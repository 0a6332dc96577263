"""The port's training runtime against the JAX package's: checkpoints
(``runtime/checkpoint.py``), fault tolerance (``runtime/fault_tolerance.py``)
and the data sources (``data/pipeline.py``'s ``SyntheticLM``, ``TextFile``,
``prefetch``).

The first tests are the port's copies of ``tests/test_runtime.py``'s
checkpoint, fault-tolerance and data tests.  Then checkpoints cross both
ways, bit for bit: the port restores what the JAX ``CheckpointManager``
wrote of a JAX ``{params, opt}`` state of each family's smoke twin (bf16
leaves included), and JAX restores what the port wrote; both name their
leaves alike and write the same manifest keys and dtype strings.
"""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402
import json  # noqa: E402
import threading  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.runtime import checkpoint as jax_ckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import (SyntheticLM, TextFile,  # noqa: E402
                                       prefetch)
from repro_torch.interchange import (from_jax_layout,  # noqa: E402
                                     from_jax_params, to_jax_layout)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    HeartbeatRegistry, HostFailure, StragglerDetector, TrainSupervisor)
from repro_torch.tree import flatten  # noqa: E402

# one smoke twin a parameter layout: dense (vlm's is the same), moe (nested
# expert dicts), ssm, hybrid (an unstacked shared block), encdec
ARCHS = ["llama-paper", "mixtral-8x7b", "xlstm-350m", "zamba2-2.7b",
         "whisper-medium"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: these checks are tiny, and several test
    workers on one machine must not oversubscribe its cores (it changes no
    case and no tolerance); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


# ------------------------------------- the reference's tests, on the port
class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        cm = CheckpointManager(tmp_path)
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "b": {"c": torch.ones((2,), dtype=torch.int32)}}
        cm.save(5, tree)
        restored, manifest = cm.restore(tree)
        assert manifest["step"] == 5
        assert torch.equal(restored["a"], tree["a"])
        assert torch.equal(restored["b"]["c"], tree["b"]["c"])
        assert restored["b"]["c"].dtype == torch.int32

    def test_async_and_gc(self, tmp_path):
        cm = CheckpointManager(tmp_path, keep_last_k=2)
        tree = {"w": torch.ones((8, 8))}
        for s in (1, 2, 3, 4):
            cm.save(s, tree, blocking=False)
        cm.wait()
        cm._gc()
        steps = sorted(int(p.name.split("_")[1])
                       for p in tmp_path.glob("step_*"))
        assert steps == [3, 4]
        assert cm.latest_step() == 4

    def test_atomic_commit_no_partial(self, tmp_path):
        CheckpointManager(tmp_path)
        (tmp_path / "step_000009.tmp").mkdir()     # a crashed save's leftovers
        cm2 = CheckpointManager(tmp_path)          # a new run removes them
        assert not (tmp_path / "step_000009.tmp").exists()
        assert cm2.latest_step() is None


class TestFaultTolerance:
    def test_heartbeat(self):
        hb = HeartbeatRegistry(timeout_s=10)
        hb.beat(0, now=100.0)
        hb.beat(1, now=100.0)
        assert hb.healthy(now=105.0)
        hb.beat(0, now=112.0)
        assert hb.dead_hosts(now=115.0) == [1]

    def test_straggler_detection(self):
        sd = StragglerDetector(min_steps=3, k_sigma=2.0)
        for _ in range(6):
            for h in range(8):
                sd.record(h, 1.0 + (3.0 if h == 5 else 0.0))
        assert sd.stragglers() == [5]

    def test_supervisor_restart_resumes_from_checkpoint(self, tmp_path):
        cm = CheckpointManager(tmp_path)
        sup = TrainSupervisor(cm, save_every=5)
        fail_once = {"armed": True}

        def make_state(restored):
            return restored if restored is not None else {
                "x": torch.zeros(())}

        def step_fn(state, step):
            if step == 12 and fail_once["armed"]:
                fail_once["armed"] = False
                raise HostFailure("boom")
            return {"x": state["x"] + 1}, {"loss": float(state["x"])}

        rep = sup.run(make_state, step_fn, total_steps=20)
        assert rep.restarts == 1
        assert rep.restored_steps == [10]          # resumed at the last commit
        assert float(rep.losses[-1]) == 19.0       # state monotone, no gap


class TestData:
    def test_deterministic_resume(self):
        d1 = SyntheticLM(vocab=128, seq_len=16, batch=4, seed=3)
        d2 = SyntheticLM(vocab=128, seq_len=16, batch=4, seed=3)
        np.testing.assert_array_equal(d1.batch_at(17)["tokens"],
                                      d2.batch_at(17)["tokens"])

    def test_hosts_get_disjoint_streams(self):
        d = SyntheticLM(vocab=128, seq_len=16, batch=4, seed=3)
        assert not np.array_equal(d.batch_at(0, host=0)["tokens"],
                                  d.batch_at(0, host=1)["tokens"])

    def test_labels_shifted(self):
        b = SyntheticLM(vocab=128, seq_len=16, batch=4).batch_at(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ------------------------------------------------------ TextFile, prefetch
@pytest.fixture
def text_path(tmp_path):
    path = tmp_path / "corpus.txt"
    rng = np.random.default_rng(0)
    words = ["sparse", "outlier", "variance", "weights", "8:16", "\n"]
    path.write_text(" ".join(rng.choice(words, size=600)))
    return str(path)


def test_text_file_batches_match_jax(text_path):
    ours = TextFile(text_path, seq_len=24, batch=3, seed=5)
    ref = jax_pipeline.TextFile(text_path, seq_len=24, batch=3, seed=5)
    assert ours.vocab == ref.vocab == 256
    raw = open(text_path, "rb").read()
    for step, host in ((0, 0), (7, 0), (7, 1)):
        got, want = ours.batch_at(step, host), ref.batch_at(step, host)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        # each window is a run of the file's bytes, labels shifted by one
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])
        row = bytes(got["tokens"][0].astype(np.uint8))
        assert row in raw
    assert not np.array_equal(ours.batch_at(7, 0)["tokens"],
                              ours.batch_at(7, 1)["tokens"])


@pytest.mark.parametrize("depth", [0, 2, 5])
def test_prefetch_yields_the_stream_in_order(text_path, depth):
    src = TextFile(text_path, seq_len=8, batch=2, seed=1)
    got = list(prefetch(src, steps=4, start=3, host=1, depth=depth))
    want = list(jax_pipeline.prefetch(
        jax_pipeline.TextFile(text_path, seq_len=8, batch=2, seed=1),
        steps=4, start=3, host=1, depth=depth))
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["tokens"],
                                      src.batch_at(3 + i, 1)["tokens"])


def test_prefetch_reads_ahead_by_depth():
    seen = []

    class Source:
        def batch_at(self, step, host=0):
            seen.append(step)
            return step

    it = prefetch(Source(), steps=6, depth=2)
    assert next(it) == 0 and seen == [0, 1, 2]
    assert list(it) == [1, 2, 3, 4, 5]


# ------------------------------------------------- checkpoints both ways
@functools.cache
def _jax_state(arch):
    jcfg = jax_configs.get_smoke(arch)
    jp = jax.jit(jax_get_model(jcfg).init)(jax.random.PRNGKey(0))
    opt = jax_adamw_init(jp, JaxAdamWConfig())
    # moments that are not all zero, and a step that is not 0
    opt = {"m": jax.tree.map(lambda p: (p * 0.5).astype(jnp.float32), jp),
           "v": jax.tree.map(lambda p: (p * p).astype(jnp.float32), jp),
           "step": opt["step"] + 3}
    return jcfg, {"params": jp, "opt": opt}


def _port_like(jstate):
    params = from_jax_params(jstate["params"], device="cpu")
    return {"params": params, "opt": adamw_init(params, AdamWConfig())}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_restores_a_jax_checkpoint_bit_for_bit(arch, tmp_path):
    jcfg, jstate = _jax_state(arch)
    jax_ckpt.CheckpointManager(tmp_path).save(7, jstate, cfg=jcfg)
    like = _port_like(jstate)
    assert ckpt._leaf_names(like) == jax_ckpt._leaf_names(jstate)
    restored, manifest = CheckpointManager(tmp_path).restore(like)
    assert manifest["step"] == 7
    want = {"params": from_jax_params(jstate["params"], device="cpu"),
            "opt": {"m": from_jax_params(jstate["opt"]["m"], device="cpu"),
                    "v": from_jax_params(jstate["opt"]["v"], device="cpu"),
                    "step": torch.tensor(3, dtype=torch.int32)}}
    got, exp = flatten(restored), flatten(want)
    assert len(got) == len(exp) == len(flatten(like))
    assert any(t.dtype == torch.bfloat16 for t in got)
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.ndim else a,
                           b.view(torch.uint8) if b.ndim else b)
    # the per-layer lists come back as the port keeps them
    assert isinstance(restored["params"][
        "mamba" if "mamba" in restored["params"] else
        "enc" if "enc" in restored["params"] else "layers"], list)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_restores_a_port_checkpoint_bit_for_bit(arch, tmp_path):
    jcfg, jstate = _jax_state(arch)
    port_state = {"params": from_jax_params(jstate["params"], device="cpu"),
                  "opt": {"m": from_jax_params(jstate["opt"]["m"], "cpu"),
                          "v": from_jax_params(jstate["opt"]["v"], "cpu"),
                          "step": torch.tensor(3, dtype=torch.int32)}}
    cfg = configs.get_smoke(arch)
    cm = CheckpointManager(tmp_path)
    cm.save(9, port_state, cfg=cfg, blocking=False)
    cm.wait()
    jcm = jax_ckpt.CheckpointManager(tmp_path)
    assert jcm.latest_step() == 9
    restored, manifest = jcm.restore(jstate)
    got, want = jax.tree.leaves(restored), jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert manifest["config_hash"] == ckpt.config_hash(cfg)


def test_manifests_agree_with_the_reference(tmp_path):
    """The same keys, leaf names, shapes and dtype strings (numpy's names:
    ``bfloat16``, ``float32``, ``int32``, not ``torch.bfloat16``)."""
    jcfg, jstate = _jax_state("llama-paper")
    jax_ckpt.CheckpointManager(tmp_path / "jax").save(2, jstate)
    CheckpointManager(tmp_path / "port").save(2, _port_like(jstate))
    jm = json.loads((tmp_path / "jax/step_000002/manifest.json").read_text())
    tm = json.loads((tmp_path / "port/step_000002/manifest.json").read_text())
    assert sorted(jm) == sorted(tm)
    assert tm["leaves"] == jm["leaves"]
    assert {m["dtype"] for m in tm["leaves"].values()} == {
        "bfloat16", "float32", "int32"}
    assert tm["process_count"] == jm["process_count"] == 1


def test_bf16_is_stored_as_its_16_bit_pattern(tmp_path):
    w = torch.randn((4, 8), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    CheckpointManager(tmp_path).save(1, {"w": w})
    with np.load(tmp_path / "step_000001/shard_00000.npz") as z:
        stored = z["w"]
    assert stored.dtype == np.uint16
    np.testing.assert_array_equal(stored.view(np.int16),
                                  w.view(torch.int16).numpy())
    restored, manifest = CheckpointManager(tmp_path).restore({"w": w})
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), w.view(torch.int16))


def test_async_save_copies_on_the_callers_thread(tmp_path, monkeypatch):
    """An in-place update right after ``save(blocking=False)`` returns does
    not reach the checkpoint: the host copy is made before the write
    thread starts (on the CPU ``numpy()`` would share the tensor's
    memory).  The write is held until the update is done."""
    updated = threading.Event()
    real = np.savez

    def held(*args, **kw):
        assert updated.wait(30)
        real(*args, **kw)
    monkeypatch.setattr(ckpt.np, "savez", held)
    w = torch.arange(6.0)
    layers = [{"a": torch.ones(3)}, {"a": torch.full((3,), 2.0)}]
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"w": w, "layers": layers}, blocking=False)
    w.add_(100.0)
    layers[0]["a"].mul_(-1.0)
    updated.set()
    cm.wait()
    restored, _ = cm.restore({"w": w, "layers": layers})
    assert torch.equal(restored["w"], torch.arange(6.0))
    assert torch.equal(restored["layers"][0]["a"], torch.ones(3))


def test_config_hash_is_the_sha1_of_repr(tmp_path):
    """``config_hash`` hashes ``repr(cfg)`` as the reference's does.  The
    two packages' configs differ in their repr only by ``dtype`` (a torch
    dtype against JAX's), so their hashes differ; the reference's restore
    never reads the hash."""
    import hashlib
    for arch in ("llama3-8b", "mixtral-8x7b", "qwen2-vl-72b",
                 "whisper-medium"):
        cfg, jcfg = configs.get(arch), jax_configs.get(arch)
        assert ckpt.config_hash(cfg) == hashlib.sha1(
            repr(cfg).encode()).hexdigest()[:12]
        ours = repr(cfg).replace("dtype=torch.bfloat16", "dtype=DT")
        ref = repr(jcfg).replace("dtype=<class 'jax.numpy.bfloat16'>",
                                 "dtype=DT")
        assert ours == ref
        assert ckpt.config_hash(cfg) != jax_ckpt.config_hash(jcfg)


def test_restore_onto_a_mesh_raises_naming_a12(tmp_path):
    """``restore(shardings=)`` returns this rank's blocks by the specs: on
    a stand-in 2x2 mesh at coordinates (1, 0), rows [4, 8) of a [8, 6]
    leaf split over data, columns [3, 6) of one split over model, and a
    replicated leaf whole; the global shapes are checked against the
    manifest's."""
    from repro_torch.parallel.fsdp import StateSharding, TrainMesh

    class _Coords(TrainMesh):
        def __init__(self):
            self.sizes, self.coords = {"data": 2, "model": 2}, \
                {"data": 1, "model": 0}

    w = torch.arange(48.0).reshape(8, 6)
    tree = {"a": w, "b": w + 100, "c": torch.ones(3)}
    CheckpointManager(tmp_path).save(1, tree)
    sh = StateSharding(_Coords(), {"a": ("data", None),
                                   "b": (None, "model"), "c": (None,)},
                       {"a": (8, 6), "b": (8, 6), "c": (3,)})
    like = {"a": torch.zeros(4, 6), "b": torch.zeros(8, 3),
            "c": torch.zeros(3)}
    got, manifest = CheckpointManager(tmp_path).restore(like, shardings=sh)
    assert manifest["step"] == 1
    assert torch.equal(got["a"], w[4:8])
    assert torch.equal(got["b"], w[:, 0:3] + 100)
    assert torch.equal(got["c"], torch.ones(3))
    bad = StateSharding(sh.tm, sh.specs,
                        {"a": (8, 7), "b": (8, 6), "c": (3,)})
    with pytest.raises(ValueError, match="shape mismatch"):
        CheckpointManager(tmp_path).restore(like, shardings=bad)


def test_restore_checks_shapes_and_finds_nothing(tmp_path):
    cm = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        cm.restore({"w": torch.ones(2)})
    cm.save(1, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        cm.restore({"w": torch.ones(3)})


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_layout_round_trips(arch):
    """``to_jax_layout`` stacks exactly what ``from_jax_params`` split (every
    leaf of the JAX tree, nested moe dicts included), and
    ``from_jax_layout`` splits it back."""
    jcfg, jstate = _jax_state(arch)
    params = from_jax_params(jstate["params"], device="cpu")
    stacked = to_jax_layout(params)
    jleaves = jax.tree.leaves(jstate["params"])
    got = flatten(stacked)
    assert len(got) == len(jleaves)
    for a, b in zip(got, jleaves):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a.view(torch.int16).numpy()
                                            if a.dtype == torch.bfloat16
                                            else a.numpy()), _bits(b))
    back = from_jax_layout(stacked)
    assert all(torch.equal(a, b) for a, b in zip(flatten(back),
                                                 flatten(params)))
