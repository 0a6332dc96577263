"""The dry run (``repro_torch/launch/dryrun.py``, ``launch/hlo_analysis.py``,
``models/model_zoo.param_specs``, ``models/sparse_serving.sparsify_specs``
and the weight kernels' wrappers on fake CUDA tensors) against the JAX
package's ``launch/dryrun.py`` and ``launch/hlo_analysis.py``, on the CPU.

- ``param_specs``: every ``ASSIGNED`` arch, llama-paper (its smoke twin,
  the only size it is registered at) and llama3-8b at full size; the
  port's per-layer leaves, mapped to JAX's stacked paths
  (``parallel/sharding.jax_path``), equal JAX's ``param_specs`` in paths,
  shapes and dtypes.
- Compressed shapes: qwen3-8b, mixtral-8x7b and whisper-medium at full
  size, ``quant`` False and True: every ``SparseWeight`` buffer equals
  JAX's ``jax.eval_shape`` of ``sparsify_for_serving`` leaf by leaf
  (stacked [L, ...] against per layer, and the leaf rule of ROADMAP C,
  PR 28: both packages keep the routed experts and the router dense).
- Argument bytes of every ``ASSIGNED`` training cell on 16x16 and
  2x16x16, at rank 0 and the last rank: equal to the byte to the sum of
  ``NamedSharding(mesh, spec).shard_shape`` bytes over JAX's
  ``param_shardings`` (with ``dryrun.py``'s ssm rule), ``adamw_init``
  under ``_opt_cfg`` and ``batch_shardings``, on virtual JAX meshes.
- Collectives: a ``shard_map`` with one all-gather, psum, psum_scatter and
  all_to_all, compiled on 4 forced host devices in a subprocess and read
  by the reference's ``collective_bytes``/``collective_counts``, against
  the port's recorder over the same operands on a fake world of 4.
- Smoke twins of every family x train, prefill, decode (and long_500k for
  ssm and hybrid) on a fake 2x2 world on the CPU; at a world of one the
  dry run's FLOPs and argument bytes equal ``FlopCounterMode`` and the
  inputs of the step run for real on the CPU; ``depth_probe``'s fit
  equals the full-depth counts at rtol 1e-9 on twins deeper than
  ``PROBE_DEPTHS``' second depth.  (Fake CUDA tensors cannot be indexed
  by a CPU-only PyTorch, so the same cells on fake ``cuda`` run on the
  card: ``tests/test_torch_dryrun_cuda.py``.)
- The reference's pure parts: ``iter_cells``, a skipped cell's record key
  for key, the file names and the CLI's flags.
- The three weight kernels' wrappers on fake CUDA tensors at M 8 and 512:
  the plain version's shape and dtype, nothing built or launched, and the
  recorded plan equal to ``plan(M, K, N, ..., 132)``.
"""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.launch import dryrun as jax_dryrun  # noqa: E402
from repro.launch import hlo_analysis as jax_hlo  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import SparsifyConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fused_sparse_linear as fsl  # noqa: E402
from repro_torch.kernels import nm_spmm as nms  # noqa: E402
from repro_torch.kernels import outlier_spmm as osp  # noqa: E402
from repro_torch.kernels.common import (H100_SM_COUNT,  # noqa: E402
                                        recording_fake_launches)
from repro_torch.launch import dryrun, hlo_analysis, steps  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models.sparse_serving import sparsify_specs  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel.sharding import jax_path, tree_paths  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PARAM_ARCHS = list(configs.ASSIGNED) + ["llama-paper", "llama3-8b"]
SPARSE_ARCHS = ["qwen3-8b", "mixtral-8x7b", "whisper-medium"]
FAMILY_TWINS = {"dense": "llama-paper", "moe": "mixtral-8x7b",
                "vlm": "qwen2-vl-72b", "ssm": "xlstm-350m",
                "hybrid": "zamba2-2.7b", "encdec": "whisper-medium"}
# the smoke cells' shapes: (kind, global batch, sequence), batch rows over
# the 2x2 world's 2 data shards
SMOKE_SHAPES = {"train_4k": ("train", 4, 8),
                "prefill_32k": ("prefill", 4, 16),
                "decode_32k": ("decode", 4, 32),
                "long_500k": ("decode", 1, 32)}
PROBE_RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so several test workers on one machine do not
    oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """(the port's config, JAX's) of an arch id; llama-paper is registered
    only as its smoke twin."""
    if arch == "llama-paper":
        return configs.get_smoke(arch), jax_configs.get_smoke(arch)
    return configs.get(arch), jax_configs.get(arch)


def _jax_leaves(tree) -> dict:
    """{path: leaf} of a JAX pytree, paths named as the port's
    ``tree_paths`` names them (``layers/wq``, ``layers/wq/.nm_values``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for k in path:
            if isinstance(k, jax.tree_util.GetAttrKey):
                parts.append("." + k.name)
            else:
                parts.append(str(getattr(k, "key", getattr(k, "idx", k))))
        out["/".join(parts)] = leaf
    return out


def _port_as_jax(tree) -> dict:
    """{JAX path: (shape, dtype name)} of a port tree: a per-layer leaf's
    layers stacked in front, every layer's shape and dtype the same."""
    groups = {}
    for path, leaf in tree_paths(tree):
        name, stacked = jax_path(path)
        groups.setdefault(name, []).append(
            (stacked, tuple(leaf.shape), str(leaf.dtype).split(".")[-1]))
    out = {}
    for name, items in groups.items():
        stacked, shape, dtype = items[0]
        assert all(i[1:] == (shape, dtype) for i in items), name
        out[name] = (((len(items),) + shape) if stacked else shape, dtype)
    return out


def _jax_as_spec(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in _jax_leaves(tree).items()}


# --------------------------------------------------------------------------
# 1. param_specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PARAM_ARCHS)
def test_param_specs_equal_jax(arch):
    cfg, jcfg = _cfgs(arch)
    port = model_zoo.param_specs(cfg, "cpu")
    leaves = [t for _, t in tree_paths(port)]
    assert leaves and all(type(t).__name__ == "FakeTensor" for t in leaves)
    assert _port_as_jax(port) == _jax_as_spec(jax_zoo.param_specs(jcfg))


# --------------------------------------------------------------------------
# 2. compressed shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", SPARSE_ARCHS)
def test_sparsify_specs_equal_jax_eval_shape(arch, quant):
    cfg, jcfg = _cfgs(arch)
    port, report = sparsify_specs(
        model_zoo.param_specs(cfg, "cpu"),
        SparsifyConfig(scorer="magnitude", use_smoothquant=False),
        quantize=quant)
    jscfg = JaxSparsifyConfig(scorer="magnitude", use_smoothquant=False)
    ref = jax.eval_shape(
        lambda p: jax_sparsify(p, jscfg, quantize=quant)[0],
        jax_zoo.param_specs(jcfg))
    want = _jax_as_spec(ref)
    assert _port_as_jax(port) == want
    assert any(k.endswith("/.nm_values") for k in want)
    assert any(k.endswith("/.v_scale") for k in want) == quant
    # the routed experts and the router stay dense in both packages
    assert not any("we_" in k and "/." in k for k in want)
    assert report["n_layers_sparsified"] == sum(
        1 for k in tree_paths(port) if k[0].endswith("/.nm_values"))


# --------------------------------------------------------------------------
# 3. argument bytes of the training cells
# --------------------------------------------------------------------------

def _jax_mesh(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * n)[:n].reshape(shape)
    return jax.sharding.Mesh(devs, names)


@functools.lru_cache(maxsize=None)
def _jax_train_state(arch):
    """JAX's param, AdamW-state (under ``_opt_cfg``) and train_4k batch
    specs of an arch."""
    jcfg = _cfgs(arch)[1]
    params = jax_zoo.param_specs(jcfg)
    ocfg = jax_dryrun._opt_cfg(jcfg)
    opt = jax.eval_shape(lambda p: jax_adamw_init(p, ocfg), params)
    return params, opt, jax_zoo.input_specs(jcfg,
                                            jax_configs.SHAPES["train_4k"])


def _jax_train_argument_bytes(arch, mesh) -> int:
    """The reference's per-device argument bytes of its train_4k cell:
    ``build_lowered``'s shardings (params with the ssm rule, the AdamW
    state under ``_opt_cfg``, the batch), each leaf's shard shape."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    jcfg = _cfgs(arch)[1]
    params, opt, batch = _jax_train_state(arch)

    def shardings(tree):
        sh = jsh.param_shardings(mesh, tree)
        if jcfg.family == "ssm":
            def drop_model(path, ns):
                name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                for k in path)
                if "embed" in name or "lm_head" in name:
                    return ns
                spec = tuple(None if ax == "model" or
                             (isinstance(ax, tuple) and "model" in ax)
                             else ax for ax in ns.spec)
                return NamedSharding(mesh, P(*spec))
            sh = jax.tree_util.tree_map_with_path(drop_model, sh)
        return sh
    total = 0
    for tree, sh in ((params, shardings(params)), (opt, shardings(opt)),
                     (batch, jsh.batch_shardings(mesh, batch))):
        for leaf, ns in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)):
            total += int(np.prod(ns.shard_shape(leaf.shape))) \
                * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_shape", [(16, 16), (2, 16, 16)],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", list(configs.ASSIGNED))
def test_train_argument_bytes_equal_jax_shard_bytes(arch, mesh_shape):
    cfg = _cfgs(arch)[0]
    want = _jax_train_argument_bytes(arch, _jax_mesh(mesh_shape))
    last = int(np.prod(mesh_shape)) - 1
    for rank in (0, last):
        with dryrun.FakeWorld(mesh_shape, rank, "cpu") as mesh:
            built = dryrun.build_step(cfg, configs.SHAPES["train_4k"], mesh,
                                      device="cpu")
            assert built.argument_bytes == want, (arch, mesh_shape, rank)
    assert not torch.distributed.is_initialized()


def test_ssm_rule_keeps_model_only_on_embed_and_head():
    """xlstm's blocks drop their ``model`` split; embed and lm_head keep
    it (``dryrun.py:76-92``)."""
    from repro_torch.launch.train import build as train_build
    cfg = configs.get("xlstm-350m")
    with dryrun.FakeWorld((16, 16), 0, "cpu") as mesh:
        _, p_sh, _ = train_build(cfg, dryrun._opt_cfg(cfg),
                                 steps.TrainOptions(), mesh)
        dropped = dryrun._drop_model(p_sh)
    for (path, spec), (_, was) in zip(tree_paths(dropped.specs),
                                      tree_paths(p_sh.specs)):
        uses_model = any(a == "model" or (isinstance(a, tuple)
                                          and "model" in a) for a in spec)
        if "embed" in path or "lm_head" in path:
            assert spec == was
        else:
            assert not uses_model, path


# --------------------------------------------------------------------------
# 4. collective accounting
# --------------------------------------------------------------------------

JAX_COLLECTIVES = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.launch.hlo_analysis import (COLLECTIVES, _type_bytes,
                                       collective_bytes, collective_counts)
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
mesh = Mesh(np.array(jax.devices()).reshape(4), ("x",))
def body(a, b, c, d):
    return (jax.lax.all_gather(a, "x", tiled=True), jax.lax.psum(b, "x"),
            jax.lax.psum_scatter(c, "x", scatter_dimension=0, tiled=True),
            jax.lax.all_to_all(d, "x", 0, 0, tiled=True))
spec = P("x")
f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                      out_specs=(spec,) * 4))
# the global arrays: 4 per-device blocks along dim 0
args = [jnp.zeros((4 * s[0], *s[1:]), getattr(jnp, d))
        for s, d in json.loads(sys.argv[1])]
hlo = f.lower(*args).compile().as_text()
emitted = {}
for ln in hlo.splitlines():
    for kind in COLLECTIVES:
        if f" {kind}(" in ln:
            ty = ln.split("=", 1)[1].strip().split(f" {kind}(")[0]
            emitted[kind] = ty
print(json.dumps({"bytes": collective_bytes(hlo),
                  "counts": collective_counts(hlo), "emitted": emitted,
                  "emitted_bytes": {k: _type_bytes(v)
                                    for k, v in emitted.items()}}))
'''
# per-device operands: all-gather bf16 [8, 16], psum f32 [4, 32],
# psum_scatter bf16 [16, 8] (to [4, 8]), all_to_all f32 [8, 6]
COLL_OPERANDS = [((8, 16), "bfloat16"), ((4, 32), "float32"),
                 ((16, 8), "bfloat16"), ((8, 6), "float32")]
_TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _port_collectives(dtypes) -> dict:
    """The port's recorder over the four collectives on a fake world of
    4, each operand in the dtype given for its kind."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with FakeTensorMode():
            a = torch.zeros(8, 16, dtype=dtypes["all-gather"])
            b = torch.zeros(4, 32, dtype=dtypes["all-reduce"])
            c = torch.zeros(16, 8, dtype=dtypes["reduce-scatter"])
            d = torch.zeros(8, 6, dtype=dtypes["all-to-all"])

            def step(a, b, c, d):
                g = a.new_empty(32, 16)
                dist.all_gather_into_tensor(g, a)
                dist.all_reduce(b)
                r = c.new_empty(4, 8)
                dist.reduce_scatter_tensor(r, c)
                t = torch.empty_like(d)
                dist.all_to_all_single(t, d)
                return g, b, r, t
            rec = hlo_analysis.record_step(step, (a, b, c, d))
    finally:
        dist.destroy_process_group()
    return {"bytes": hlo_analysis.collective_bytes(rec),
            "counts": hlo_analysis.collective_counts(rec)}


def test_collective_accounting_equals_the_reference_on_compiled_hlo():
    """XLA's CPU backend rewrites two of the ops, and the test compares
    the op it emits: it runs the bf16 all-gather and reduce-scatter in f32
    (the port is given those operands in f32), and it emits the
    all_to_all over four slices made by fusions, whose sizes the
    reference's parser does not resolve (it counts the op but reports 0
    bytes), so that kind's bytes are read off the emitted op's type with
    the reference's ``_type_bytes``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", JAX_COLLECTIVES,
                        json.dumps(COLL_OPERANDS)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    ref = json.loads(p.stdout.strip().splitlines()[-1])
    emitted = ref["emitted"]
    assert set(emitted) == {"all-gather", "all-reduce", "reduce-scatter",
                            "all-to-all"}
    dtypes = {k: _TORCH_DTYPE[v.lstrip("(").split("[")[0]]
              for k, v in emitted.items()}
    port = _port_collectives(dtypes)
    assert port["counts"] == ref["counts"]
    want = dict(ref["bytes"])
    if want.get("all-to-all", 0.0) == 0.0:
        want["all-to-all"] = float(ref["emitted_bytes"]["all-to-all"])
    want["total"] = sum(v for k, v in want.items() if k != "total")
    assert port["bytes"] == want


def test_recorder_sees_bf16_operands_at_their_width():
    """The port runs a bf16 collective in bf16: its operand bytes are
    half the f32 ones XLA's CPU backend emits."""
    f32 = _port_collectives({k: torch.float32 for k in hlo_analysis.
                             COLLECTIVES})
    bf16 = _port_collectives({k: torch.bfloat16 for k in hlo_analysis.
                              COLLECTIVES})
    assert {k: 2 * v for k, v in bf16["bytes"].items()} == f32["bytes"]
    assert bf16["counts"] == f32["counts"]


# --------------------------------------------------------------------------
# 5. smoke cells end to end
# --------------------------------------------------------------------------

def _smoke_cells():
    for fam, arch in FAMILY_TWINS.items():
        for name in SMOKE_SHAPES:
            if name == "long_500k" and fam not in ("ssm", "hybrid"):
                continue
            yield arch, name


def _smoke_shape(name):
    kind, B, S = SMOKE_SHAPES[name]
    return configs.ShapeConfig(name, S, B, kind)


@pytest.mark.parametrize("arch,shape_name", list(_smoke_cells()))
def test_smoke_cell_on_a_fake_2x2_world(arch, shape_name, tmp_path):
    cfg = configs.get_smoke(arch)
    rec = dryrun.run_cell(arch, shape_name, False, probe=False,
                          out_dir=tmp_path, verbose=False, device="cpu",
                          cfg=cfg, shape=_smoke_shape(shape_name),
                          mesh_shape=(2, 2))
    assert rec["status"] == "ok", rec.get("traceback")
    full = rec["full"]
    assert full["flops"] > 0 and full["bytes_accessed"] > 0
    assert set(full["memory"]) == set(hlo_analysis.MEMORY_KEYS)
    assert full["memory"]["generated_code_size_in_bytes"] == 0
    counts = full["collective_counts"]
    assert set(counts) == set(hlo_analysis.COLLECTIVES)
    # the model axis gathers every placed projection's rows (serving) or
    # every block (training)
    assert counts["all-gather"] > 0
    if shape_name == "train_4k":
        assert counts["reduce-scatter"] > 0
        assert full["memory"]["alias_size_in_bytes"] > 0
    if shape_name == "long_500k":
        assert "seq_shard" in rec["placement"]
    on_disk = json.loads((tmp_path / f"{arch}__{shape_name}__pod16x16.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch,shape_name,quant", [
    ("llama-paper", "prefill_32k", True), ("mixtral-8x7b", "decode_32k",
                                            False)])
def test_sparse_smoke_cell_on_a_fake_2x2_world(arch, shape_name, quant,
                                               tmp_path):
    """A serving cell with the compressed weights: the record's mesh tag
    and file name take ``_sparse`` (and ``q``), and on the CPU the plain
    versions run (no launch recorded)."""
    rec = dryrun.run_cell(arch, shape_name, False, probe=False,
                          out_dir=tmp_path, verbose=False, sparse=True,
                          quant=quant, device="cpu",
                          cfg=configs.get_smoke(arch),
                          shape=_smoke_shape(shape_name), mesh_shape=(2, 2))
    tag = "pod16x16_sparse" + ("q" if quant else "")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == tag
    assert (tmp_path / f"{arch}__{shape_name}__{tag}.json").exists()
    assert rec["full"]["kernel_launches"] == {}


def _real_inputs(cfg, built, g):
    """Real CPU tensors like ``built``'s fake inputs: the params drawn from
    ``g`` (8:16 + 16:256 by magnitude for a serving step), the batch's
    tokens random, the caches zero."""
    from repro_torch.launch.serve import build_params, parse_args
    if len(built.args) == 3 and isinstance(built.args[1], dict) \
            and "m" in built.args[1]:
        params = model_zoo.get_model(cfg, "cpu").init(g)
        opt = adamw_init(params, dryrun._opt_cfg(cfg))
        lead = (params, opt)
    else:
        args = parse_args(["--arch", "llama-paper", "--smoke-arch",
                           "--sparse"])
        lead = (build_params(cfg, args, "cpu", g)[0],)

    def like(t):
        if isinstance(t, (list, tuple)):
            return type(t)(like(v) for v in t)
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, cfg.vocab, t.shape, generator=g,
                                 dtype=t.dtype)
        if t.dtype.is_floating_point and t.ndim == 3:
            return torch.randn(t.shape, generator=g).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    rest = tuple({k: like(v) for k, v in a.items()}
                 for a in built.args[len(lead):])
    return lead + rest


@pytest.mark.parametrize("arch,shape_name", [
    ("llama-paper", "train_4k"), ("llama-paper", "prefill_32k"),
    ("llama-paper", "decode_32k"), ("mixtral-8x7b", "prefill_32k"),
    ("xlstm-350m", "decode_32k"), ("whisper-medium", "train_4k")])
def test_world_of_one_matches_the_real_cpu_step(arch, shape_name):
    cfg = configs.get_smoke(arch)
    shape = _smoke_shape(shape_name)
    sparse = shape.kind != "train"
    built = dryrun.build_step(cfg, shape, None, sparse=sparse, device="cpu")
    with built.mode:
        rec = hlo_analysis.record_step(built.step, built.args,
                                       donated=built.donated)
    args = _real_inputs(cfg, built, torch.Generator().manual_seed(0))
    if not (len(args) == 3 and "m" in args[1]):
        # the serving steps' params: the dry run's 8:16 + 16:256 leaves
        assert [(p, tuple(t.shape), t.dtype) for p, t in
                tree_paths(args[0])] == [(p, tuple(t.shape), t.dtype) for
                                         p, t in tree_paths(built.args[0])]
    assert hlo_analysis.nbytes(args) == built.argument_bytes
    with FlopCounterMode(display=False) as counter:
        built.step(*args)
    assert rec.flops == counter.get_total_flops()
    assert rec.kernel_launches == []          # the CPU runs plain versions


@pytest.mark.parametrize("arch,shape_name,depth", [
    ("llama-paper", "train_4k", 6), ("xlstm-350m", "decode_32k", 24),
    ("zamba2-2.7b", "long_500k", 18),
    ("whisper-medium", "decode_32k", 6)])
def test_depth_probe_fit_reproduces_the_full_depth(arch, shape_name, depth):
    cfg = dryrun._reduce_depth(configs.get_smoke(arch), depth)
    assert depth > dryrun.PROBE_DEPTHS[cfg.family][1]
    shape = _smoke_shape(shape_name)
    with dryrun.FakeWorld((2, 2), 0, "cpu") as mesh:
        full = dryrun.analyse(dryrun.build_step(
            cfg, shape, mesh, sparse=shape.kind != "train", device="cpu"))
        probe = dryrun.depth_probe(cfg, shape, mesh,
                                   sparse=shape.kind != "train",
                                   device="cpu")
    assert probe["depths"] == list(dryrun.PROBE_DEPTHS[cfg.family])
    np.testing.assert_allclose(probe["flops"], full["flops"],
                               rtol=PROBE_RTOL)
    np.testing.assert_allclose(probe["bytes_accessed"],
                               full["bytes_accessed"], rtol=PROBE_RTOL)
    np.testing.assert_allclose(probe["collective_bytes"],
                               full["collective_bytes"]["total"],
                               rtol=PROBE_RTOL)


def test_depth_probe_keeps_the_full_cells_microbatches(monkeypatch):
    """A model above 30e9 params trains in 8 microbatches, and so do its
    reduced-depth probes (whose own param counts fall below 30e9), or
    the fit would mix the two counts."""
    cfg = configs.get("nemotron-4-340b")
    seen = []

    def build(c, shape, mesh, sparse=False, quant=False, *, device,
              opts=None):
        seen.append((c.n_layers, opts))
        return None
    monkeypatch.setattr(dryrun, "build_step", build)
    monkeypatch.setattr(dryrun, "analyse", lambda b: {
        "flops": 0.0, "bytes_accessed": 0.0, "collective_bytes": {}})
    dryrun.depth_probe(cfg, configs.SHAPES["train_4k"], None, device="cpu")
    assert dryrun._train_opts(cfg).microbatches == 8
    assert dryrun._reduce_depth(cfg, 4).param_count() < 30e9
    assert seen == [(L, dryrun._train_opts(cfg))
                    for L in dryrun.PROBE_DEPTHS["dense"]]


# --------------------------------------------------------------------------
# 6. the reference's pure parts
# --------------------------------------------------------------------------

def test_iter_cells_and_constants_equal_the_reference():
    assert list(dryrun.iter_cells()) == list(jax_dryrun.iter_cells())
    assert dryrun.PROBE_DEPTHS == jax_dryrun.PROBE_DEPTHS
    assert hlo_analysis.COLLECTIVES == jax_hlo.COLLECTIVES
    assert hlo_analysis._DTYPE_BYTES == jax_hlo._DTYPE_BYTES
    for arch in configs.ASSIGNED:
        cfg, jcfg = _cfgs(arch)
        assert (dryrun._opt_cfg(cfg).state_dtype == torch.bfloat16) == (
            jax_dryrun._opt_cfg(jcfg).state_dtype == jnp.bfloat16)
        for L in (2, 6):
            a, b = dryrun._reduce_depth(cfg, L), jax_dryrun._reduce_depth(
                jcfg, L)
            assert (a.n_layers, a.enc_layers) == (b.n_layers, b.enc_layers)


@pytest.mark.parametrize("multi_pod,sparse,quant", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, True, True)])
def test_skipped_cell_record_equals_the_reference(tmp_path, multi_pod,
                                                  sparse, quant):
    want = jax_dryrun.run_cell("qwen3-8b", "long_500k", multi_pod,
                               out_dir=tmp_path / "jax", verbose=False,
                               sparse=sparse, quant=quant)
    got = dryrun.run_cell("qwen3-8b", "long_500k", multi_pod,
                          out_dir=tmp_path / "torch", verbose=False,
                          sparse=sparse, quant=quant)
    assert got == want
    names = [sorted(p.name for p in (tmp_path / d).iterdir())
             for d in ("jax", "torch")]
    assert names[0] == names[1] and len(names[0]) == 1
    assert (tmp_path / "jax" / names[0][0]).read_text() == \
        (tmp_path / "torch" / names[0][0]).read_text()


def test_cli_flags_are_the_reference_flags_plus_device_and_rank():
    import argparse
    import inspect
    src = inspect.getsource(jax_dryrun.main)
    ref_flags = {ln.split('"')[1] for ln in src.splitlines()
                 if "ap.add_argument(" in ln}
    parser_flags = set()
    real = argparse.ArgumentParser.add_argument

    def spy(self, *names, **kw):
        parser_flags.add(names[0])
        return real(self, *names, **kw)
    argparse.ArgumentParser.add_argument = spy
    try:
        args = dryrun.parse_args([])
    finally:
        argparse.ArgumentParser.add_argument = real
    assert parser_flags - {"-h"} == ref_flags | {"--device", "--rank"}
    assert args.device == "cuda" and args.rank == 0
    assert args.out == "results/dryrun"


# --------------------------------------------------------------------------
# 7. the weight kernels' wrappers on fake CUDA tensors
# --------------------------------------------------------------------------

def _fail_build(*a, **k):
    raise AssertionError("a fake tensor built or loaded the kernels")


@pytest.mark.parametrize("M", [8, 512])
@pytest.mark.parametrize("kernel", ["fused_sparse_linear",
                                    "fused_sparse_linear_int8", "nm_spmm",
                                    "outlier_spmm"])
def test_wrappers_record_a_launch_on_fake_cuda(kernel, M, monkeypatch):
    monkeypatch.setattr(build, "library", _fail_build)
    monkeypatch.setattr(build, "build", _fail_build)
    K, N, n, m, o_n = 4096, 14336, 8, 16, 16
    counters = (fsl.launches, fsl.launches_int8, nms.launches,
                osp.launches)
    with FakeTensorMode(), recording_fake_launches() as rec:
        x = torch.empty(M, K, dtype=torch.bfloat16, device="cuda")
        int8 = kernel.endswith("_int8")
        vals = torch.empty(N, K * n // m, device="cuda",
                           dtype=torch.int8 if int8 else torch.bfloat16)
        meta = torch.empty(N, K // m, dtype=torch.int32, device="cuda")
        ov = torch.empty(N, K // 256, o_n, dtype=torch.bfloat16,
                         device="cuda")
        om = torch.empty(N, K // 256, o_n // 4, dtype=torch.int32,
                         device="cuda")
        scale = torch.empty(N, dtype=torch.float32, device="cuda") \
            if int8 else None
        if kernel.startswith("fused"):
            y = fsl.fused_sparse_linear(x, vals, meta, ov, om, n=n, m=m,
                                        o_n=o_n, scale=scale)
            want_plan = fsl.plan(M, K, N, n, m, o_n, 132)
            stored = K * n // m + K // 256 * o_n
            operands = (vals, meta, ov, om, scale)
        elif kernel == "nm_spmm":
            y = nms.nm_spmm(x, vals, meta, n=n, m=m)
            want_plan = fsl.plan(M, K, N, n, m, 0, 132)
            stored = K * n // m
            operands = (vals, meta)
        else:
            y = osp.outlier_spmm(x, ov, om, n=o_n)
            want_plan = osp.plan(M, K, N, o_n, 132)
            stored = K // 256 * o_n
            operands = (ov, om)
        assert type(y).__name__ == "FakeTensor"
        assert (tuple(y.shape), y.dtype, y.device.type) == \
            ((M, N), torch.bfloat16, "cuda")
        nbytes = (2 * M * K + 2 * M * N
                  + sum(t.numel() * t.element_size() for t in operands
                        if t is not None))
    assert H100_SM_COUNT == 132
    assert [(r.kernel, r.plan, r.M, r.K, r.N, r.flops, r.bytes)
            for r in rec] == [(kernel, want_plan, M, K, N,
                               2 * M * N * stored, nbytes)]
    assert (fsl.launches, fsl.launches_int8, nms.launches,
            osp.launches) == counters


def test_plain_version_shape_on_the_cpu_matches_the_fake_output():
    """The fake output's shape and dtype are the plain version's."""
    g = torch.Generator().manual_seed(0)
    K, N = 512, 64
    x = torch.randn(8, K, generator=g).to(torch.bfloat16)
    w = torch.randn(N, K, generator=g).to(torch.bfloat16)
    from repro_torch.models.sparse_serving import sparse_apply, \
        to_sparse_weight
    sw = to_sparse_weight(w, SparsifyConfig(scorer="magnitude",
                                            use_smoothquant=False))
    y = sparse_apply(sw, x)
    with FakeTensorMode():
        fx = torch.empty(8, K, dtype=torch.bfloat16, device="cuda")
        fsw = sw.map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device="cuda"))
        fy = sparse_apply(fsw, fx)
    assert (tuple(fy.shape), fy.dtype) == (tuple(y.shape), y.dtype)
