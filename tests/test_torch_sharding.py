"""The port's sharding rules (``repro_torch/parallel/sharding.py``) and the
serving placement's specs (``repro_torch/serving/placement.py``) against
the JAX package's, with no processes: the port's rules are functions of
the mesh's axis sizes, JAX's run on virtual meshes built as the
reference's ``tests/test_sharding.py`` builds its 4x4 one (spec resolution
needs only axis sizes).  Tolerance: the specs are equal, entry for entry,
after JAX's normalisation (a one-name tuple is the name).

Meshes: 4x4 (the reference's), 1x8 and 2x4.  Grids: ``param_spec`` over
paths and shapes that include the reference's cases, stacked [L, ...]
(JAX's layout) and per layer (the port's: the JAX spec without its layer
entry); ``sparse_weight_specs`` serving and not, on JAX's containers of
``ShapeDtypeStruct``s and the port's of meta tensors; ``batch_spec``;
``cache_spec``; ``ServingPlacement``'s ``_dense_spec``, ``state_spec`` and
``kv``/``kv_scale`` axes (on 1x8, and its refusal of 4x4 and 2x4); and
every leaf of the llama-paper smoke model, dense and 8:16 + 16:256, through
``param_shardings`` and the placement's.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import itertools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models.sparse_serving import SparseWeight as JaxSparseWeight  # noqa: E402,E501
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.serving import ServingPlacement as JaxPlacement  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.models.sparse_serving import SparseWeight  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serving import ServingPlacement  # noqa: E402

MESHES = {"4x4": (4, 4), "1x8": (1, 8), "2x4": (2, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so several test workers on one machine do not
    oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(name):
    """(JAX virtual mesh, the port's axis sizes) of one mesh."""
    d, m = MESHES[name]
    devs = np.array(jax.devices() * (d * m))[:d * m].reshape(d, m)
    return (jax.sharding.Mesh(devs, ("data", "model")),
            {"data": d, "model": m})


def _t(spec):
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(spec)


# --------------------------------------------------------------------------
# param_spec
# --------------------------------------------------------------------------

REFERENCE_PARAM_CASES = [
    ("layers/wq", (24, 2048, 4096)), ("layers/wo", (24, 4096, 2048)),
    ("layers/attn_norm", (24, 4096)), ("embed", (32000, 4096)),
    ("embed", (51865, 1024)), ("layers/moe/we_gate", (48, 128, 5120, 8192)),
    ("layers/moe/we_gate", (48, 6, 5120, 8192)),
    ("layers/moe/router", (48, 128, 5120))]
NAMES_3D = ["layers/wq", "layers/wk", "layers/wv", "layers/wo",
            "layers/w_gate", "layers/w_up", "layers/w_down",
            "layers/moe/ws_gate", "layers/moe/ws_down", "mamba/in_proj",
            "mamba/out_proj", "dec/c_wq", "dec/c_wo", "layers/w_slstm",
            "layers/nm_values", "layers/nm_meta", "layers/moe/router",
            "layers/unnamed"]
NAMES_2D = ["embed", "lm_head", "layers/attn_norm", "layers/q_norm",
            "mamba/A_log", "mamba/dt_bias", "layers/v_scale", "final_norm"]
DIMS = (6, 48, 64, 256, 1024, 51865)


def _param_cases():
    cases = list(REFERENCE_PARAM_CASES)
    for name in NAMES_3D:
        cases += [(name, (4, a, b)) for a, b in itertools.product(DIMS[:5],
                                                                  DIMS[1:5])]
    for name in NAMES_2D:
        cases += [(name, (4, a)) for a in DIMS] + [
            (name, (a, 256)) for a in DIMS]
    for name in ("layers/o_values", "layers/o_meta"):
        cases += [(name, (4, a, b, 16)) for a in (6, 64) for b in (1, 4, 8)]
    for name in ("layers/moe/we_gate", "layers/moe/we_up",
                 "layers/moe/we_down"):
        cases += [(name, (4, e, 256, 512)) for e in (6, 8, 16)]
    return cases


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_spec_grid(mesh_name):
    """Stacked paths and shapes as JAX sees them; the port's per-layer
    path (``layers/3/wq``) and shape give JAX's spec without its layer
    entry."""
    jmesh, sizes = _meshes(mesh_name)
    cases = _param_cases()
    for name, shape in cases:
        want = _t(jsh.param_spec(jmesh, name, shape))
        assert tsh.param_spec(sizes, name, shape) == want, (name, shape)
        top, _, rest = name.partition("/")
        if rest:
            port_path = f"{top}/3/{rest}"
            assert tsh.param_spec(sizes, port_path, shape[1:]) == want[1:], \
                (port_path, shape)
    assert len(cases) > 300


# --------------------------------------------------------------------------
# sparse_weight_specs
# --------------------------------------------------------------------------

def _jax_sw(out, in_dim, m=16, n=8, o_n=0, quantized=False, L=None):
    """The reference test's container of ShapeDtypeStructs."""
    lead = () if L is None else (L,)
    sds = jax.ShapeDtypeStruct
    vdt = jnp.int8 if quantized else jnp.bfloat16
    return JaxSparseWeight(
        nm_values=sds((*lead, out, in_dim * n // m), vdt),
        nm_meta=sds((*lead, out, in_dim // m), jnp.int32),
        o_values=None if o_n == 0 else
        sds((*lead, out, in_dim // 256, o_n), jnp.bfloat16),
        o_meta=None if o_n == 0 else
        sds((*lead, out, in_dim // 256, o_n // 4), jnp.int32),
        v_scale=None if not quantized else sds((*lead, out), jnp.float32),
        n=n, m=m, o_n=o_n, in_dim=in_dim)


def _port_sw(out, in_dim, m=16, n=8, o_n=0, quantized=False, L=None):
    """The port's container of the same shapes, on the meta device."""
    lead = () if L is None else (L,)

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    return SparseWeight(
        nm_values=meta(*lead, out, in_dim * n // m,
                       dtype=torch.int8 if quantized else torch.bfloat16),
        nm_meta=meta(*lead, out, in_dim // m),
        o_values=None if o_n == 0 else meta(*lead, out, in_dim // 256, o_n,
                                            dtype=torch.bfloat16),
        o_meta=None if o_n == 0 else meta(*lead, out, in_dim // 256,
                                          o_n // 4),
        v_scale=None if not quantized else meta(*lead, out,
                                                dtype=torch.float32),
        n=n, m=m, o_n=o_n, in_dim=in_dim)


FIELDS = ("nm_values", "nm_meta", "o_values", "o_meta", "v_scale")
REFERENCE_SW_CASES = [dict(out=64, in_dim=256), dict(out=64, in_dim=48),
                      dict(out=4, in_dim=512),
                      dict(out=4, in_dim=512, o_n=16),
                      dict(out=4, in_dim=48),
                      dict(out=64, in_dim=1024, o_n=16, quantized=True, L=2),
                      dict(out=64, in_dim=256, o_n=16)]


def _sw_cases():
    cases = list(REFERENCE_SW_CASES)
    for out, in_dim, o_n, q, L in itertools.product(
            (4, 6, 64, 512), (48, 256, 512, 1024, 4096), (0, 16),
            (False, True), (None, 2)):
        if o_n and in_dim % 256:
            continue
        cases.append(dict(out=out, in_dim=in_dim, o_n=o_n, quantized=q, L=L))
    return cases


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sparse_weight_specs_grid(mesh_name, serving):
    """Every buffer's spec, co-sharded, as JAX decides it; a stacked
    container's per-layer slice (the port's leaf) gets JAX's spec without
    its layer entry."""
    jmesh, sizes = _meshes(mesh_name)
    for case in _sw_cases():
        jsp = jsh.sparse_weight_specs(jmesh, _jax_sw(**case), serving=serving)
        tsp = tsh.sparse_weight_specs(sizes, _port_sw(**case),
                                      serving=serving)
        flat = {k: v for k, v in case.items() if k != "L"}
        per_layer = tsh.sparse_weight_specs(sizes, _port_sw(**flat),
                                            serving=serving)
        for f in FIELDS:
            want = getattr(jsp, f)
            got = getattr(tsp, f)
            assert (got is None) == (want is None), (case, f)
            if want is None:
                continue
            assert got == _t(want), (case, f)
            if case.get("L"):
                assert getattr(per_layer, f) == _t(want)[1:], (case, f)
        if serving:                          # contractions never split
            assert tsp.nm_values[-1] is None


# --------------------------------------------------------------------------
# batch_spec / cache_spec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_spec_grid(mesh_name):
    jmesh, sizes = _meshes(mesh_name)
    batch_shapes = [(256, 4096), (3, 256, 4096), (1, 524288), (6, 48),
                    (3, 6, 48), (8, 64, 256), (5,), (3, 2, 16)]
    for shape, seq in itertools.product(batch_shapes, (False, True)):
        assert tsh.batch_spec(sizes, shape, seq) == \
            _t(jsh.batch_spec(jmesh, shape, seq)), (shape, seq)
    cache_cases = [("k", (24, 128, 32768, 16, 64)),
                   ("k", (24, 128, 32768, 2, 64)), ("pos", ()),
                   ("pos", (8,)), ("v", (4, 6, 48, 8, 16)),
                   ("kv/k", (8, 64, 4, 16)), ("kv/v", (8, 64, 2, 16)),
                   ("state", (8, 4, 16, 16)), ("state", (6, 6, 16, 16)),
                   ("c", (8, 4, 16)), ("n", (8, 6)), ("x", (8,)),
                   ("scalar", ())]
    for (path, shape), seq in itertools.product(cache_cases, (False, True)):
        assert tsh.cache_spec(sizes, path, shape, seq) == \
            _t(jsh.cache_spec(jmesh, path, shape, seq)), (path, shape, seq)


def test_fsdp_axes_and_axis_size():
    for name in MESHES:
        jmesh, sizes = _meshes(name)
        assert tsh.fsdp_axes(sizes) == jsh.fsdp_axes(jmesh)
        for axes in (None, "data", "model", ("data",), ("model", "data")):
            assert tsh.axis_size(sizes, axes) == jsh.axis_size(jmesh, axes)
    pod = {"pod": 2, "data": 4, "model": 4}
    assert tsh.fsdp_axes(pod) == ("pod", "data")
    assert tsh.param_spec(pod, "embed", (32000, 4096)) == \
        ("model", ("pod", "data"))


# --------------------------------------------------------------------------
# ServingPlacement specs
# --------------------------------------------------------------------------

def _placement_cfgs():
    base = configs.get_smoke("llama-paper")
    jbase = jax_configs.get_smoke("llama-paper")
    for kv in (8, 4, 2, 1):
        yield (dataclasses.replace(jbase, n_heads=8, n_kv_heads=kv),
               dataclasses.replace(base, n_heads=8, n_kv_heads=kv))


def test_placement_kv_state_and_dense_specs():
    """On 1x8: the KV arenas' and scales' head axis (split when the KV
    heads divide 8, else replicated), ``state_spec`` over a shape grid and
    ``_dense_spec`` over the param grid's names and shapes."""
    jmesh, sizes = _meshes("1x8")
    for jcfg, cfg in _placement_cfgs():
        jpl, pl = JaxPlacement(jmesh, jcfg), ServingPlacement(sizes, cfg)
        assert pl.kv == _t(jpl.kv.spec), cfg.n_kv_heads
        assert pl.kv_scale == _t(jpl.kv_scale.spec), cfg.n_kv_heads
        assert pl.replicated == _t(jpl.replicated.spec) == ()
        assert pl.describe() == jpl.describe()
    jpl = JaxPlacement(jmesh, jax_configs.get_smoke("llama-paper"))
    pl = ServingPlacement(sizes, configs.get_smoke("llama-paper"))
    for shape in itertools.product((8,), (4, 8, 16), (6, 16), (8, 48)):
        assert pl.state_spec(shape) == _t(jpl.state_spec(shape)), shape
        assert pl.state_spec(shape[:3]) == _t(jpl.state_spec(shape[:3]))
        assert pl.state_spec(shape[:2]) == _t(jpl.state_spec(shape[:2]))
    for name, shape in _param_cases():
        want = _t(jpl._dense_spec(name, shape))
        assert pl._dense_spec(name, shape) == want, (name, shape)
        top, _, rest = name.partition("/")
        if rest and len(shape) > 2:
            assert pl._dense_spec(f"{top}/3/{rest}", shape[1:]) == want[1:]


@pytest.mark.parametrize("mesh_name", ["4x4", "2x4"])
def test_placement_refuses_data_parallel_mesh(mesh_name):
    jmesh, sizes = _meshes(mesh_name)
    jcfg, cfg = next(_placement_cfgs())
    with pytest.raises(ValueError, match="size 1"):
        JaxPlacement(jmesh, jcfg)
    with pytest.raises(ValueError, match="size 1"):
        ServingPlacement(sizes, cfg)


def test_placement_validates_mesh_and_cfg():
    """The reference's ``test_placement_validates_mesh_and_cfg``."""
    with pytest.raises(ValueError, match="cfg"):
        ServingPlacement({"data": 1, "model": 1})
    with pytest.raises(ValueError, match="model"):
        ServingPlacement({"replica": 1}, configs.get_smoke("llama-paper"))
    pl = ServingPlacement()
    assert not pl.active and pl.kv is None and pl.replicated is None
    x = torch.ones(3)
    assert pl.place_kv(x) is x and pl.place_replicated(x) is x
    tree = {"a": x}
    assert pl.place_params(tree) is tree
    assert pl.param_shardings(tree) is None
    assert pl.describe() == {"devices": 1, "mesh": None}


# --------------------------------------------------------------------------
# every leaf of the llama-paper smoke model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_params():
    jcfg = jax_configs.get_smoke("llama-paper")
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    sparse, _ = jax_sparsify(dense, JaxSparsifyConfig(
        weight_pattern="8:16", outlier_pattern="16:256", scorer="magnitude",
        use_smoothquant=False))
    return {k: (v, from_jax_params(v, device="cpu"))
            for k, v in (("dense", dense), ("sparse", sparse))}


def _jax_named(shardings):
    """{JAX path: spec tuple} of a NamedSharding tree."""
    return {name: _t(s.spec) for name, s in jsh.tree_paths(shardings)}


def _port_named(specs):
    """{JAX path: [(stacked, spec tuple)] of each port leaf} of a port spec
    tree: the per-layer paths of one JAX leaf gathered under its JAX
    path."""
    out = {}
    for name, spec in tsh.tree_paths(specs):
        jname, stacked = tsh.jax_path(name)
        out.setdefault(jname, []).append((stacked, spec))
    return out


@pytest.mark.parametrize("which", ["dense", "sparse"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_smoke_model_param_shardings(smoke_params, which, mesh_name):
    """``param_shardings`` over every leaf, and on 1x8 the serving
    placement's: each port leaf's spec is its JAX leaf's (without the
    layer entry for per-layer leaves), and both trees name the same
    leaves."""
    jmesh, sizes = _meshes(mesh_name)
    jparams, tparams = smoke_params[which]
    trees = [(jsh.param_shardings(jmesh, jparams),
              tsh.param_shardings(sizes, tparams))]
    if mesh_name == "1x8":
        jcfg = jax_configs.get_smoke("llama-paper")
        cfg = configs.get_smoke("llama-paper")
        trees.append((JaxPlacement(jmesh, jcfg).param_shardings(jparams),
                      ServingPlacement(sizes, cfg).param_shardings(tparams)))
    for jtree, ttree in trees:
        want = _jax_named(jtree)
        got = _port_named(ttree)
        assert [n for n, _ in tsh.tree_paths(ttree)] == \
            [n for n, _ in tsh.tree_paths(tparams)]
        assert set(got) == set(want)
        for name, per_layer in got.items():
            for stacked, spec in per_layer:
                assert spec == (want[name][1:] if stacked else want[name]), \
                    name
        if which == "sparse":
            assert any(".nm_values" in n for n in want)
