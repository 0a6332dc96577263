"""The port's examples (``examples/torch/``) on the CPU, against the JAX
package's functions.

- ``quickstart.py --device cpu``: its N:M invariant, salient fraction and
  deployed bytes equal the reference pipeline's (``repro.core``) on the
  same numpy inputs, exactly; its kernel line runs the plain version
  (error 0), and its output error equals the reference's at rtol 1e-4
  (f32 matmuls summed in another order).
- ``serve_sparse.py --device cpu`` serves every prompt to the end.
- ``sparsify_e2e.py`` at ``--steps 20 --ebft-steps 2 --layers 1
  --d-model 64``, started from the JAX init (``interchange``): its dense
  perplexity equals the reference harness's at rtol ``PPL_RTOL`` (20
  AdamW steps at f32 in two frameworks, summed in other orders), and the
  pruned rungs at ``PRUNED_PPL_RTOL`` (the trained weights' last places
  move a few near-tied pruning choices).  At these arguments the closing assertion
  ("pipeline should beat magnitude") fails in the reference's own
  example (EBFT with 16:256 outliers zeroes the salient weights in both
  packages, ROADMAP C, and 2 steps do not recover them): the port's
  check raises as the reference's does.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import re  # noqa: E402
import runpy  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import ActStats as JaxActStats  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.core import sparsify_linear as jax_sparsify_linear  # noqa: E402
from repro.core import dense_effective_weight as jax_dense_effective  # noqa: E402,E501
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch"
E2E_ARGS = ["--steps", "20", "--ebft-steps", "2", "--layers", "1",
            "--d-model", "64"]
PPL_RTOL = 1e-3
# the pruned rungs: the two frameworks' trained weights differ in the last
# places, which moves a few near-tied pruning choices
PRUNED_PPL_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so several test workers on one machine do not
    oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_equals_the_reference_pipeline():
    qs = _example("quickstart")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = qs.main(["--device", "cpu"])
    text = out.getvalue()
    assert "fused kernel error" in text and "cpu" in text

    data = qs.inputs(0)
    W = jnp.asarray(data["W"])
    stats = JaxActStats.init(2048).update(jnp.asarray(data["x_calib"]))
    cfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                            scorer="ria", use_smoothquant=True,
                            use_variance_correction=True)
    sl = jax_sparsify_linear(W, stats, cfg)
    comp = (sl.nm.values.size * 2 + sl.nm.packed_metadata().size * 4
            + sl.outliers.values.size * 2 + sl.outliers.indices.size)
    assert got["nm_invariant"] is bool(
        (sl.nm_mask.reshape(-1, 16).sum(-1) == 8).all()) is True
    assert got["salient_fraction"] == float(sl.salient_mask.mean())
    assert got["dense_bytes"] == W.size * 2
    assert got["deployed_bytes"] == comp
    assert got["kernel_err"] == 0.0 and got["kernel_tol"] > 0
    x = jnp.asarray(data["x"])
    y_dense = x @ jax_dense_effective(W, sl, cfg).T
    err = jnp.linalg.norm(y_dense - x @ W.T) / jnp.linalg.norm(x @ W.T)
    np.testing.assert_allclose(got["rel_output_error"], float(err),
                               rtol=1e-4)


def test_serve_sparse_completes_on_the_cpu():
    ss = _example("serve_sparse")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ss.main(["--arch", "llama-paper", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4"])
    text = out.getvalue()
    assert "sparse deploy" in text and "engine[slot]: 2 requests" in text
    assert re.search(r"^sample: \[", text, re.M)


def _reference_ladder() -> dict:
    """The reference's ``examples/sparsify_e2e.py`` at ``E2E_ARGS``: its
    printed summary, and whether its closing assertion held."""
    argv = sys.argv
    sys.argv = ["sparsify_e2e.py"] + E2E_ARGS
    sys.path.insert(0, str(ROOT))
    held = True
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            try:
                runpy.run_path(str(ROOT / "examples" / "sparsify_e2e.py"),
                               run_name="__main__")
            except AssertionError:
                held = False
    finally:
        sys.argv = argv
        sys.path.remove(str(ROOT))
    lines = out.getvalue().split("== summary")[1].splitlines()[1:]
    ladder = {" ".join(ln.split()[:-1]): float(ln.split()[-1])
              for ln in lines if ln.strip()}
    return {"ladder": ladder, "held": held}


def test_sparsify_e2e_ladder_equals_the_reference():
    e2e = _example("sparsify_e2e")
    args = e2e.parse_args(E2E_ARGS + ["--device", "cpu"])
    jcfg = dataclasses.replace(
        jax_configs.get_smoke("llama-paper"), name="e2e", n_layers=args.layers, d_model=args.d_model,
        d_ff=args.d_ff, vocab=args.vocab,
        n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(4, args.d_model // 64),
        head_dim=64 if args.d_model >= 256 else args.d_model // 4,
        remat=False)
    init = from_jax_params(jax_zoo.get_model(jcfg).init(
        jax.random.PRNGKey(0)), "cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        got = e2e.run(args, params=init)
    ref = _reference_ladder()
    want = ref["ladder"]
    assert set(want) == {"dense", "magnitude", "RIA", "RIA+SQ+VC",
                         "RIA+SQ+VC+EBFT"}
    # the reference prints 3 decimals
    np.testing.assert_allclose(got["dense"], want["dense"], rtol=PPL_RTOL,
                               atol=5e-4)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=PRUNED_PPL_RTOL,
                                   err_msg=k)
    beats = got["RIA+SQ+VC+EBFT"] <= got["magnitude"]
    assert beats == ref["held"] is False
    with pytest.raises(AssertionError, match="should beat magnitude"), \
            contextlib.redirect_stdout(io.StringIO()):
        e2e.ladder_check(got)
