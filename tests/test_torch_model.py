"""The port's ``unified_step`` against the JAX package's at f32: logits and
the updated KV arenas, dense and 8:16+16:256 sparse, for the three serving
shapes — one-shot prefill at cursor 0, a mid-prompt chunk, and the S=1
fused decode over every lane (one of them inactive).

The model is the ``tests/test_serving.py`` shape (d_model 128, d_ff 256)
with 2 KV heads for 4 q heads (GQA).  Sparse, wq..w_up (in-dim 128) lose
their outliers and take the ``nm_spmm`` branch; w_down (in-dim 256) keeps
them and takes the fused one.  Tolerance: atol 1e-4 (f32, summation order
only)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.serving.cache_pool import SlotPoolView as JaxSlotPoolView  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.kernels import fused_sparse_linear, nm_spmm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.sparse_serving import SparseWeight  # noqa: E402
from repro_torch.serving.cache_pool import SlotPoolView  # noqa: E402

SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=256, vocab=512)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-parity", remat=False,
                           dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-parity", dtype=torch.float32, **SHAPE)
N_SLOTS, MAX_LEN = 4, 32
ATOL = 1e-4


@pytest.fixture(scope="module")
def param_pairs():
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    sparse, _ = jax_sparsify(dense, scfg)
    return {"dense": (dense, from_jax_params(dense, device="cpu")),
            "sparse": (sparse, from_jax_params(sparse, device="cpu"))}


# (rows or None for the fused decode, cursor, n_new, S)
CASES = {
    # lanes 0,1 start prompts in slots 1 and 3; lane 2 is batch padding
    "oneshot": ([1, 3, N_SLOTS], [0, 0, 0], [12, 9, 0], 16),
    # two rows continue their prompts at cursor 8, one with a short chunk
    "chunk": ([0, 2], [8, 8], [8, 5], 8),
    # fused decode over every slot; slot 2 is free (its write is garbage)
    "decode": (None, [5, 9, 0, 13], [1, 1, 1, 1], 1),
}


def _arenas(seed):
    """Random arenas standing in for earlier writes and stale tokens."""
    shape = (JCFG.n_layers, N_SLOTS, MAX_LEN, JCFG.n_kv_heads, JCFG.hd)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("which", ["dense", "sparse"])
def test_unified_step_matches_jax(which, case, param_pairs):
    jparams, tparams = param_pairs[which]
    rows, cursor, n_new, S = CASES[case]
    B = len(cursor)
    tokens = np.random.default_rng(7).integers(0, CFG.vocab, (B, S))
    k0, v0 = _arenas(3)

    jview = JaxSlotPoolView(
        k=jnp.asarray(k0), v=jnp.asarray(v0),
        rows=None if rows is None else jnp.asarray(rows, jnp.int32),
        cursor=jnp.asarray(cursor, jnp.int32),
        n_new=jnp.asarray(n_new, jnp.int32))
    jlogits, (jk, jv) = jax_tfm.unified_step(
        jparams, jview, {"tokens": jnp.asarray(tokens, jnp.int32)}, JCFG)

    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    view = SlotPoolView.build(tk, tv, rows, cursor, n_new, S)
    counts = (nm_spmm.launches, fused_sparse_linear.launches)
    logits, (k, v) = tfm.unified_step(tparams, view,
                                      {"tokens": torch.from_numpy(tokens)},
                                      CFG)
    assert k is tk and v is tv                  # arenas updated in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    # CPU tensors run the plain versions: no kernel launches
    assert (nm_spmm.launches, fused_sparse_linear.launches) == counts


def test_sparse_params_take_both_kernel_branches(param_pairs):
    _, tparams = param_pairs["sparse"]
    lp = tparams["layers"][0]
    assert all(isinstance(lp[n], SparseWeight)
               for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    assert all(lp[n].o_values is None
               for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up"))
    assert lp["w_down"].o_values is not None
    assert isinstance(tparams["lm_head"], torch.Tensor)


def test_init_params_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(CFG, torch.Generator())
