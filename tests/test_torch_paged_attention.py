"""The port's ``paged_attention`` on the CPU (its plain version) against the
JAX package's ``paged_attention_ref`` and ``paged_attention_pallas`` run in
interpret mode, untiled and head-tiled (``head_tile`` 1 and 2), on the same
numpy inputs.

The tables share blocks between two lanes (a prefix-cache hit), pad with
the trash block, and put cursors on and off block edges; one lane is a
padding lane (cursor 0, all-trash table).  GQA with n_rep 2.  Tolerance at
f32: atol/rtol 1e-5 (the same masked softmax, only the summation order
differs: the reference's full softmax against the kernel's online one).
At bf16: both compute in f32 from the same bf16 inputs and round once to
bf16 at the end, so they may differ by one bf16 ulp of an output, at most
2**-7 of the largest output magnitude."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving.paged.paged_attention import \
    paged_attention_pallas  # noqa: E402
from repro.serving.paged.paged_attention import \
    paged_attention_ref  # noqa: E402
from repro_torch.interchange import to_torch  # noqa: E402
from repro_torch.serving.paged import paged_attention as pa  # noqa: E402

H, KV, HD, BS, N_BLOCKS = 8, 4, 16, 4, 12
TRASH = 0
# lane 0 at a block edge, lane 1 off one and sharing lane 0's first two
# blocks, lane 2 a padding lane, lane 3 mid-block in a permuted table
TABLES = np.array([[3, 7, 1, 9, 0],
                   [3, 7, 5, 0, 0],
                   [0, 0, 0, 0, 0],
                   [2, 11, 6, 8, 10]], np.int32)
CURSORS = np.array([8, 6, 0, 13], np.int32)
ATOL = RTOL = 1e-5


def _inputs(S, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    B = len(CURSORS)
    q = rng.standard_normal((B, S, H, HD)).astype(dtype)
    k = rng.standard_normal((N_BLOCKS, BS, KV, HD)).astype(dtype)
    v = rng.standard_normal((N_BLOCKS, BS, KV, HD)).astype(dtype)
    return q, k, v


def _port(q, k, v, window, dtype=torch.float32):
    out = pa.paged_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.from_numpy(TABLES),
        torch.from_numpy(CURSORS), window=window)
    assert pa.launches == 0                     # CPU tensors: plain version
    return out


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("S", [1, 5])
def test_matches_paged_attention_ref(S, window):
    q, k, v = _inputs(S, seed=S)
    ref = paged_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(TABLES), jnp.asarray(CURSORS),
                              window=window)
    out = _port(q, k, v, window)
    assert out.shape == (len(CURSORS), S, H, HD)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("head_tile", [None, 1, 2])
@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("S", [1, 5])
def test_matches_paged_attention_pallas(S, window, head_tile):
    q, k, v = _inputs(S, seed=10 + S)
    ref = paged_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(TABLES),
                                 jnp.asarray(CURSORS), window=window,
                                 interpret=True, head_tile=head_tile)
    out = _port(q, k, v, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_bf16_inputs_within_one_ulp():
    q, k, v = _inputs(5, seed=3)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(paged_attention_ref(
        qb, kb, vb, jnp.asarray(TABLES), jnp.asarray(CURSORS), window=10)
    ).astype(np.float32)
    out = pa.paged_attention(
        to_torch(np.asarray(qb)), to_torch(np.asarray(kb)),
        to_torch(np.asarray(vb)), torch.from_numpy(TABLES),
        torch.from_numpy(CURSORS), window=10)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2.0 ** -7 * np.abs(ref).max(), err


def test_shared_and_trash_blocks_read_through_the_table():
    """Lanes 0 and 1 share physical blocks 3 and 7: their queries over
    those positions see the same keys; changing an unreferenced block
    changes nothing, changing a shared one changes both lanes."""
    q, k, v = _inputs(1, seed=4)
    q[1] = q[0]
    base = _port(q, k, v, None).numpy()
    k2 = k.copy()
    k2[4] += 1.0                                  # no table holds block 4
    np.testing.assert_array_equal(_port(q, k2, v, None).numpy(), base)
    v3 = v.copy()
    v3[7] += 1.0                                  # shared by lanes 0 and 1
    moved = np.abs(_port(q, k, v3, None).numpy() - base).max(axis=(1, 2, 3))
    assert moved[0] > 0 and moved[1] > 0 and moved[3] == 0
    assert np.isfinite(base[2]).all()             # padding lane
