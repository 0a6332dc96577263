"""The int8-arena half of ``test_torch_paged_attention_prefill.py``'s
``test_model_matches_paged_attention_ref``: the prefill-chunk body's CPU
model against the JAX package's ``paged_attention_ref`` on int8 arenas
with f32 scales, with the same cases, seeds and tolerances (see that
file's docstring).  It lives in a file of its own so that the grid's two
halves can run on two test workers.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serving.paged.paged_attention import \
    paged_attention_ref  # noqa: E402
from test_torch_paged_attention_prefill import (ATOL, CASES,  # noqa: E402
                                                RTOL, _inputs, _jax, _model,
                                                _v_max)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module's many small CPU ops run, so
    that several test workers on one machine do not oversubscribe its
    cores (it changes no case and no tolerance); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("int8", [True], ids=["int8"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 24])
def test_model_matches_paged_attention_ref(bs, hd, n_rep, window, int8):
    """The model against ``paged_attention_ref``: exact P at the f32
    tolerance, bf16 P within 2**-8 of the largest |v| more; lane 0's table
    holds out-of-range ids and trash past its visible end."""
    S, cursors = CASES[bs]
    KV = 2
    args = _inputs(len(cursors), S, KV * n_rep, KV, hd, bs, cursors,
                   seed=bs * 100 + hd + n_rep, int8=int8, wild=True)
    q, k, v, tables, cur, ks, vs = args
    ref = _jax(paged_attention_ref, *args, window)
    exact = _model(*args, window, round_p=False)
    np.testing.assert_allclose(exact, ref, atol=ATOL, rtol=RTOL)
    got = _model(*args, window)
    assert np.abs(got - ref).max() <= 2.0 ** -8 * _v_max(v, vs) + ATOL + \
        RTOL * np.abs(ref).max()
