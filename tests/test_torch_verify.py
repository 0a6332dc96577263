"""Unit parity of the speculative slice's pieces against the JAX package:
``verify_draft`` (greedy rows exactly: ``n_accept``, tokens, logprobs at
1e-6), ``verify_bucket``, ``NGramProposer``, ``SpeculativeConfig``
validation, ``spec_verify_reserve``, and ``densify``/``densify_params``
bit for bit on bf16, int8 and f32 containers.  The stochastic
leave-one-in rule is held to the target distribution (the reference's
threefry keys cannot be reproduced in torch) and to its own determinism.
And ``chip_smoke.py``'s near-tie gate: a planted wrong token fails it."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import pathlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import SparsifyConfig as JaxSparsifyConfig  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models.sparse_serving import densify_params as jax_densify  # noqa: E402
from repro.models.sparse_serving import \
    sparsify_for_serving as jax_sparsify  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import SpeculativeConfig as JaxSpecConfig  # noqa: E402
from repro.serving import Status as JaxStatus  # noqa: E402
from repro.serving import spec_verify_reserve as jax_reserve  # noqa: E402
from repro.serving import verify_bucket as jax_verify_bucket  # noqa: E402
from repro.serving.sampling import verify_draft as jax_verify  # noqa: E402
from repro.serving.speculative import NGramProposer as JaxNGram  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.sparse_serving import (SparseWeight,  # noqa: E402
                                               densify, densify_params)
from repro_torch.serving import (Request, SamplingParams,  # noqa: E402
                                 SpeculativeConfig, Status,
                                 spec_verify_reserve)
from repro_torch.serving.sampling import (keyed_uniforms,  # noqa: E402
                                          verify_draft)
from repro_torch.serving.speculative import (NGramProposer,  # noqa: E402
                                             verify_bucket)

ROOT = pathlib.Path(__file__).resolve().parents[1]



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread each, so several test workers on
    one machine do not oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _jax_verify(logits, draft, n_draft, temps, top_ks, seeds, steps):
    out = jax_verify(jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
                     jnp.asarray(n_draft, jnp.int32),
                     jnp.asarray(temps, jnp.float32),
                     jnp.asarray(top_ks, jnp.int32),
                     jnp.asarray(seeds, jnp.int32),
                     jnp.asarray(steps, jnp.int32))
    return tuple(np.asarray(o) for o in out)


def _greedy_case(seed, B=6, S=5, V=64):
    """Random logits whose argmax the drafts follow for a random number of
    leading positions, then leave; some rows carry exact ties at the max
    (the first index wins in both packages)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, S, V)).astype(np.float32)
    for b in range(0, B, 2):                          # ties at the top
        j = rng.integers(S)
        top = logits[b, j].argmax()
        other = (top + 1 + rng.integers(V - 1)) % V
        logits[b, j, other] = logits[b, j, top]
    arg = logits.argmax(-1)
    n_draft = rng.integers(0, S, B)
    draft = np.zeros((B, S), np.int64)
    for b in range(B):
        keep = rng.integers(0, n_draft[b] + 1)
        draft[b, :n_draft[b]] = rng.integers(0, V, n_draft[b])
        draft[b, :keep] = arg[b, :keep]
    return logits, draft, n_draft


@pytest.mark.parametrize("seed", range(6))
def test_greedy_verify_matches_jax(seed):
    logits, draft, n_draft = _greedy_case(seed)
    B = len(n_draft)
    zeros = np.zeros(B, np.int64)
    args = (draft, n_draft, np.zeros(B, np.float32), zeros, zeros + seed,
            zeros + 3)
    want = _jax_verify(logits, *args)
    got = verify_draft(torch.as_tensor(logits), *args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)


def test_greedy_verify_accept_prefix_and_bonus():
    """The reference's unit cases: the accepted prefix plus the
    correction, and full acceptance plus the bonus token."""
    logits = 8.0 * np.eye(16, dtype=np.float32)[[5, 6, 7, 9]][None]
    zeros = np.zeros(1, np.int64)
    greedy = np.zeros(1, np.float32)
    n_acc, toks, lps = verify_draft(torch.as_tensor(logits),
                                    np.array([[5, 6, 8, 0]]), [3], greedy,
                                    zeros, zeros, zeros)
    assert n_acc[0] == 2 and toks[0, :3].tolist() == [5, 6, 7]
    assert np.all(lps[0, :3] <= 0)
    n_acc, toks, _ = verify_draft(torch.as_tensor(logits),
                                  np.array([[5, 6, 7, 0]]), [3], greedy,
                                  zeros, zeros, zeros)
    assert n_acc[0] == 3 and toks[0].tolist() == [5, 6, 7, 9]


def _stochastic(p_logits, draft_tok, n_rows, temperature=1.0, top_k=0):
    """n_rows independent rows (seeds 0..n-1) verifying one draft token at
    position 0 of the same [2, V] logits."""
    logits = torch.as_tensor(np.broadcast_to(
        p_logits, (n_rows, *p_logits.shape)).copy())
    draft = np.zeros((n_rows, 2), np.int64)
    draft[:, 0] = draft_tok
    return verify_draft(logits, draft, np.ones(n_rows, np.int64),
                        np.full(n_rows, temperature, np.float32),
                        np.full(n_rows, top_k, np.int64),
                        np.arange(n_rows), np.full(n_rows, 5))


def test_stochastic_rule_preserves_the_target_distribution():
    """Leave-one-in: the token emitted at the draft's position is
    distributed as the target's p whatever the (deterministic) draft, and
    the bonus position after an accepted draft as its own p."""
    rng = np.random.default_rng(0)
    V, n = 6, 40000
    p_logits = rng.standard_normal((2, V)).astype(np.float32) * 1.5
    p = torch.softmax(torch.as_tensor(p_logits), -1).numpy()
    for draft_tok in (int(p[0].argmax()), int(p[0].argmin())):
        n_acc, toks, _ = _stochastic(p_logits, draft_tok, n)
        first = np.bincount(toks[:, 0], minlength=V) / n
        sigma = np.sqrt(p[0] * (1 - p[0]) / n)
        assert np.all(np.abs(first - p[0]) < 5 * sigma + 1e-9), (first, p[0])
        # acceptance happens with probability p(draft)
        acc = (n_acc == 1).mean()
        s_acc = np.sqrt(p[0, draft_tok] * (1 - p[0, draft_tok]) / n)
        assert abs(acc - p[0, draft_tok]) < 5 * s_acc
        # rejected rows never emit the draft token
        assert not np.any(toks[n_acc == 0, 0] == draft_tok)
        bonus = toks[n_acc == 1, 1]
        if len(bonus) > 500:
            freq = np.bincount(bonus, minlength=V) / len(bonus)
            s = np.sqrt(p[1] * (1 - p[1]) / len(bonus))
            assert np.all(np.abs(freq - p[1]) < 5 * s + 1e-9)


def test_stochastic_rule_matches_jax_in_distribution():
    """Over many seeds, the port's accepted share and emitted-token
    histogram at a draft position match JAX's (different generators, the
    same rule), here with top-k 3 and temperature 0.7."""
    rng = np.random.default_rng(5)
    V, n = 8, 20000
    p_logits = rng.standard_normal((2, V)).astype(np.float32)
    draft_tok = int(np.argsort(-p_logits[0])[1])
    got = _stochastic(p_logits, draft_tok, n, temperature=0.7, top_k=3)
    draft = np.zeros((n, 2), np.int64)
    draft[:, 0] = draft_tok
    want = _jax_verify(np.broadcast_to(p_logits, (n, 2, V)), draft,
                       np.ones(n), np.full(n, 0.7), np.full(n, 3),
                       np.arange(n), np.full(n, 5))
    for a, b in ((got[0] == 1, want[0] == 1),
                 *((got[1][:, 0] == v, want[1][:, 0] == v)
                   for v in range(V))):
        pa, pb = a.mean(), b.mean()
        sigma = np.sqrt(max(pa * (1 - pa), pb * (1 - pb), 1e-12) * 2 / n)
        assert abs(pa - pb) < 5 * sigma + 1e-9


def test_stochastic_rule_is_deterministic_and_respects_top_k():
    rng = np.random.default_rng(1)
    p_logits = rng.standard_normal((2, 32)).astype(np.float32)
    a = _stochastic(p_logits, 3, 64, temperature=0.8, top_k=4)
    b = _stochastic(p_logits, 3, 64, temperature=0.8, top_k=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    top4 = set(np.argsort(-p_logits[0])[:4].tolist())
    emitted = a[1][:, 0]
    assert set(emitted.tolist()) <= top4 | {3}
    assert set(emitted[a[0] == 0].tolist()) <= top4 - {3}
    # the rows' seeds differ, so their draws do
    assert len(set(emitted.tolist())) > 1
    assert np.all(a[2][:, :2] <= 1e-6)


def test_keyed_uniforms_are_uniform_and_streams_independent():
    seeds = np.repeat(np.arange(200), 100)
    steps = np.tile(np.arange(100), 200)
    u0 = keyed_uniforms(seeds, steps, 0)
    u1 = keyed_uniforms(seeds, steps, 1)
    assert u0.min() >= 0.0 and u0.max() < 1.0
    np.testing.assert_array_equal(u0, keyed_uniforms(seeds, steps, 0))
    hist = np.histogram(u0, bins=10, range=(0, 1))[0] / len(u0)
    assert np.all(np.abs(hist - 0.1) < 5 * np.sqrt(0.09 / len(u0)))
    assert abs(np.corrcoef(u0, u1)[0, 1]) < 5 / np.sqrt(len(u0))
    assert abs(np.corrcoef(u0[:-1], u0[1:])[0, 1]) < 5 / np.sqrt(len(u0))


def test_verify_bucket_matches_jax():
    for k0 in range(1, 9):
        for q in range(0, 40):
            assert verify_bucket(q, k0) == jax_verify_bucket(q, k0), (q, k0)


def test_ngram_proposer_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(200):
        seq = rng.integers(0, 5, rng.integers(0, 30)).tolist()
        n, k = int(rng.integers(1, 4)), int(rng.integers(0, 6))
        assert NGramProposer(n).propose(seq, k) == JaxNGram(n).propose(seq, k)
    seq = [3, 4, 9, 8, 7, 3, 4]
    assert NGramProposer(2).propose(seq, 3) == [9, 8, 7]


@pytest.mark.parametrize("kw", [
    dict(method="oracle"), dict(method="model"), dict(k=9, method="ngram"),
    dict(k=0, method="ngram"), dict(min_k=3, k=2, method="ngram"),
    dict(ngram=0, method="ngram"), dict(k=4, max_k=8, method="ngram"),
    dict(k=1, min_k=1, max_k=1, method="model", params={})])
def test_config_validation_matches_jax(kw):
    def outcome(cls):
        try:
            cls(**kw)
        except ValueError as e:
            return str(e)
        return None
    assert outcome(SpeculativeConfig) == outcome(JaxSpecConfig)
    fields = [f.name for f in dataclasses.fields(SpeculativeConfig)]
    assert fields == [f.name for f in dataclasses.fields(JaxSpecConfig)]


def test_spec_verify_reserve_matches_jax():
    rng = np.random.default_rng(3)
    statuses = [(Status.RUNNING, JaxStatus.RUNNING),
                (Status.PREFILLING, JaxStatus.PREFILLING),
                (Status.QUEUED, JaxStatus.QUEUED)]
    for _ in range(20):
        port, ref = {}, {}
        for i in range(rng.integers(0, 6)):
            st, jst = statuses[rng.integers(3)]
            dk = int(rng.integers(0, 9))
            r = Request(i, [1, 2], SamplingParams(max_new_tokens=4))
            jr = JaxRequest(i, [1, 2], JaxSamplingParams(max_new_tokens=4))
            r.status, r.draft_k, jr.status, jr.draft_k = st, dk, jst, dk
            port[i], ref[i] = r, jr
        k = int(rng.integers(1, 5))
        assert spec_verify_reserve(port, k) == jax_reserve(ref, k)


SHAPE = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=512, vocab=512)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("dtype,quantize", [
    ("bfloat16", False), ("bfloat16", True), ("float32", False),
    ("float32", True)])
def test_densify_is_bit_identical_to_jax(dtype, quantize):
    cfg = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                              remat=False, dtype=getattr(jnp, dtype), **SHAPE)
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), cfg)
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    sparse, _ = jax_sparsify(dense, scfg, quantize=quantize)
    want = jax_densify(sparse)
    port_sparse = from_jax_params(sparse, device="cpu")
    got = densify_params(port_sparse)
    n = 0
    for i, lp in enumerate(port_sparse["layers"]):
        for name, leaf in lp.items():
            ref = np.asarray(want["layers"][name][i])
            if isinstance(leaf, SparseWeight):
                n += 1
                assert leaf.o_values is not None
                assert (leaf.v_scale is not None) == quantize
                w = densify(leaf)
                assert w.shape == ref.shape and str(w.dtype).endswith(
                    str(ref.dtype))
                np.testing.assert_array_equal(_torch_bits(w), _bits(ref))
            np.testing.assert_array_equal(_torch_bits(got["layers"][i][name]),
                                          _bits(ref))
    assert n == 2 * 7
    assert got["embed"] is port_sparse["embed"]


# ------------------------------------------------ chip_smoke's near-tie gate
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = dataclasses.replace(configs.get_smoke("llama-paper"), name="near-tie",
                           dtype=torch.float32, n_layers=2, d_model=128,
                           n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                           vocab=512)


def test_near_tie_gate_fails_a_planted_wrong_token():
    cs = _chip_smoke()
    params = tfm.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    prompt = np.random.default_rng(4).integers(0, TINY.vocab, 12).tolist()
    stream = []
    with torch.no_grad():
        for _ in range(6):
            z, _ = tfm.forward(params, {"tokens": torch.tensor(
                [prompt + stream])}, TINY)
            stream.append(int(z[0, -1].argmax()))
    # identical streams pass and report no divergence
    assert cs.stream_gate(torch, "t", TINY, params, [prompt], [stream],
                          [list(stream)]) == [None]
    # a wrong token at position 3: the forward's lowest logit there
    with torch.no_grad():
        z, _ = tfm.forward(params, {"tokens": torch.tensor(
            [prompt + stream[:3]])}, TINY)
    planted = list(stream)
    planted[3] = int(z[0, -1].argmin())
    with pytest.raises(cs.SmokeFailure, match="near-tie bound"):
        cs.stream_gate(torch, "t", TINY, params, [prompt], [stream],
                       [planted])
    # a stream cut short fails too
    with pytest.raises(cs.SmokeFailure, match="streams of"):
        cs.stream_gate(torch, "t", TINY, params, [prompt], [stream],
                       [stream[:-1]])


def test_near_tie_bound_admits_ties_within_rounding():
    cs = _chip_smoke()
    z = torch.linspace(-3.0, 3.0, 1000)
    b = cs.near_tie_bound(z, 32)
    # 4 sigmas of sqrt(2 (2L + 1)) roundings of 2^-8 at the logits' RMS,
    # plus one bf16 ulp of the top logit (3.0: 2^-6)
    rms = float(z.pow(2).mean().sqrt())
    assert b == pytest.approx(4 * 2 ** -8 * np.sqrt(130) * rms + 2 ** -6)
    assert cs.first_divergence([1, 2, 3], [1, 2, 4]) == 2
    assert cs.first_divergence([1, 2], [1, 2]) is None
    assert cs.first_divergence([1, 2], [1]) == 1
