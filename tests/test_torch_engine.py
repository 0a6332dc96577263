"""The port's ``ServingEngine`` against the JAX package's on the slot layout:
greedy f32 token streams must be identical, dense and 8:16+16:256 sparse,
under a token budget small enough to chunk every prompt longer than it,
with a deterministic submission schedule (some requests at step 0, the rest
after a fixed number of steps) and more requests than slots."""
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
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.serving import (SamplingParams, ServingEngine,  # noqa: E402
                                 Status)
from repro_torch.serving.sampling import sample_tokens_logprobs  # noqa: E402

SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=256, vocab=512)
JCFG = dataclasses.replace(jax_configs.get_smoke("llama-paper"),
                           name="torch-engine", remat=False,
                           dtype=jnp.float32, **SHAPE)
CFG = dataclasses.replace(configs.get_smoke("llama-paper"),
                          name="torch-engine", dtype=torch.float32, **SHAPE)
ENGINE = dict(n_slots=4, max_len=64, token_budget=16)
PROMPT_LENS = [5, 23, 12, 40, 9, 17]
EARLY, LATE_AT_STEP, GEN = 3, 2, 6


@pytest.fixture(scope="module")
def param_pairs():
    dense = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    sparse, _ = jax_sparsify(dense, scfg)
    return {"dense": (dense, from_jax_params(dense, device="cpu")),
            "sparse": (sparse, from_jax_params(sparse, device="cpu"))}


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, CFG.vocab, n).tolist() for n in PROMPT_LENS]


def _drive(engine, sampling, preempt_at=None):
    """The fixed schedule: EARLY requests at step 0, the rest after
    LATE_AT_STEP steps; optionally preempt the youngest running request
    after step ``preempt_at``.  Returns the requests in submission order."""
    prompts = _prompts()
    reqs = [engine.submit(p, sampling) for p in prompts[:EARLY]]
    step = 0
    while engine.has_work or len(reqs) < len(prompts):
        if step == LATE_AT_STEP:
            reqs += [engine.submit(p, sampling) for p in prompts[EARLY:]]
        engine.step()
        step += 1
        if step == preempt_at:
            engine._preempt_one({"preempted": 0})
    return reqs


def _run_pair(param_pairs, which, preempt_at=None):
    jparams, tparams = param_pairs[which]
    jreqs = _drive(JaxServingEngine(JCFG, jparams, **ENGINE),
                   JaxSamplingParams(max_new_tokens=GEN), preempt_at)
    engine = ServingEngine(CFG, tparams, device="cpu", **ENGINE)
    treqs = _drive(engine, SamplingParams(max_new_tokens=GEN), preempt_at)
    return jreqs, treqs, engine


@pytest.mark.parametrize("which", ["dense", "sparse"])
def test_greedy_streams_identical_to_jax_engine(which, param_pairs):
    jreqs, treqs, engine = _run_pair(param_pairs, which)
    for j, t in zip(jreqs, treqs):
        assert t.status is Status.FINISHED
        assert t.tokens == j.tokens, f"request {t.request_id} diverged"
        assert t.metrics.prefill_chunks == j.metrics.prefill_chunks
    # the budget chunked the long prompts, and slots were recycled
    assert max(t.metrics.prefill_chunks for t in treqs) > 1
    assert len({t.slot for t in treqs}) < len(treqs)
    st = engine.stats()
    assert st["n_finished"] == len(PROMPT_LENS) and st["n_model_calls"] > 0


def test_preemption_resume_identical_to_jax_engine(param_pairs):
    """A request preempted mid-run re-prefills prompt + generated tokens on
    resume; both engines then emit the streams they would have."""
    jreqs, treqs, engine = _run_pair(param_pairs, "sparse", preempt_at=5)
    assert engine.n_preemptions == 1
    assert sum(t.metrics.n_preemptions for t in treqs) == 1
    for j, t in zip(jreqs, treqs):
        assert t.tokens == j.tokens, f"request {t.request_id} diverged"


def test_stochastic_sampling_valid_and_reproducible():
    """Stochastic rows cannot match JAX's threefry draws; they must stay
    inside the top-k and depend only on (seed, token index)."""
    logits = torch.from_numpy(
        np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32))
    logits[2] = logits[1]
    temps = np.array([0.0, 0.8, 0.8, 1.5], np.float32)
    topks = np.array([0, 3, 3, 5])
    seeds = np.array([0, 1, 1, 2])
    steps = np.array([0, 4, 4, 9])
    toks, lps = sample_tokens_logprobs(logits, temps, topks, seeds, steps)
    assert toks[0] == int(torch.argmax(logits[0]))
    for b in (1, 2, 3):
        assert toks[b] in torch.topk(logits[b], int(topks[b])).indices
    assert toks[1] == toks[2]                  # same (seed, index), same draw
    again, _ = sample_tokens_logprobs(logits, temps, topks, seeds, steps)
    np.testing.assert_array_equal(toks, again)
    np.testing.assert_allclose(
        lps, torch.log_softmax(logits, -1)[torch.arange(4),
                                           torch.as_tensor(toks)].numpy())


def test_default_device_raises_without_cuda(param_pairs):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(CFG, param_pairs["dense"][1])


@pytest.mark.parametrize("kwargs,item", [
    (dict(draft=object()), "A8"), (dict(mesh=object()), "A12")])
def test_left_out_options_raise_naming_roadmap(kwargs, item, param_pairs):
    with pytest.raises(NotImplementedError, match=item):
        ServingEngine(CFG, param_pairs["dense"][1], device="cpu", **kwargs)


def test_paged_layout_constructs_and_serves(param_pairs):
    engine = ServingEngine(CFG, param_pairs["dense"][1], device="cpu",
                           kv_layout="paged", **ENGINE)
    reqs = _drive(engine, SamplingParams(max_new_tokens=GEN))
    assert all(r.status is Status.FINISHED and len(r.tokens) == GEN
               for r in reqs)
    assert engine.stats()["pool"]["layout"] == "paged"
