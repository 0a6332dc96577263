"""The port's ``ServingEngine`` on the dense family's other members against
the JAX package's engine, at f32 on their smoke twins (qwen3-8b: qk_norm;
gemma-7b: GeGLU, head dim 32, tied head; internlm2-1.8b; nemotron-4-340b:
squared ReLU, non-gated), with the JAX weights carried over by
``interchange``: greedy token streams identical on the slot layout and the
paged layout (block 8), on dense weights and on 8:16 weights (the smoke
widths keep 16:256 outliers only where an in-dim holds a 256-block, as the
reference's ``_leaf_cfg`` does), and with int8 paged KV arenas.
"""
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

ARCHS = ["qwen3-8b", "gemma-7b", "internlm2-1.8b", "nemotron-4-340b"]
# (weights, layout, KV arena)
CASES = [("dense", "slot", "bf16"), ("dense", "paged", "bf16"),
         ("sparse", "slot", "bf16"), ("sparse", "paged", "bf16"),
         ("dense", "paged", "int8")]
PROMPT_LENS, GEN = [5, 19, 11], 6
ENGINE = dict(n_slots=4, max_len=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread each, so several test workers on
    one machine do not oversubscribe its cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch: (jcfg, cfg, {weights: (JAX params, port params)})."""
    scfg = JaxSparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                             scorer="magnitude", use_smoothquant=False)
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                                   dtype=jnp.float32)
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  dtype=torch.float32)
        dense = jax_tfm.init_params(jax.random.PRNGKey(20 + i), jcfg)
        sparse, _ = jax_sparsify(dense, scfg)
        out[arch] = (jcfg, cfg, {
            "dense": (dense, from_jax_params(dense, "cpu")),
            "sparse": (sparse, from_jax_params(sparse, "cpu"))})
    return out


def _kw(layout, kv_dtype):
    kw = dict(ENGINE, kv_dtype=kv_dtype)
    if layout == "paged":
        kw.update(kv_layout="paged", block_size=8)
    return kw


@pytest.mark.parametrize("weights,layout,kv_dtype", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_identical_to_jax_engine(models, arch, weights, layout,
                                         kv_dtype):
    jcfg, cfg, pairs = models[arch]
    jparams, params = pairs[weights]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    jengine = JaxServingEngine(jcfg, jparams, **_kw(layout, kv_dtype))
    jreqs = [jengine.submit(p, JaxSamplingParams(max_new_tokens=GEN))
             for p in prompts]
    jengine.run(max_steps=100)
    engine = ServingEngine(cfg, params, device="cpu",
                           **_kw(layout, kv_dtype))
    reqs = [engine.submit(p, SamplingParams(max_new_tokens=GEN))
            for p in prompts]
    engine.run(max_steps=100)
    for j, t in zip(jreqs, reqs):
        assert t.status is Status.FINISHED and len(t.tokens) == GEN
        assert t.tokens == j.tokens, f"request {t.request_id} diverged"
        assert t.metrics.prefill_chunks == j.metrics.prefill_chunks
    assert engine.stats()["n_steps"] == jengine.stats()["n_steps"]
