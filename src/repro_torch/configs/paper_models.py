"""The paper's own evaluation models (Tables 2-8): LLaMA-2 7B/13B, LLaMA-3 8B,
Mistral 7B [arXiv:2307.09288, 2407.21783, 2310.06825; hf]."""
from .base import ModelConfig, register

LLAMA2_7B = register(ModelConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=32000,
    source="arXiv:2307.09288",
))

LLAMA2_13B = register(ModelConfig(
    name="llama2-13b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=13824, vocab=32000,
    source="arXiv:2307.09288",
))

LLAMA3_8B = register(ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, rope_theta=5e5,
    source="arXiv:2407.21783",
))

MISTRAL_7B = register(ModelConfig(
    name="mistral-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, window=4096,
    source="arXiv:2310.06825",
))


def smoke() -> ModelConfig:
    """A tiny llama-family model used by paper-table benchmarks: small enough
    to train on CPU, big enough to show the pruning-method orderings."""
    return register(ModelConfig(
        name="llama-paper-smoke", family="dense",
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=512, remat=False,
    ))
