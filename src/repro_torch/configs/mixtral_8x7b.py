"""Mixtral-8x7B [arXiv:2401.04088; hf].

32L, d_model 4096, 32 heads (GQA kv=8), vocab 32000; MoE FFN with 8 experts,
top-2 routing, expert d_ff 14336; sliding-window attention (4096).
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="mixtral-8x7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window=16,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        remat=False,
    ))
