"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family;
unverified].

48L, d_model 5120, 40 heads (GQA kv=8, head_dim 128), vocab 202048; MoE with
128 experts, top-1 routing + one always-on shared expert, expert d_ff 8192.
(Upstream Maverick interleaves dense/MoE layers; we model all layers as MoE
with shared expert — active-params accounting uses top-1 + shared.)
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    rope_theta=5e5,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  shared_expert=True),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="llama4-maverick-400b-a17b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        moe=MoEConfig(num_experts=8, top_k=1, d_ff_expert=128,
                      shared_expert=True),
        remat=False,
    ))
