"""Zamba2-2.7B [arXiv:2411.15242; hf].

54 Mamba2 blocks (d_model 2560, ssm_state 64, ssm head_dim 64) with ONE
shared full-attention+MLP block (32 heads, head_dim 80, d_ff 10240) applied
after every 6th Mamba2 block — weights shared across applications, each
application keeping its own KV cache.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, attn_every=6,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        ssm_state=16, ssm_head_dim=16, attn_every=2, remat=False,
    ))
