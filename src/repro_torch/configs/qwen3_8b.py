"""Qwen3-8B [hf:Qwen/Qwen3-8B].

36L, d_model 4096, 32 heads (GQA kv=8, head_dim 128), d_ff 12288,
vocab 151936, per-head q/k RMSNorm (qk_norm).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="qwen3-8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, qk_norm=True, remat=False,
    ))
