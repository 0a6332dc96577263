"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

80L, d_model 8192, 64 heads (GQA kv=8, head_dim 128), d_ff 29568,
vocab 152064.  M-RoPE with sections (16, 24, 24) frequency pairs for
(temporal, height, width) position ids.  The vision patch frontend is a stub
per the assignment: input_specs feeds precomputed patch/text embeddings plus
the 3-row M-RoPE position ids.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    act="silu", glu=True, rope_theta=1e6, mrope_sections=(16, 24, 24),
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="qwen2-vl-72b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        act="silu", glu=True, rope_theta=1e6, mrope_sections=(2, 3, 3),
        remat=False,
    ))
