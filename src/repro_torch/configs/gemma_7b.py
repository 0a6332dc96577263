"""Gemma-7B [arXiv:2403.08295; hf].

28L, d_model 3072, 16 heads with head_dim 256 (q-dim 4096 != d_model),
MHA (kv=16; the 2b sibling uses MQA), GeGLU d_ff 24576, vocab 256000,
tied embeddings.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000,
    act="gelu", glu=True, tie_embeddings=True,
    source="arXiv:2403.08295; hf:google/gemma-7b",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="gemma-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=128, vocab=256, act="gelu", glu=True, tie_embeddings=True,
        remat=False,
    ))
