"""InternLM2-1.8B [arXiv:2403.17297; hf].

24L, d_model 2048, 16 heads (GQA kv=8, head_dim 128), d_ff 8192, vocab 92544.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92544,
    source="arXiv:2403.17297; hf:internlm/internlm2-1_8b",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="internlm2-1.8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, remat=False,
    ))
