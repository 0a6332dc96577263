"""Whisper-medium backbone [arXiv:2212.04356; unverified].

24 encoder + 24 decoder layers, d_model 1024, 16 heads (MHA), GELU d_ff 4096,
vocab 51865.  Conv/log-mel frontend is a STUB per the assignment:
input_specs feeds precomputed frame embeddings [B, S, d].
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=51865,
    act="gelu", glu=False,
    source="arXiv:2212.04356",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="whisper-medium-smoke", family="encdec",
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256, act="gelu", glu=False, remat=False,
    ))
