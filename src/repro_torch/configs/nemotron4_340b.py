"""Nemotron-4-340B [arXiv:2402.16819 (Nemotron-4 15B report family); unverified].

96L, d_model 18432, 96 heads (GQA kv=8, head_dim 192), squared-ReLU
(non-gated) d_ff 73728, vocab 256000.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000,
    act="sq_relu", glu=False,
    source="arXiv:2402.16819",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="nemotron-4-340b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=256, act="sq_relu", glu=False, remat=False,
    ))
