"""xLSTM-350M [arXiv:2405.04517; unverified].

24 blocks, d_model 1024, 4 heads, vocab 50304 (GPT-NeoX tokenizer rounding).
d_ff=0 per the assignment — xLSTM blocks carry their own 2x up/down
projections instead of a separate MLP.  sLSTM blocks interleaved every 8th
layer (xLSTM[7:1]); the rest are mLSTM (matrix memory, chunkwise-parallel).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8,
    source="arXiv:2405.04517",
))


def smoke() -> ModelConfig:
    return register(ModelConfig(
        name="xlstm-350m-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=256, slstm_every=2, remat=False,
    ))
