"""Model configurations of the dense decoder family and the paper's models.

Counterpart of ``repro/configs/base.py`` (``ModelConfig``) and
``repro/configs/paper_models.py``, reduced to the fields the dense family
reads.  ``dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    act: str = "silu"                    # silu | gelu | sq_relu
    glu: bool = True                     # gated MLP (SwiGLU/GeGLU) vs plain
    rope_theta: float = 10000.0
    window: int | None = None            # sliding-window attention (mistral)
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True                   # recompute each block in backward
    norm_eps: float = 1e-6
    source: str = ""                     # citation tag

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    return _REGISTRY[name]


# The paper's own evaluation models (Tables 2-8).
LLAMA2_7B = register(ModelConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=32000,
    source="arXiv:2307.09288",
))

LLAMA2_13B = register(ModelConfig(
    name="llama2-13b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=13824, vocab=32000,
    source="arXiv:2307.09288",
))

LLAMA3_8B = register(ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, rope_theta=5e5,
    source="arXiv:2407.21783",
))

MISTRAL_7B = register(ModelConfig(
    name="mistral-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, window=4096,
    source="arXiv:2310.06825",
))


def _llama_paper_smoke() -> ModelConfig:
    """The tiny llama-family model of the paper-table benchmarks."""
    return register(ModelConfig(
        name="llama-paper-smoke", family="dense",
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=512, remat=False,
    ))


_SMOKE = {"llama-paper": _llama_paper_smoke}


def get_smoke(name: str) -> ModelConfig:
    """The reduced same-family config for an arch id."""
    return _SMOKE[name]()
