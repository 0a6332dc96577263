"""Model and shape configurations, and the architecture registry (port of
``repro/configs/base.py``).

Each architecture has one module in this package defining ``CONFIG`` (its
published hyper-parameters) and ``smoke()`` (a reduced config of the same
family for CPU tests), with the reference's values; ``dtype`` is a
``torch.dtype``.  ``get(name)`` resolves an id.  Every family is
registered, so ids and parameter counts match the reference's; the dense,
moe, ssm (xLSTM), hybrid (Zamba2) and encdec (Whisper) families are
served, and the vlm family's backbone runs through ``forward``/``loss_fn``
(the serving engine refuses it, as the reference's does).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False          # llama4-style always-on expert
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    act: str = "silu"                    # silu | gelu | sq_relu
    glu: bool = True                     # gated MLP (SwiGLU/GeGLU) vs plain
    qk_norm: bool = False                # qwen3
    rope_theta: float = 10000.0
    window: int | None = None            # sliding-window attention (mixtral)
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE
    moe: MoEConfig | None = None
    # ssm / hybrid:
    ssm_state: int = 0                   # mamba2 state dim
    ssm_head_dim: int = 64
    slstm_every: int = 0                 # xlstm: sLSTM at layers i % k == k-1
    attn_every: int = 0                  # zamba2: shared attn after every k
    # enc-dec:
    enc_layers: int = 0                  # whisper encoder depth
    # numerics / perf knobs:
    dtype: Any = torch.bfloat16
    remat: bool = True                   # recompute each block in backward
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    source: str = ""                     # citation tag

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic total parameter count, the reference's formula."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.family == "ssm":        # xlstm block
            di = 2 * d
            blk = d * 2 * di + 3 * di * di // 4 + di * d + 2 * di
            return emb + self.n_layers * blk
        if self.family == "hybrid":     # mamba2 blocks + shared attn block
            di = 2 * d
            mamba = d * (2 * di + 2 * self.ssm_state + di // self.ssm_head_dim) \
                + di * d
            ff = 3 * d * self.d_ff
            return emb + self.n_layers * mamba + (attn + ff)  # shared => once
        ff_mult = 3 if self.glu else 2
        if self.moe is not None:
            ff = self.moe.num_experts * ff_mult * d * self.moe.d_ff_expert
            if self.moe.shared_expert:
                ff += ff_mult * d * self.moe.d_ff_expert
            ff += self.moe.num_experts * d  # router
        else:
            ff = ff_mult * d * self.d_ff
        layers = self.n_layers * (attn + ff)
        if self.family == "encdec":
            # encoder blocks + decoder cross-attention
            layers += self.enc_layers * (attn + ff_mult * d * self.d_ff)
            layers += self.n_layers * attn
        return emb + layers

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        ff_mult = 3 if self.glu else 2
        dense_ff_like = self.moe.top_k * ff_mult * d * self.moe.d_ff_expert
        if self.moe.shared_expert:
            dense_ff_like += ff_mult * d * self.moe.d_ff_expert
        attn = d * (self.n_heads * self.hd) + 2 * d * (self.n_kv_heads * self.hd) \
            + (self.n_heads * self.hd) * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * (attn + dense_ff_like
                                      + self.moe.num_experts * d)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs with recurrent/hybrid state run long_500k; pure full-attention skip
# it.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")

def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    if name not in _REGISTRY:       # registry may be partially populated
        _load_all()
    return _REGISTRY[name]


def all_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


ASSIGNED = [
    "qwen2-vl-72b", "xlstm-350m", "gemma-7b", "qwen3-8b", "internlm2-1.8b",
    "nemotron-4-340b", "mixtral-8x7b", "llama4-maverick-400b-a17b",
    "whisper-medium", "zamba2-2.7b",
]

PAPER_ARCHS = ["llama2-7b", "llama2-13b", "llama3-8b", "mistral-7b"]


def _load_all():
    from . import (qwen2_vl_72b, xlstm_350m, gemma_7b, qwen3_8b,          # noqa
                   internlm2_1_8b, nemotron4_340b, mixtral_8x7b,
                   llama4_maverick, whisper_medium, zamba2_2_7b, paper_models)
