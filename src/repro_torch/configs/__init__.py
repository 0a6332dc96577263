"""Architecture registry: ``repro_torch.configs.get("qwen3-8b")`` etc. (port
of ``repro/configs/__init__.py``)."""

from .base import (ASSIGNED, PAPER_ARCHS, SHAPES, SUBQUADRATIC_FAMILIES,
                   ModelConfig, MoEConfig, ShapeConfig, all_archs, get,
                   register, shape_applicable)

SMOKE_MODULES = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "xlstm-350m": "xlstm_350m",
    "gemma-7b": "gemma_7b",
    "qwen3-8b": "qwen3_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "nemotron-4-340b": "nemotron4_340b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "whisper-medium": "whisper_medium",
    "zamba2-2.7b": "zamba2_2_7b",
    "llama-paper": "paper_models",
}
"""The arch ids ``get_smoke`` resolves, and the module of each."""


def get_smoke(name: str) -> ModelConfig:
    """The reduced smoke config for an assigned arch id."""
    import importlib
    mod = importlib.import_module(f".{SMOKE_MODULES[name]}", __package__)
    return mod.smoke()
