"""Optimizer, learning-rate schedules and gradient compression (port of
``repro/optim``)."""
from . import grad_compress
from .adamw import AdamWConfig, global_norm
from .adamw import init as adamw_init
from .adamw import step as adamw_step
from .schedule import constant, cosine_with_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_step", "global_norm",
           "cosine_with_warmup", "constant", "grad_compress"]
