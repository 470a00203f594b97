"""Optimizers of the port: AdamW (+8-bit moments), LR schedules, gradient
compression (port of ``repro/optim``)."""
from .adamw import AdamWConfig, apply_updates, init
from .schedules import constant, warmup_cosine
