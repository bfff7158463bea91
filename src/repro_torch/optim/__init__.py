"""Optimizer and learning-rate schedule (torch twin of ``repro.optim``)."""
from . import adamw
from .schedule import cosine_with_warmup

__all__ = ["adamw", "cosine_with_warmup"]
