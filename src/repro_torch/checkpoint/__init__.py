"""Checkpointing (torch twin of ``repro.checkpoint``'s ``Checkpointer``)."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
