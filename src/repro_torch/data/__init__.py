"""Synthetic training data (torch twin of ``repro.data``)."""
from .pipeline import Prefetcher, ShardInfo, SyntheticLM

__all__ = ["Prefetcher", "ShardInfo", "SyntheticLM"]
