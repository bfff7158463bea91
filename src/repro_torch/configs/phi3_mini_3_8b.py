"""Phi-3-mini-3.8B [arXiv:2404.14219] — dense, MHA-as-GQA (kv = heads)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3_mini_3_8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    rope_theta=1e4,
)
