"""Qwen3-4B [hf:Qwen/Qwen3-8B family] — dense GQA with qk_norm, d_head=128."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
)
