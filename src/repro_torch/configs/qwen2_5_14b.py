"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family] — dense GQA with QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_5_14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
)
