"""Qwen2-VL-72B [arXiv:2409.12191; hf] — M-RoPE; vision frontend stubbed
(input_specs provides precomputed patch embeddings per the assignment)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),   # (temporal, height, width) of head_dim/2
    input_mode="embeds",
)
