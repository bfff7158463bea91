"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_1_3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,                 # unused (attn-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    layout="mamba",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
)
