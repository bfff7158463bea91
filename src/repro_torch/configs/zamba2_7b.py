"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention block
applied every `shared_attn_every` layers (weights reused at each site)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,                 # shared block FFN
    vocab=32000,
    layout="hybrid",
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    shared_attn_every=7,        # 81 layers -> 11 shared-attn applications
    rope_theta=1e4,
)
