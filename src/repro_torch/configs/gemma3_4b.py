"""Gemma3-4B [hf:google/gemma-3 family] — 5:1 local:global attention,
local window 1024, dual rope theta, gemma-style norms, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab=262144,
    local_global=(5, 1024),       # 5 local (window 1024) : 1 global
    rope_theta=1e4,               # local layers
    rope_theta_global=1e6,        # global layers
    gemma_norm=True,
    scale_embed=True,
    tie_embeddings=True,
)
