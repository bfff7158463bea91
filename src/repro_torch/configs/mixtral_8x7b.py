"""Mixtral-8x7B [arXiv:2401.04088; hf] — 8-expert top-2 MoE with SWA."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral_8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    expert_d_ff=14336,
    vocab=32000,
    n_experts=8,
    top_k=2,
    softmax_before_topk=False,   # mixtral: top-k of logits, then softmax
    sliding_window=4096,
    rope_theta=1e6,
)
