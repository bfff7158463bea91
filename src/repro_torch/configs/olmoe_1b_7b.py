"""OLMoE-1B-7B [arXiv:2409.02060; hf] — 64-expert top-8 MoE."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe_1b_7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,               # per-expert FFN width
    expert_d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    softmax_before_topk=True,
    rope_theta=1e4,
    qk_norm=True,            # OLMoE uses QK-norm
)
