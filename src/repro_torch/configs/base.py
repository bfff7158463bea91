"""Architecture + shape configuration system.

Each assigned architecture gets a module in this package defining an
``ArchConfig`` with its exact published dimensions; ``registry()`` maps
``--arch <id>`` to it.  ``smoke(cfg)`` derives the reduced same-family
config used by CPU smoke tests.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None       # default: d_model // n_heads
    # --- attention options ----------------------------------------------------
    rope_theta: float = 1e4
    rope_theta_global: float | None = None   # gemma3 global layers
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int | None = None        # SWA on all attn layers (mixtral)
    local_global: tuple[int, int] | None = None  # (local:global ratio, local window)
    soft_cap: float | None = None
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE
    # --- FFN / MoE -------------------------------------------------------------
    mlp_kind: str = "swiglu"        # swiglu | gelu (musicgen)
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int | None = None  # d_ff of each expert (olmoe: 1024)
    softmax_before_topk: bool = True
    aux_loss_weight: float = 0.01
    moe_capacity_factor: float = 1.25   # EP per-shard capacity (GShard-style)
    # --- SSM / hybrid -----------------------------------------------------------
    layout: str = "attn"            # attn | mamba | hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    shared_attn_every: int = 0      # hybrid: shared attn block every k layers
    # --- embeddings / frontend ---------------------------------------------------
    input_mode: str = "tokens"      # tokens | embeds (stubbed vlm/audio frontend)
    tie_embeddings: bool = False
    scale_embed: bool = False       # gemma-style sqrt(d) embedding scale
    gemma_norm: bool = False        # RMSNorm uses (1 + scale)
    norm_eps: float = 1e-6
    # --- runtime ------------------------------------------------------------------
    chunk: int = 128                # SSD chunk length
    remat: bool = True
    attn_q_chunk: int | None = None  # flash-style query chunking (§Perf)
    kv_cache_quant: bool = False     # int8 KV cache + per-head scales (§Perf)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_window_pattern(self) -> list[int]:
        """Per-layer attention window (0 = full causal); [] for pure SSM."""
        if self.layout == "mamba":
            return []
        if self.local_global is not None:
            ratio, win = self.local_global
            # gemma3 pattern: `ratio` local layers then 1 global
            out = []
            for i in range(self.n_layers):
                out.append(0 if (i % (ratio + 1)) == ratio else win)
            return out
        w = self.sliding_window or 0
        return [w] * self.n_layers

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, L = self.d_model, self.n_layers
        dh = self.head_dim
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.layout == "mamba":
            di = self.ssm_expand * d
            per = (2 * d * di + 2 * d * self.ssm_state + d * (di // self.ssm_headdim)
                   + di * d + 2 * d)
            return n + L * per
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        if self.is_moe:
            eff = self.expert_d_ff or self.d_ff
            ffn = self.n_experts * 3 * d * eff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff if self.mlp_kind == "swiglu" else 2 * d * self.d_ff
        per = attn + ffn + 2 * d
        if self.layout == "hybrid":
            di = self.ssm_expand * d
            per = (2 * d * di + 2 * d * self.ssm_state
                   + d * (di // self.ssm_headdim) + di * d + 2 * d)
            shared = attn + 3 * d * self.d_ff + 2 * d
            return n + L * per + shared
        return n + L * per

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        dh = self.head_dim
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        eff = self.expert_d_ff or self.d_ff
        ffn = self.top_k * 3 * d * eff + d * self.n_experts
        return n + L * (attn + ffn + 2 * d)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}

ARCH_IDS = [
    "olmoe_1b_7b", "mixtral_8x7b", "qwen2_vl_72b", "qwen2_5_14b",
    "phi3_mini_3_8b", "qwen3_4b", "gemma3_4b", "zamba2_7b",
    "mamba2_1_3b", "musicgen_medium",
]

# archs whose long_500k cell is skipped: pure full-attention, O(S) KV at 512k
# with no sub-quadratic mechanism (DESIGN.md Sec. 4).
LONG_CONTEXT_SKIP = {
    "olmoe_1b_7b", "qwen2_vl_72b", "qwen2_5_14b", "phi3_mini_3_8b",
    "qwen3_4b", "musicgen_medium",
}


def get_arch(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def registry() -> dict[str, ArchConfig]:
    return {a: get_arch(a) for a in ARCH_IDS}


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells honoring long-context skips."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES.values():
            if (not include_skipped and s.kind == "long_decode"
                    and a in LONG_CONTEXT_SKIP):
                continue
            out.append((a, s.name))
    return out


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    return replace(
        cfg,
        n_layers=min(cfg.n_layers, 4 if cfg.layout == "hybrid" else 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256,
        vocab=256,
        n_experts=min(cfg.n_experts, 8) if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        expert_d_ff=64 if cfg.is_moe else None,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else None,
        local_global=(cfg.local_global[0], 16) if cfg.local_global else None,
        shared_attn_every=3 if cfg.shared_attn_every else 0,
        mrope_sections=(4, 6, 6) if cfg.mrope_sections else None,
        chunk=8,
    )
