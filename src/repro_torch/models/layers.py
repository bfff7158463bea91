"""Shared neural building blocks (torch twin of ``repro.models.layers``):
RMSNorm, interleaved-pair RoPE and multimodal RoPE (M-RoPE), the SwiGLU
and GELU MLPs, embedding lookups.

Same conventions as the JAX module: plain functions over explicit
tensors; RoPE rotates pairs (2i, 2i+1) with angles computed in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             gemma_style: bool = False) -> torch.Tensor:
    """RMSNorm in float32; gemma_style multiplies by (1 + scale)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + scale.float()) if gemma_style else scale.float()
    return (x * w).to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., S, head_dim/2] for integer positions [..., S]."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freq
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, ...]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (Qwen2-VL): the head_dim/2 frequency slots split
    into ``sections`` (temporal, height, width), each rotated by its own
    position stream.  positions [..., S, n_sections] integers (equal
    streams give plain RoPE); cos/sin [..., S, head_dim/2]."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope_angles: sections {sections} do not sum "
                         f"to head_dim/2 = {half}")
    dev = positions.device
    exps = torch.arange(half, dtype=torch.float32, device=dev) / half
    freq = 1.0 / (theta ** exps)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=dev),
        torch.tensor(sections, device=dev))
    ang = positions[..., sec_id].float() * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Interleaved-pair rotation.  x: [..., S, H, D]; cos/sin [..., S, D/2]
    (broadcast over heads) or already head-shaped."""
    orig = x.dtype
    x = x.float()
    xe = x[..., 0::2]
    xo = x[..., 1::2]
    if cos.dim() == x.dim() - 1:          # add the head axis
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    ye = xe * cos - xo * sin
    yo = xe * sin + xo * cos
    return torch.stack([ye, yo], dim=-1).reshape(x.shape).to(orig)


def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """silu(x @ Wg) * (x @ Wu) @ Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """gelu(x @ Wu) @ Wd, the plain two-matrix FFN (musicgen), with the
    tanh approximation that ``jax.nn.gelu`` uses by default."""
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, *,
            tied: bool) -> torch.Tensor:
    if tied:                               # table: [V, d]
        return x @ table_or_head.t()
    return x @ table_or_head
