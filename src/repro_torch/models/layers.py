"""Shared neural building blocks (torch twin of ``repro.models.layers``):
RMSNorm, interleaved-pair RoPE and multimodal RoPE (M-RoPE), the SwiGLU
and GELU MLPs, embedding lookups (whose gradient sums in a fixed order),
the token cross-entropy.

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
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=dev)
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


def repeat_heads(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``torch.repeat_interleave(x, n, dim)`` for an integer ``n``, as a
    broadcast and a copy: its gradient is a sum over the copies in a fixed
    order (torch lists ``repeat_interleave``'s backward on CUDA among its
    nondeterministic operations)."""
    if n == 1:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    shape.insert(dim + 1, n)
    return x.unsqueeze(dim + 1).expand(shape).flatten(dim, dim + 1)


def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """silu(x @ Wg) * (x @ Wu) @ Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """gelu(x @ Wu) @ Wd, the plain two-matrix FFN (musicgen), with the
    tanh approximation that ``jax.nn.gelu`` uses by default."""
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


class _Embed(torch.autograd.Function):
    """``table[tokens]`` whose gradient sums each table row's incoming
    rows one after another in token order (a stable sort, then
    ``segment_reduce``), on both devices: the same bits on every run.
    The plain index backward accumulates with parallel atomic adds on the
    CPU above 32768 elements (torch lists it as nondeterministic there)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1)
        gf = g.reshape(flat.shape[0], -1)
        order = torch.argsort(flat, stable=True)
        ids, counts = torch.unique_consecutive(flat[order],
                                               return_counts=True)
        sums = torch.segment_reduce(gf[order], "sum", lengths=counts,
                                    axis=0)
        grad = torch.zeros((ctx.rows, gf.shape[1]), dtype=g.dtype,
                           device=g.device)
        grad[ids] = sums
        return grad, None


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, d] at ``tokens``; differentiated in a fixed
    order when the table takes a gradient."""
    if table.requires_grad and torch.is_grad_enabled():
        return _Embed.apply(table, tokens)
    return table[tokens]


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, *,
            tied: bool) -> torch.Tensor:
    if tied:                               # table: [V, d]
        return x @ table_or_head.t()
    return x @ table_or_head


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          valid: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Mean token cross-entropy in float32 (logsumexp minus the label's
    logit); with the bool mask ``valid`` (labels' shape) the mean over the
    valid tokens (at least one in the denominator)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if valid is not None:
        v = valid.float()
        return (nll * v).sum() / torch.clamp(v.sum(), min=1.0)
    return nll.mean()
