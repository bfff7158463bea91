"""Mixture-of-experts FFN (torch twin of ``repro.models.moe``, its
single-device path): top-k routing and the sort-based grouped SwiGLU on
kernel ``moe_ffn``.

The router's per-expert counts are the paper's bank-utilization
histogram (Algorithm 1): the serving engine accumulates them as its
expert hotness.  The parameters are a dict with the JAX ``MoEParams``
leaves: ``w_router [d, E]``, ``w_gate``/``w_up [E, d, ff]``,
``w_down [E, ff, d]``.

Nothing here reads a tensor on the host: the sort, the group offsets,
the kernel and the combine all stay on the device, so a decode step
issues its MoE layers without a sync.  Expert- and tensor-parallel
bodies and the load-balancing loss belong to training on several cards
and are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_ffn import moe_ffn


def init_moe_params(gen: torch.Generator, d_model: int, n_experts: int,
                    d_ff: int, *, dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> dict:
    """Random expert weights with the JAX scales: all four leaves normal
    * d_model**-0.5 (``w_down`` too), drawn on ``device``."""
    s = d_model ** -0.5

    def normal(shape):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(s).to(dtype)
    return {"w_router": normal((d_model, n_experts)),
            "w_gate": normal((n_experts, d_model, d_ff)),
            "w_up": normal((n_experts, d_model, d_ff)),
            "w_down": normal((n_experts, d_ff, d_model))}


def _router_logits(x_flat: torch.Tensor, w_router: torch.Tensor
                   ) -> torch.Tensor:
    """x.float() @ w_router.float() in full float32, TF32 off whatever the
    caller set: a router product in TF32 would pick other experts on the
    card than the JAX package does on the CPU."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x_flat.float() @ w_router.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def expert_counts(idx: torch.Tensor, n_experts: int,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """The expert histogram of top-k choices idx [T, k]: int32 [E], with
    only the rows where ``valid`` [T] is true counted.  A comparison
    against every expert id, summed: exact, and no host read."""
    hit = idx[..., None] == torch.arange(n_experts, device=idx.device)
    if valid is not None:
        hit = hit & valid.reshape(-1, 1, 1)
    return hit.sum(dim=(0, 1), dtype=torch.int32)


def route(x_flat: torch.Tensor, w_router: torch.Tensor, top_k: int, *,
          softmax_before_topk: bool = True):
    """Top-k routing of x_flat [T, d].  Returns (weights [T, k] float32,
    idx [T, k] int64, probs [T, E] float32, counts [E] int32).

    olmoe (``softmax_before_topk``) takes the top k of the softmax;
    mixtral the top k of the logits, then a softmax over those k.  The k
    weights are always renormalized to sum to one.  Rows
    whose logits tie (all-zero padding rows) may order their experts
    otherwise than ``lax.top_k``; only their discarded outputs depend on
    it."""
    logits = _router_logits(x_flat, w_router)
    probs = torch.softmax(logits, dim=-1)
    if softmax_before_topk:
        w, idx = torch.topk(probs, top_k, dim=-1)
    else:
        top_logits, idx = torch.topk(logits, top_k, dim=-1)
        w = torch.softmax(top_logits, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, idx, probs, expert_counts(idx, w_router.shape[1])


def moe_sorted_local(x_flat: torch.Tensor, p: dict, top_k: int, *,
                     softmax_before_topk: bool = True):
    """Sort-based MoE over all experts (no dropping) of x_flat [T, d]:
    route, stable sort of the T*k choices by expert, the grouped SwiGLU
    with its gate weights on ``moe_ffn``, then each token's k outputs
    summed in slot order in float32 and cast to x's type.  Returns
    (out [T, d], probs, idx, counts).

    JAX combines with ``.at[tok].add`` in sorted order; the port adds a
    token's k slots one after another, a fixed order whatever the batch
    (no atomics), so the sums agree within float tolerance."""
    T, d = x_flat.shape
    E = p["w_router"].shape[1]
    w, idx, probs, counts = route(x_flat, p["w_router"], top_k,
                                  softmax_before_topk=softmax_before_topk)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xg = x_flat[order // top_k]
    offs = torch.zeros(E + 1, dtype=torch.int32, device=x_flat.device)
    offs[1:] = torch.cumsum(counts, dim=0)
    y = moe_ffn(xg, offs, p["w_gate"], p["w_up"], p["w_down"],
                w.reshape(-1)[order].contiguous())
    # back to token-major order: slot j of token t sits at sorted row
    # inv[t * k + j]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    ys = y[inv].reshape(T, top_k, d)
    out = ys[:, 0]
    for j in range(1, top_k):
        out = out + ys[:, j]
    return out.to(x_flat.dtype), probs, idx, counts
