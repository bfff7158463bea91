"""Mixture-of-experts FFN (torch twin of ``repro.models.moe``, its
single-device path): top-k routing and the sort-based grouped SwiGLU on
kernel ``moe_ffn``.

The router's per-expert counts are the paper's bank-utilization
histogram (Algorithm 1): the serving engine accumulates them as its
expert hotness.  The parameters are a dict with the JAX ``MoEParams``
leaves: ``w_router [d, E]``, ``w_gate``/``w_up [E, d, ff]``,
``w_down [E, ff, d]``.

Nothing here reads a tensor on the host: the sort, the group offsets,
the kernels and the combine all stay on the device, so a decode step
issues its MoE layers without a sync, and a training step's backward
runs ``moe_ffn``'s hand-written gradient (``moe_ffn_backward``) the same
way.  The load-balancing loss is ``aux_load_balance_loss``.  Expert- and
tensor-parallel bodies belong to training on several cards and are not
ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_ffn import (moe_ffn, moe_ffn_backward,
                                         moe_ffn_train)


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


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss of router probs [T, E] and top-k
    choices idx [T, k]: E * sum_e f_e * mean_t probs[t, e], with f_e the
    share of the T * k choices that went to expert e (from the integer
    counts, so only the mean of the probs carries a gradient)."""
    T = probs.shape[0]
    f = expert_counts(idx, n_experts).float() / max(T * idx.shape[-1], 1)
    return n_experts * torch.sum(f * probs.mean(dim=0))


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


def _slot_sum(rows: torch.Tensor, inv: torch.Tensor, top_k: int
              ) -> torch.Tensor:
    """rows [T * k, d] in sorted order back to token order, each token's k
    slots (slot j at sorted row inv[t * k + j]) summed one after another:
    a fixed order whatever the batch, no atomics."""
    ys = rows[inv].reshape(inv.numel() // top_k, top_k, rows.shape[-1])
    out = ys[:, 0]
    for j in range(1, top_k):
        out = out + ys[:, j]
    return out


class _GatherRows(torch.autograd.Function):
    """xg = x[tok]: each token's row once per slot, in sorted order.  Its
    backward sums a token's k slot gradients in slot order
    (``_slot_sum``), where torch's index backward would add them with
    atomics on the card, in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, x, tok, inv, top_k):
        ctx.save_for_backward(inv)
        ctx.top_k = top_k
        return x[tok]

    @staticmethod
    def backward(ctx, dxg):
        inv, = ctx.saved_tensors
        return _slot_sum(dxg, inv, ctx.top_k), None, None, None


class _GroupedFFN(torch.autograd.Function):
    """``moe_ffn`` under autograd: the float32 forward is
    ``moe_ffn_train`` (``moe_ffn``'s launches and bits, the gate and up
    products g and u kept beside h), the backward ``moe_ffn_backward``'s
    kernels from that g, u and h (plain versions on the CPU).  Under
    ``cfg.remat`` (non-reentrant checkpointing) the first forward's saved
    tensors are dropped and the recompute's kept, one layer at a time.
    Other types keep ``moe_ffn`` and save no g, u, h: their backward
    raises (ROADMAP A2)."""

    @staticmethod
    def forward(ctx, xg, offs, w_gate, w_up, w_down, gate):
        if xg.dtype == torch.float32:
            y, g, u, h = moe_ffn_train(xg, offs, w_gate, w_up, w_down, gate)
            ctx.save_for_backward(xg, offs, w_gate, w_up, w_down, gate,
                                  g, u, h)
            return y
        ctx.save_for_backward(xg, offs, w_gate, w_up, w_down, gate)
        return moe_ffn(xg, offs, w_gate, w_up, w_down, gate)

    @staticmethod
    def backward(ctx, dy):
        xg, offs, w_gate, w_up, w_down, gate, *guh = ctx.saved_tensors
        dxg, dwg, dwu, dwd, dgate = moe_ffn_backward(
            dy, xg, offs, w_gate, w_up, w_down, gate, *guh)
        return dxg, None, dwg, dwu, dwd, dgate


def moe_sorted_local(x_flat: torch.Tensor, p: dict, top_k: int, *,
                     softmax_before_topk: bool = True):
    """Sort-based MoE over all experts (no dropping) of x_flat [T, d]:
    route, stable sort of the T*k choices by expert, the grouped SwiGLU
    with its gate weights on ``moe_ffn``, then each token's k outputs
    summed in slot order in float32 and cast to x's type.  Returns
    (out [T, d], probs, idx, counts).

    JAX combines with ``.at[tok].add`` in sorted order; the port adds a
    token's k slots one after another, a fixed order whatever the batch
    (no atomics), so the sums agree within float tolerance.  With grad
    enabled and an input that requires it, the gather and ``moe_ffn`` run
    under autograd (``_GatherRows``, ``_GroupedFFN``); otherwise, as in
    serving, they are the plain gather and the kernel's two launches."""
    E = p["w_router"].shape[1]
    w, idx, probs, counts = route(x_flat, p["w_router"], top_k,
                                  softmax_before_topk=softmax_before_topk)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    tok = order // top_k
    # slot j of token t sits at sorted row inv[t * k + j]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    offs = torch.zeros(E + 1, dtype=torch.int32, device=x_flat.device)
    offs[1:] = torch.cumsum(counts, dim=0)
    gate = w.reshape(-1)[order].contiguous()
    ws = (p["w_gate"], p["w_up"], p["w_down"])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_flat, gate, *ws)):
        xg = _GatherRows.apply(x_flat, tok, inv, top_k)
        y = _GroupedFFN.apply(xg, offs, *ws, gate)
    else:
        y = moe_ffn(x_flat[tok], offs, *ws, gate)
    return _slot_sum(y, inv, top_k).to(x_flat.dtype), probs, idx, counts
