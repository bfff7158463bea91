"""Mixture-of-experts FFN (torch twin of ``repro.models.moe``): top-k
routing and the sort-based grouped SwiGLU on kernel ``moe_ffn``, on one
device (``moe_sorted_local``) or over a mesh (``moe_apply``'s expert- and
tensor-parallel branches).

The router's per-expert counts are the paper's bank-utilization
histogram (Algorithm 1): the serving engine accumulates them as its
expert hotness.  The parameters are a dict with the JAX ``MoEParams``
leaves: ``w_router [d, E]``, ``w_gate``/``w_up [E, d, ff]``,
``w_down [E, ff, d]``.

Nothing here reads a tensor on the host: the sort, the group offsets,
the kernels and the combine all stay on the device, so a decode step
issues its MoE layers without a sync, and a training step's backward
runs ``moe_ffn``'s hand-written gradient (``moe_ffn_backward``) the same
way.  The load-balancing loss is ``aux_load_balance_loss``.

Over a mesh, JAX's ``shard_map`` bodies are split at their collective:
``ep_shard_partial`` and ``tp_shard_partial`` compute one shard's
float32 partial output from local tensors (so the partials of all the
shards can also run one after another on one card), and ``moe_apply``
sums them over ``model`` (the ``psum``) as a DTensor reduction.
"""
from __future__ import annotations

from typing import NamedTuple

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


def _slot_sum(rows: torch.Tensor, inv: torch.Tensor, top_k: int,
              pad: bool = False) -> torch.Tensor:
    """rows [T * k, d] in sorted order back to token order, each token's k
    slots (slot j at sorted row inv[t * k + j]) summed one after another:
    a fixed order whatever the batch, no atomics.  With ``pad`` a zero
    row is appended first, and a slot whose ``inv`` is ``len(rows)`` adds
    an exact zero (the expert-parallel slots of other shards and the ones
    past the capacity)."""
    if pad:
        rows = torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])
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
    def forward(ctx, x, tok, inv, top_k, pad=False):
        ctx.save_for_backward(inv)
        ctx.top_k = top_k
        ctx.pad = pad
        return x[tok]

    @staticmethod
    def backward(ctx, dxg):
        inv, = ctx.saved_tensors
        return (_slot_sum(dxg, inv, ctx.top_k, ctx.pad), None, None, None,
                None)


class _GroupedFFN(torch.autograd.Function):
    """``moe_ffn`` under autograd: the forward is ``moe_ffn_train``
    (``moe_ffn``'s launches and bits, the gate and up products g and u
    kept beside h), the backward ``moe_ffn_backward``'s kernels from that
    g, u and h (plain versions on the CPU), float32 or bfloat16.  Under
    ``cfg.remat`` (non-reentrant checkpointing) the first forward's saved
    tensors are dropped and the recompute's kept, one layer at a time."""

    @staticmethod
    def forward(ctx, xg, offs, w_gate, w_up, w_down, gate):
        y, g, u, h = moe_ffn_train(xg, offs, w_gate, w_up, w_down, gate)
        ctx.save_for_backward(xg, offs, w_gate, w_up, w_down, gate, g, u, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        xg, offs, w_gate, w_up, w_down, gate, *guh = ctx.saved_tensors
        dxg, dwg, dwu, dwd, dgate = moe_ffn_backward(
            dy, xg, offs, w_gate, w_up, w_down, gate, *guh)
        return dxg, None, dwg, dwu, dwd, dgate


def _sorted_rows(x_flat, w, idx, counts, p: dict, top_k: int):
    """Every one of the T * k slots, stably sorted by expert, through
    ``moe_ffn`` with its gate weight (under autograd, ``_GatherRows`` and
    ``_GroupedFFN``, where a gradient is wanted), then summed back per
    token in slot order: (out [T, d] float32, order, int32 group offsets
    from ``counts``)."""
    order = torch.argsort(idx.reshape(-1), stable=True)
    tok = order // top_k
    # slot j of token t sits at sorted row inv[t * k + j]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    offs = torch.zeros(counts.numel() + 1, dtype=torch.int32,
                       device=x_flat.device)
    offs[1:] = torch.cumsum(counts, dim=0)
    gate = w.reshape(-1)[order].contiguous()
    ws = (p["w_gate"], p["w_up"], p["w_down"])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_flat, gate, *ws)):
        xg = _GatherRows.apply(x_flat, tok, inv, top_k)
        y = _GroupedFFN.apply(xg, offs, *ws, gate)
    else:
        y = moe_ffn(x_flat[tok], offs, *ws, gate)
    return _slot_sum(y, inv, top_k), order, offs


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
    w, idx, probs, counts = route(x_flat, p["w_router"], top_k,
                                  softmax_before_topk=softmax_before_topk)
    out = _sorted_rows(x_flat, w, idx, counts, p, top_k)[0]
    return out.to(x_flat.dtype), probs, idx, counts


# =============================================================================
# expert and tensor parallelism: one shard's partial, then the psum
# =============================================================================

class ShardPartial(NamedTuple):
    """One shard's part of the MoE FFN: ``out`` its float32 partial
    output [T, d] (the shards' ``out`` sum to the layer's output),
    ``probs``, ``idx`` and ``counts`` of the routing (equal on every
    shard of a data group), and the layout of its grouped rows:
    ``order`` (the sorted slots it computes), ``valid`` (which of them
    are its own) and ``offs`` (int32 group offsets over its experts)."""
    out: torch.Tensor
    probs: torch.Tensor
    idx: torch.Tensor
    counts: torch.Tensor
    order: torch.Tensor
    valid: torch.Tensor
    offs: torch.Tensor


def ep_capacity(t_local: int, top_k: int, n_ep: int,
                capacity_factor: float) -> int:
    """Rows one expert-parallel shard computes: the GShard capacity
    ``int(T * k / n_ep * factor)`` rounded up to a multiple of 8, at
    least 8 and at most all ``T * k`` slots."""
    c = int(t_local * top_k / n_ep * capacity_factor)
    c = max(8, -(-c // 8) * 8)
    return min(c, t_local * top_k)


def _histogram(keys: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [n] counts of the integer ``keys`` (a comparison summed: no
    host read)."""
    hit = keys[:, None] == torch.arange(n, device=keys.device)
    return hit.sum(dim=0, dtype=torch.int32)


def ep_layout(idx: torch.Tensor, shard: int, e_local: int, capacity: int):
    """Where expert-parallel shard ``shard`` puts the top-k choices idx
    [T, k]: (order, valid, offs, inv).  A stable sort puts the shard's
    slots first (by local expert, then slot) and keeps the first
    ``capacity``: ``order`` the slots kept, ``valid`` which of them are
    the shard's, ``offs`` int32 [e_local + 1] group offsets with the
    invalid tail in the last group, ``inv`` [T * k] the kept row of each
    slot, or ``capacity`` (a zero row) where the slot is another shard's
    or was dropped."""
    local_e = idx.reshape(-1) - shard * e_local
    mine = (local_e >= 0) & (local_e < e_local)
    key = torch.where(mine, local_e, torch.full_like(local_e, e_local))
    order = torch.argsort(key, stable=True)[:capacity]
    valid = key[order] < e_local
    cnt = _histogram(key[order], e_local + 1)
    offs = torch.zeros(e_local + 1, dtype=torch.int32, device=idx.device)
    offs[1:] = torch.cumsum(cnt[:e_local], dim=0)
    offs[-1] += cnt[e_local]                # the invalid tail, last group
    rows = torch.arange(order.numel(), device=order.device)
    inv = torch.full((local_e.numel(),), capacity, dtype=order.dtype,
                     device=order.device)
    inv.scatter_(0, order, torch.where(valid, rows,
                                       torch.full_like(rows, capacity)))
    return order, valid, offs, inv


def _ep_rows(x_flat, w, idx, p: dict, top_k: int, shard: int,
             capacity: int):
    """The expert-parallel rows of shard ``shard`` from the routing
    (gate weights w and choices idx [T, k]): (out [T, d] float32, order,
    valid, offs)."""
    order, valid, offs, inv = ep_layout(idx, shard, p["w_gate"].shape[0],
                                        capacity)
    tok = order // top_k
    gate = (w.reshape(-1)[order] * valid).contiguous()
    ws = (p["w_gate"], p["w_up"], p["w_down"])
    keep = valid[:, None].to(x_flat.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_flat, gate, *ws)):
        xg = _GatherRows.apply(x_flat, tok, inv, top_k, True) * keep
        y = _GroupedFFN.apply(xg, offs, *ws, gate)
    else:
        y = moe_ffn(x_flat[tok] * keep, offs, *ws, gate)
    return _slot_sum(y, inv, top_k, pad=True), order, valid, offs


def ep_shard_partial(x_flat: torch.Tensor, p: dict, top_k: int, shard: int,
                     n_ep: int, capacity: int, *,
                     softmax_before_topk: bool = True) -> ShardPartial:
    """The expert-parallel body of shard ``shard`` of ``n_ep`` on local
    tensors (JAX ``_ep_shard_body`` up to its ``psum``): x_flat [T, d] is
    the data group's tokens, ``p`` holds the full router and this
    shard's ``E / n_ep`` experts.  Every token is routed; a stable sort
    puts this shard's slots first (by local expert, then slot) and the
    first ``capacity`` sorted slots are computed.  Slots of other shards
    inside the capacity are ``valid`` false: their rows are zeroed,
    their gate weight is 0 and they ride in the last local group.  A slot
    that is not this shard's, or was dropped past the capacity, adds an
    exact zero to its token's sum."""
    if p["w_gate"].shape[0] * n_ep != p["w_router"].shape[1]:
        raise ValueError(f"ep_shard_partial: {p['w_gate'].shape[0]} local "
                         f"experts x {n_ep} shards != "
                         f"{p['w_router'].shape[1]} experts")
    w, idx, probs, counts = route(x_flat, p["w_router"], top_k,
                                  softmax_before_topk=softmax_before_topk)
    out, order, valid, offs = _ep_rows(x_flat, w, idx, p, top_k, shard,
                                       capacity)
    return ShardPartial(out, probs, idx, counts, order, valid, offs)


def tp_shard_partial(x_flat: torch.Tensor, p: dict, top_k: int, *,
                     softmax_before_topk: bool = True) -> ShardPartial:
    """The tensor-parallel body on local tensors (JAX ``_tp_shard_body``
    up to its ``psum``): ``p`` holds every expert with this shard's d_ff
    slice."""
    w, idx, probs, counts = route(x_flat, p["w_router"], top_k,
                                  softmax_before_topk=softmax_before_topk)
    out, order, offs = _sorted_rows(x_flat, w, idx, counts, p, top_k)
    # JAX casts the partial to x's type before its psum
    return ShardPartial(out.to(x_flat.dtype).float(), probs, idx, counts,
                        order, torch.ones_like(order, dtype=torch.bool),
                        offs)


def use_ep(n_experts: int, n_model: int) -> bool:
    """Expert parallelism where the experts divide the model axis, else
    tensor parallelism over d_ff."""
    return n_experts >= n_model and n_experts % n_model == 0


def moe_apply(x, p: dict, *, top_k: int, mi, capacity_factor: float = 1.25,
              softmax_before_topk: bool = True):
    """The MoE FFN of x [B, S, d] over ``mi``'s mesh (JAX ``moe_apply``
    with a mesh): x and the weights are DTensors, the weights laid out by
    ``parallel.sharding.param_specs``.  The tokens are split over the
    data axes (replicated there when B * S does not divide by their size,
    as a long-context decode's) and gathered over ``model``.  Routing
    runs on the DTensors; each rank then runs its shard's rows on local
    tensors, and the float32 partials are summed over ``model`` (JAX's
    ``psum``).  The local gradients of x, of the gate weights and of
    weights replicated over the data axes are partial sums, and are
    declared so.  Returns (y [B, S, d], probs [B * S, E], idx
    [B * S, k]) as DTensors and counts [E] summed over the data axes, a
    plain int32 tensor equal on every rank.  It runs, and a backward
    through it, under DTensor's ``implicit_replication`` (plain tensors
    taken as replicated), which the caller opens (``make_train_step``
    does; the context does not nest)."""
    from repro_torch.parallel.sharding import (constrain, grad_as, local,
                                               psum)
    B, S, d = x.shape
    E = p["w_router"].shape[1]
    dp_replicated = (B * S) % mi.n_data != 0
    dp = None if dp_replicated else mi.dp_axes
    xf = constrain(x, mi, (dp, None, None)).reshape(B * S, d)
    xf = grad_as(xf, xf.placements)
    w, idx, probs, counts = route(xf, p["w_router"], top_k,
                                  softmax_before_topk=softmax_before_topk)

    xl = local(xf, mi, (mi.model_axis,))
    wl = local(w, mi, (mi.model_axis,))
    wdp = () if dp_replicated else mi.dp_axes
    ws = {k: local(p[k], mi, wdp) for k in ("w_gate", "w_up", "w_down")}
    if use_ep(E, mi.n_model):
        n_ep = mi.n_model
        out = _ep_rows(xl, wl, idx.to_local(), ws, top_k,
                       mi.mesh.get_local_rank(mi.model_axis),
                       ep_capacity(xl.shape[0], top_k, n_ep,
                                   capacity_factor))[0]
    else:
        il = idx.to_local()
        out = _sorted_rows(xl, wl, il, _histogram(il.reshape(-1), E), ws,
                           top_k)[0].to(x.dtype).float()
    y = psum(out, mi, xf).to(x.dtype)
    return y.reshape(B, S, d), probs, idx, counts.full_tensor()
