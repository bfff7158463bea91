"""AdamW with global-norm clipping (torch twin of ``repro.optim.adamw``).

Plain tensor functions in the JAX update's order of operations (not
``torch.optim.AdamW``, which rounds in another order): the gradients
scaled by ``min(1, clip / max(gnorm, 1e-9))``, the moments
``m * b1 + g * (1 - b1)`` and ``v * b2 + g**2 * (1 - b2)``, the bias
corrections of the incremented step, and weight decay inside the step,
``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``, all in float32.

The update works in place: the parameters and moments are overwritten
(one copy of each fits beside the gradients where two would not) and
returned.  ``init(..., compress_moments=True)`` keeps the moments in
bf16, as the JAX module's does: each update reads them into float32,
updates them there and stores them back rounded to bf16.

Over a mesh the parameters, gradients and moments are DTensors and the
same functions run on them: the global norm sums every shard's squares
and the clip acts on the replicated result.  ZeRO (``zero_spec(s)``):
the moments and the float32 gradient sums take the parameter's spec
with one more, unsharded and divisible, dim split over the data axes
(the first such dim); a spec is a tuple as in ``parallel.sharding``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the parameters' device
    m: Any                  # float32 (or bf16) tree shaped like the params
    v: Any


def init(params, *, compress_moments: bool = False) -> AdamWState:
    """Step 0 and zero moments beside every parameter (DTensor parameters
    get DTensor moments in their layout): float32, or bf16 with
    ``compress_moments``."""
    first = tree.leaves(params)[0]
    dt = torch.bfloat16 if compress_moments else torch.float32
    zeros = lambda p: torch.zeros_like(p, dtype=dt)   # DTensors stay laid out
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree.map_leaves(zeros, params),
                      v=tree.map_leaves(zeros, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares
    (float32)."""
    total = None
    for g in tree.leaves(grads):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           clip_norm: float | None = 1.0):
    """One AdamW step; returns (params, new state, {"grad_norm"}).
    ``params``, the moments and ``grads`` (which are scaled by the clip)
    are updated in place; ``lr`` is a float32 scalar tensor or a float.
    bf16 moments are updated in float32 and stored back in bf16."""
    g_leaves = tree.leaves(grads)
    gnorm = global_norm(grads)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        for g in g_leaves:
            g.mul_(scale.to(g.dtype))

    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    for p, g, m, v in zip(tree.leaves(params), g_leaves,
                          tree.leaves(state.m), tree.leaves(state.v)):
        g32 = g.float()
        m32, v32 = m.float(), v.float()     # the moments themselves if f32
        m32.mul_(b1).add_(g32 * (1 - b1))
        v32.mul_(b2).add_(torch.square(g32) * (1 - b2))
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        delta.add_(weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}


# --- ZeRO state specs -----------------------------------------------------------

def zero_spec(shape: tuple[int, ...], pspec: tuple, dp_axes: tuple[str, ...],
              n_data: int) -> tuple:
    """``pspec`` with its first unsharded dim that ``n_data`` divides
    split over the data axes (one axis name, or the tuple of them);
    unchanged where no dim qualifies."""
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and dim % n_data == 0 and dim > 0:
            entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            break
    return tuple(entries)


def zero_specs(param_shapes, param_specs, dp_axes: tuple[str, ...],
               n_data: int):
    """``zero_spec`` of every leaf: ``param_shapes`` a tree of shapes (or
    tensors) beside its tree of specs."""
    from repro_torch.parallel.sharding import map_with_specs
    return map_with_specs(
        lambda s, p: zero_spec(tuple(s.shape if hasattr(s, "shape") else s),
                               p, dp_axes, n_data),
        param_shapes, param_specs)
