"""AdamW with global-norm clipping (torch twin of ``repro.optim.adamw``).

Plain tensor functions in the JAX update's order of operations (not
``torch.optim.AdamW``, which rounds in another order): the gradients
scaled by ``min(1, clip / max(gnorm, 1e-9))``, the moments
``m * b1 + g * (1 - b1)`` and ``v * b2 + g**2 * (1 - b2)``, the bias
corrections of the incremented step, and weight decay inside the step,
``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``, all in float32.

The update works in place: the parameters and moments are overwritten
(one copy of each fits beside the gradients where two would not) and
returned.  The JAX module's bf16 moment compression (``compress_moments``,
which nothing there sets) and its ZeRO specs (``zero_spec(s)``, a
multi-device matter) are not ported.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the parameters' device
    m: Any                  # float32 tree shaped like the parameters
    v: Any


def init(params) -> AdamWState:
    """Step 0 and zero moments beside every parameter."""
    first = tree.leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
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
    are updated in place; ``lr`` is a float32 scalar tensor or a float."""
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
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(torch.square(g32) * (1 - b2))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        delta.add_(weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
