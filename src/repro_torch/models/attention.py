"""Decode-time attention projections (torch twin of
``repro.models.attention.project_qkv``).

Weights keep the JAX layout: wq [d, Hq, Dh], wk/wv [d, Hkv, Dh],
wo [Hq, Dh, d]; each projection is one ``torch.matmul`` over the
flattened head axes.
"""
from __future__ import annotations

import torch

from . import layers


def project_qkv(p: dict, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor):
    """Project + (optional bias, qk-norm) + RoPE.  x: [B, S, d] ->
    q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh]."""
    B, S, d = x.shape

    def proj(w):
        return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if p.get("bq") is not None:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if p.get("q_norm") is not None:
        q = layers.rms_norm(q, p["q_norm"])
        k = layers.rms_norm(k, p["k_norm"])
    q = layers.apply_rope(q, cos, sin)
    k = layers.apply_rope(k, cos, sin)
    return q, k, v
