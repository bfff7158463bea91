"""Dense decoder pieces the paged decode path needs (torch twin of the
dense parts of ``repro.models.transformer``).

Parameters are a plain dict with the JAX package's leaf names and
layouts, except that the per-layer tree is a *list* of dicts
(``params["layers"][l]``) instead of arrays stacked on a leading layer
axis.  ``repro_torch.convert.params_from_jax`` maps a JAX tree onto this
form; ``init_params`` draws one directly on the device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from . import layers


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Vocabulary rounded up to a multiple of ``multiple`` (the unembedding
    width; the padded columns are masked in ``logits_out``)."""
    return -(-vocab // multiple) * multiple


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.layout != "attn" or cfg.is_moe or cfg.mlp_kind != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense SwiGLU attention "
            f"decoders only (layout={cfg.layout!r}, moe={cfg.is_moe}, "
            f"mlp={cfg.mlp_kind!r})")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: input_mode "
                                  f"{cfg.input_mode!r} is not ported")


def init_params(cfg: ArchConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = "cuda") -> dict:
    """Random weights with the JAX init scales (normal * d**-0.5, the
    down projection * d_ff**-0.5, norms at one), drawn on ``device`` from
    a ``torch.Generator`` seeded with ``seed``.  The draws differ from
    ``jax.random``'s; tests that compare the two packages carry the JAX
    weights over with ``params_from_jax`` instead."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, dh = cfg.d_model, cfg.head_dim
    vp = pad_vocab(cfg.vocab)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return w.mul_(std).to(dtype)

    def ln():
        return (torch.zeros if cfg.gemma_norm else torch.ones)(
            (d,), dtype=dtype, device=dev)

    s = d ** -0.5
    layer_list = []
    for _ in range(cfg.n_layers):
        attn = {"wq": normal((d, cfg.n_heads, dh), s),
                "wk": normal((d, cfg.n_kv_heads, dh), s),
                "wv": normal((d, cfg.n_kv_heads, dh), s),
                "wo": normal((cfg.n_heads, dh, d), s)}
        if cfg.qkv_bias:
            for k, h in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                         ("bv", cfg.n_kv_heads)):
                attn[k] = torch.zeros((h, dh), dtype=dtype, device=dev)
        if cfg.qk_norm:
            attn["q_norm"] = torch.ones((dh,), dtype=dtype, device=dev)
            attn["k_norm"] = torch.ones((dh,), dtype=dtype, device=dev)
        lp = {"ln1": ln(), "ln2": ln(), "attn": attn,
              "mlp": {"w_gate": normal((d, cfg.d_ff), s),
                      "w_up": normal((d, cfg.d_ff), s),
                      "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}}
        if cfg.gemma_norm:
            lp["ln1_post"] = ln()
            lp["ln2_post"] = ln()
        layer_list.append(lp)
    params = {"layers": layer_list, "final_norm": ln()}
    if cfg.tie_embeddings:
        params["embed"] = normal((cfg.vocab, d), s)
    else:
        params["embed"] = normal((vp, d), s)
        params["lm_head"] = normal((d, vp), s)
    return params


def embed_in(params: dict, cfg: ArchConfig, tokens: torch.Tensor
             ) -> torch.Tensor:
    """tokens [B, S] -> hidden [B, S, d]."""
    h = layers.embed(tokens, params["embed"])
    if cfg.scale_embed:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def logits_out(params: dict, cfg: ArchConfig, h: torch.Tensor
               ) -> torch.Tensor:
    """hidden [B, S, d] -> logits [B, S, Vp] with the padded vocabulary
    columns masked to -1e9."""
    logits = layers.unembed(
        h, params["embed"] if cfg.tie_embeddings else params["lm_head"],
        tied=cfg.tie_embeddings)
    vp = logits.shape[-1]
    if vp != cfg.vocab:
        logits[..., cfg.vocab:] = -1e9
    return logits


def ffn_block(lp: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Pre-norm SwiGLU block with the optional gemma post-norm:
    h + mlp(rms_norm(h))."""
    x = layers.rms_norm(h, lp["ln2"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    m = lp["mlp"]
    y = layers.swiglu_mlp(x, m["w_gate"], m["w_up"], m["w_down"])
    if cfg.gemma_norm:
        y = layers.rms_norm(y, lp["ln2_post"], eps=cfg.norm_eps,
                            gemma_style=True)
    return h + y
