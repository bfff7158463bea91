"""Decoder pieces of the port (torch twin of ``repro.models.transformer``):
the dense parts the paged decode path needs, and the dense-cache
``prefill`` + ``decode_step`` of the ``mamba`` and ``hybrid`` layouts
(Mamba-2 layers on kernel K9, zamba2's shared attention block on K8).

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

from . import attention, layers, ssm


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Vocabulary rounded up to a multiple of ``multiple`` (the unembedding
    width; the padded columns are masked in ``logits_out``)."""
    return -(-vocab // multiple) * multiple


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.layout in ("mamba", "hybrid"):
        ok = not cfg.is_moe and (cfg.layout == "mamba"
                                 or cfg.mlp_kind == "swiglu")
    else:
        ok = cfg.layout == "attn" and not cfg.is_moe \
            and cfg.mlp_kind == "swiglu"
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense SwiGLU attention decoders, "
            f"Mamba-2 and Mamba-2 + shared-attention hybrids only "
            f"(layout={cfg.layout!r}, moe={cfg.is_moe}, "
            f"mlp={cfg.mlp_kind!r})")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: input_mode "
                                  f"{cfg.input_mode!r} is not ported")


def mamba_spec_of(cfg: ArchConfig) -> ssm.MambaSpec:
    return ssm.make_spec(cfg.d_model, expand=cfg.ssm_expand,
                         headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                         chunk=cfg.chunk)


def init_params(cfg: ArchConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = "cuda") -> dict:
    """Random weights with the JAX init scales (normal * d**-0.5, the
    down projection * d_ff**-0.5, norms at one, the Mamba-2 scales of
    ``ssm.init_mamba_params``), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  The draws differ from
    ``jax.random``'s; tests that compare the two packages carry the JAX
    weights over with ``params_from_jax`` instead.

    ``mamba``/``hybrid`` layers are ``{"ln", "mamba"}``; a hybrid model
    also has the one shared attention + SwiGLU block ``params["shared"]``
    (``ln1``, ``ln2``, ``attn``, ``mlp``) that runs every
    ``shared_attn_every`` layers."""
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

    def one_attn():
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
        return attn

    def one_mlp():
        return {"w_gate": normal((d, cfg.d_ff), s),
                "w_up": normal((d, cfg.d_ff), s),
                "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}

    layer_list = []
    if cfg.layout in ("mamba", "hybrid"):
        spec = mamba_spec_of(cfg)
        for _ in range(cfg.n_layers):
            layer_list.append({"ln": ln(), "mamba": ssm.init_mamba_params(
                spec, gen, dtype=dtype, device=dev)})
    else:
        for _ in range(cfg.n_layers):
            lp = {"ln1": ln(), "ln2": ln(), "attn": one_attn(),
                  "mlp": one_mlp()}
            if cfg.gemma_norm:
                lp["ln1_post"] = ln()
                lp["ln2_post"] = ln()
            layer_list.append(lp)
    params = {"layers": layer_list, "final_norm": ln()}
    if cfg.layout == "hybrid":
        params["shared"] = {"ln1": ln(), "ln2": ln(), "attn": one_attn(),
                            "mlp": one_mlp()}
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


# =============================================================================
# dense-cache generation: prefill, then one token per decode_step
# =============================================================================

def _check_dense_cache(cfg: ArchConfig) -> None:
    _check_supported(cfg)
    if cfg.layout not in ("mamba", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the dense-cache prefill/decode of the "
            f"{cfg.layout!r} layout is not ported (the paged engine "
            f"serves it)")


def _is_shared_site(cfg: ArchConfig, layer: int) -> bool:
    k = cfg.shared_attn_every
    return cfg.layout == "hybrid" and bool(k) and layer % k == k - 1


def init_decode_state(cfg: ArchConfig, batch_size: int, cache_len: int, *,
                      dtype: torch.dtype = torch.float32,
                      start_pos: int = 0,
                      device: str | torch.device | None = "cuda") -> dict:
    """Empty caches for ``cache_len`` tokens of context: per Mamba layer
    the SSM state h [B, H, N, P] (float32) and the raw conv context
    [B, d_conv-1, conv_ch]; per shared-attention site of a hybrid a dense
    K/V cache [B, cache_len, Hkv, Dh] with the position each slot holds
    (-1 = empty), written as a ring at ``position % cache_len``."""
    _check_dense_cache(cfg)
    dev = resolve_device(device)
    B = batch_size
    spec = mamba_spec_of(cfg)
    state: dict = {
        "positions": torch.full((B,), start_pos, dtype=torch.int32,
                                device=dev),
        "attn": [],
        "mamba": [{
            "h": torch.zeros((B, spec.n_heads, spec.d_state, spec.headdim),
                             dtype=torch.float32, device=dev),
            "conv": torch.zeros((B, spec.d_conv - 1, spec.conv_ch),
                                dtype=dtype, device=dev),
        } for _ in range(cfg.n_layers)],
    }
    n_sites = sum(_is_shared_site(cfg, l) for l in range(cfg.n_layers))
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    state["attn"] = [{
        "k": torch.zeros((B, cache_len, Hkv, Dh), dtype=dtype, device=dev),
        "v": torch.zeros((B, cache_len, Hkv, Dh), dtype=dtype, device=dev),
        "pos": torch.full((B, cache_len), -1, dtype=torch.int32,
                          device=dev),
    } for _ in range(n_sites)]
    return state


def _place(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """Write a prompt's last min(S, W) K/V rows into a cache of W slots at
    ``position % W``, in place."""
    S, W = k.shape[1], cache["k"].shape[1]
    n = min(S, W)
    pos = torch.arange(S - n, S, dtype=torch.int32, device=k.device)
    idx = pos.long() % W
    cache["k"][:, idx] = k[:, S - n:].to(cache["k"].dtype)
    cache["v"][:, idx] = v[:, S - n:].to(cache["v"].dtype)
    cache["pos"][:, idx] = pos
    return cache


def _conv_context(tail: torch.Tensor, spec: ssm.MambaSpec) -> torch.Tensor:
    """The raw conv context zero-padded on the left to d_conv-1 rows: a
    prompt shorter than that has the zero history the causal conv itself
    assumes (the JAX prefill keeps only the prompt's rows, and its decode
    then fails on the short window; ROADMAP C7)."""
    return torch.nn.functional.pad(
        tail, (0, 0, spec.d_conv - 1 - tail.shape[1], 0))


def _shared_mlp(sp: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    x = layers.rms_norm(h, sp["ln2"], eps=cfg.norm_eps)
    m = sp["mlp"]
    return h + layers.swiglu_mlp(x, m["w_gate"], m["w_up"], m["w_down"])


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int):
    """Run a batch of equal-length prompts tokens [B, S]; returns the
    last-token logits [B, 1, Vp] and the decode state (positions S).

    Every Mamba layer runs its chunked scan on K9 and keeps its final
    state and raw conv context; every shared-attention site of a hybrid
    attends causally on K8 and places its K/V in the site's cache."""
    _check_dense_cache(cfg)
    h = embed_in(params, cfg, tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    spec = mamba_spec_of(cfg)
    state = init_decode_state(cfg, B, cache_len, dtype=h.dtype,
                              start_pos=S, device=h.device)
    if cfg.layout == "hybrid":
        cos, sin = layers.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    ai = 0
    for l, lp in enumerate(params["layers"]):
        x = layers.rms_norm(h, lp["ln"], eps=cfg.norm_eps)
        out, (hs, tail) = ssm.mamba_forward(lp["mamba"], spec, x,
                                            return_state=True)
        h = h + out
        state["mamba"][l] = {"h": hs,
                             "conv": _conv_context(tail, spec).to(h.dtype)}
        if _is_shared_site(cfg, l):
            sp = params["shared"]
            x = layers.rms_norm(h, sp["ln1"], eps=cfg.norm_eps)
            out, (k, v) = attention.attention(sp["attn"], x, positions, cos,
                                              sin)
            h = _shared_mlp(sp, cfg, h + out)
            _place(state["attn"][ai], k, v)
            ai += 1
    h = layers.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    return logits_out(params, cfg, h[:, -1:, :]), state


def decode_step(params: dict, cfg: ArchConfig, state: dict,
                tokens: torch.Tensor):
    """One token per sequence, tokens [B, 1]: the O(1) Mamba-2 recurrence
    per layer and dense-cache attention at each shared site (plain torch;
    no kernel runs here).  Returns (logits [B, 1, Vp], the new state); the
    attention caches are updated in place and carried over."""
    _check_dense_cache(cfg)
    h = embed_in(params, cfg, tokens)
    pos = state["positions"]
    positions = pos[:, None]
    spec = mamba_spec_of(cfg)
    if cfg.layout == "hybrid":
        cos, sin = layers.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    new_attn = list(state["attn"])
    new_mamba = list(state["mamba"])
    ai = 0
    for l, lp in enumerate(params["layers"]):
        x = layers.rms_norm(h, lp["ln"], eps=cfg.norm_eps)
        st = state["mamba"][l]
        out, hs, cs = ssm.mamba_decode_step(lp["mamba"], spec, x, st["h"],
                                            st["conv"])
        h = h + out
        new_mamba[l] = {"h": hs, "conv": cs}
        if _is_shared_site(cfg, l):
            sp = params["shared"]
            x = layers.rms_norm(h, sp["ln1"], eps=cfg.norm_eps)
            c = state["attn"][ai]
            out, kc, vc, pc = attention.decode_attention(
                sp["attn"], x, c["k"], c["v"], c["pos"], positions, cos, sin)
            h = _shared_mlp(sp, cfg, h + out)
            new_attn[ai] = {"k": kc, "v": vc, "pos": pc}
            ai += 1
    h = layers.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    logits = logits_out(params, cfg, h)
    return logits, {"positions": pos + 1, "attn": new_attn,
                    "mamba": new_mamba}
