"""Decoder pieces of the port (torch twin of ``repro.models.transformer``):
the dense and MoE parts the paged decode path needs (the MoE FFN on
kernel ``moe_ffn``), and the dense-cache ``prefill`` + ``decode_step``
of every layout: ``attn`` (full-length caches, sliding-window ring
buffers, int8 caches with per-head scales; prompt attention on K8),
``mamba`` and ``hybrid`` (Mamba-2 layers on kernel K9, zamba2's shared
attention block on K8).  An ``attn`` model's FFN is SwiGLU, MoE or a
GELU MLP (musicgen); an ``input_mode="embeds"`` model (musicgen,
qwen2_vl, whose frontends are stubbed as in the JAX package) takes
``embeds=`` [B, S, d] in place of token ids, and qwen2_vl's text-only
M-RoPE (all three position streams equal) is its rotary table.  The
training forward (``forward_hidden``, ``loss_fn``) of every arch runs
the plain attention and SSD scan under autograd; with a mesh
(``mi``) it runs on DTensors, the activations laid out by
``parallel.sharding.act_spec`` between blocks, attention and the Mamba-2
block on each rank's shards, the MoE FFN on ``moe.moe_apply``'s
expert- or tensor-parallel branch.

Parameters are a plain dict with the JAX package's leaf names and
layouts, except that the per-layer tree is a *list* of dicts
(``params["layers"][l]``) instead of arrays stacked on a leading layer
axis.  ``repro_torch.convert.params_from_jax`` maps a JAX tree onto this
form; ``init_params`` draws one directly on the device.
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.parallel import sharding as sh

from . import attention, layers, moe, ssm


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Vocabulary rounded up to a multiple of ``multiple`` (the unembedding
    width; the padded columns are masked in ``logits_out``)."""
    return -(-vocab // multiple) * multiple


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.layout in ("mamba", "hybrid"):
        ok = not cfg.is_moe and (cfg.layout == "mamba"
                                 or cfg.mlp_kind == "swiglu")
    else:
        ok = cfg.layout == "attn" and cfg.mlp_kind in ("swiglu", "gelu")
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention decoders (SwiGLU, GELU or "
            f"MoE FFN), Mamba-2 and Mamba-2 + shared-attention hybrids only "
            f"(layout={cfg.layout!r}, moe={cfg.is_moe}, "
            f"mlp={cfg.mlp_kind!r})")


def mamba_spec_of(cfg: ArchConfig) -> ssm.MambaSpec:
    return ssm.make_spec(cfg.d_model, expand=cfg.ssm_expand,
                         headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                         chunk=cfg.chunk)


def init_params(cfg: ArchConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = "cuda") -> dict:
    """Random weights with the JAX init scales (normal * d**-0.5, the
    down projection * d_ff**-0.5, norms at one, the expert weights of
    ``moe.init_moe_params``, the Mamba-2 scales of
    ``ssm.init_mamba_params``), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  The draws differ from
    ``jax.random``'s; tests that compare the two packages carry the JAX
    weights over with ``params_from_jax`` instead.

    ``mamba``/``hybrid`` layers are ``{"ln", "mamba"}``; a hybrid model
    also has the one shared attention + SwiGLU block ``params["shared"]``
    (``ln1``, ``ln2``, ``attn``, ``mlp``) that runs every
    ``shared_attn_every`` layers.  An MoE arch's attention layers carry
    ``lp["moe"]`` in place of ``lp["mlp"]``; a GELU arch's ``lp["mlp"]``
    is ``{"w_up", "w_down"}``.  ``embed`` (and ``lm_head``) are drawn in
    embeds mode too, as the JAX package draws them."""
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
        if cfg.mlp_kind == "gelu":
            return {"w_up": normal((d, cfg.d_ff), s),
                    "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}
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
            lp = {"ln1": ln(), "ln2": ln(), "attn": one_attn()}
            if cfg.is_moe:
                lp["moe"] = moe.init_moe_params(
                    gen, d, cfg.n_experts, cfg.expert_d_ff or cfg.d_ff,
                    dtype=dtype, device=dev)
            else:
                lp["mlp"] = one_mlp()
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


def embed_in(params: dict, cfg: ArchConfig, tokens: torch.Tensor | None,
             *, embeds: torch.Tensor | None = None,
             mi: sh.MeshInfo | None = None) -> torch.Tensor:
    """tokens [B, S] -> hidden [B, S, d]; an ``input_mode="embeds"`` arch
    takes ``embeds`` [B, S, d] (the stubbed frontend's output) as the
    hidden states instead, and no tokens.  With a mesh, plain tokens or
    embeds enter split over the data axes, and the lookup is DTensor's
    embedding over the table's shards (its gradient a sum over them)."""
    if mi is not None:
        if tokens is not None:
            tokens = sh.constrain(tokens, mi, (mi.dp_axes, None))
        if embeds is not None:
            embeds = sh.constrain(embeds, mi, (mi.dp_axes, None, None))
    if cfg.input_mode == "embeds":
        if embeds is None or tokens is not None:
            raise ValueError(f"{cfg.name} takes embeds=[B, S, d] and no "
                             f"tokens")
        if embeds.dim() != 3 or embeds.shape[-1] != cfg.d_model:
            raise ValueError(f"{cfg.name}: embeds of shape "
                             f"{tuple(embeds.shape)}, want [B, S, "
                             f"{cfg.d_model}]")
        h = embeds
    else:
        if tokens is None or embeds is not None:
            raise ValueError(f"{cfg.name} takes token ids and no embeds")
        h = (layers.embed(tokens, params["embed"]) if mi is None
             else torch.nn.functional.embedding(tokens, params["embed"]))
    if cfg.scale_embed:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def logits_out(params: dict, cfg: ArchConfig, h: torch.Tensor,
               mi: sh.MeshInfo | None = None) -> torch.Tensor:
    """hidden [B, S, d] -> logits [B, S, Vp] with the padded vocabulary
    columns masked to -1e9 (with a mesh by ``torch.where``: DTensor has
    no sharding rule for every torch's in-place fill)."""
    logits = layers.unembed(
        h, params["embed"] if cfg.tie_embeddings else params["lm_head"],
        tied=cfg.tie_embeddings)
    vp = logits.shape[-1]
    if vp != cfg.vocab and mi is None:
        logits[..., cfg.vocab:] = -1e9
    elif vp != cfg.vocab:
        pad = torch.arange(vp, device=h.device) >= cfg.vocab
        logits = torch.where(pad, torch.tensor(-1e9, dtype=logits.dtype,
                                               device=h.device), logits)
    return logits


def _ffn(lp: dict, cfg: ArchConfig, h: torch.Tensor,
         valid: torch.Tensor | None = None, mi: sh.MeshInfo | None = None):
    """``ffn_block``'s body: (h + ffn(rms_norm(h)), counts, router probs
    [T, E], top-k idx [T, k]); the last three are None for a dense
    FFN.  With a mesh the MoE FFN is ``moe.moe_apply``'s expert- or
    tensor-parallel branch."""
    x = layers.rms_norm(h, lp["ln2"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    counts = probs = idx = None
    if cfg.is_moe and mi is not None:
        y, probs, idx, counts = moe.moe_apply(
            x, lp["moe"], top_k=cfg.top_k, mi=mi,
            capacity_factor=cfg.moe_capacity_factor,
            softmax_before_topk=cfg.softmax_before_topk)
    elif cfg.is_moe:
        d = x.shape[-1]
        y, probs, idx, counts = moe.moe_sorted_local(
            x.reshape(-1, d), lp["moe"], cfg.top_k,
            softmax_before_topk=cfg.softmax_before_topk)
        y = y.reshape(x.shape)
        if valid is not None:
            counts = moe.expert_counts(idx, cfg.n_experts,
                                       valid.reshape(-1))
    elif cfg.mlp_kind == "gelu":
        y = layers.gelu_mlp(x, lp["mlp"]["w_up"], lp["mlp"]["w_down"])
    else:
        m = lp["mlp"]
        y = layers.swiglu_mlp(x, m["w_gate"], m["w_up"], m["w_down"])
    if cfg.gemma_norm:
        y = layers.rms_norm(y, lp["ln2_post"], eps=cfg.norm_eps,
                            gemma_style=True)
    return h + y, counts, probs, idx


def ffn_block(lp: dict, cfg: ArchConfig, h: torch.Tensor,
              valid: torch.Tensor | None = None):
    """Pre-norm SwiGLU, GELU or MoE block with the optional gemma post-norm:
    (h + ffn(rms_norm(h)), expert counts).  The counts are the MoE
    router's int32 [E] histogram (None for a dense FFN), of the rows
    where the optional bool mask ``valid`` (h's leading shape) is true:
    padding rows are routed and computed like any other, as in the JAX
    ``_ffn``, but do not count.  The load-balancing loss, which JAX's
    ``_ffn_block`` also returns, is left to training (``forward_hidden``),
    so serving does not compute what it would discard."""
    h, counts, _, _ = _ffn(lp, cfg, h, valid)
    return h, counts


# =============================================================================
# dense-cache generation: prefill, then one token per decode_step
# =============================================================================

def _is_shared_site(cfg: ArchConfig, layer: int) -> bool:
    k = cfg.shared_attn_every
    return cfg.layout == "hybrid" and bool(k) and layer % k == k - 1


def _rope_tables(cfg: ArchConfig, positions: torch.Tensor):
    """((cos, sin) of local layers, (cos, sin) of global layers): gemma3's
    global layers take ``rope_theta_global``, every other arch one pair;
    an M-RoPE arch (qwen2_vl) the text-only table, every position stream
    the token index."""
    if cfg.mrope_sections is not None:
        pos3 = torch.stack([positions] * len(cfg.mrope_sections), dim=-1)
        c, s = layers.mrope_angles(pos3, cfg.head_dim, cfg.rope_theta,
                                   cfg.mrope_sections)
        return (c, s), (c, s)
    c, s = layers.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.rope_theta_global is not None:
        return (c, s), layers.rope_angles(positions, cfg.head_dim,
                                          cfg.rope_theta_global)
    return (c, s), (c, s)


def _layer_rope(cfg: ArchConfig, window: int, ropes):
    """The (cos, sin) pair of an ``attn`` layer with ``window`` (0 = a
    global, full-causal layer)."""
    local, glob = ropes
    return glob if window == 0 and cfg.rope_theta_global else local


def init_decode_state(cfg: ArchConfig, batch_size: int, cache_len: int, *,
                      dtype: torch.dtype = torch.float32,
                      start_pos: int = 0,
                      device: str | torch.device | None = "cuda") -> dict:
    """Empty caches for ``cache_len`` tokens of context.  ``attn`` layout:
    per layer a K/V cache [B, W, Hkv, Dh] with the position each slot
    holds (-1 = empty), W = min(window, cache_len) for a windowed layer
    (a ring written at ``position % W``) and ``cache_len`` for a global
    one; with ``kv_cache_quant`` the caches are int8 with float32 scales
    ``k_scale``/``v_scale`` [B, W, Hkv].  ``mamba``/``hybrid``: per Mamba
    layer the SSM state h [B, H, N, P] (float32) and the raw conv context
    [B, d_conv-1, conv_ch]; per shared-attention site of a hybrid a dense
    K/V cache [B, cache_len, Hkv, Dh], written as a ring at ``position %
    cache_len``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    B = batch_size
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    state: dict = {
        "positions": torch.full((B,), start_pos, dtype=torch.int32,
                                device=dev),
        "attn": [], "mamba": []}

    def cache(W, kv_dtype, quant):
        c = {"k": torch.zeros((B, W, Hkv, Dh), dtype=kv_dtype, device=dev),
             "v": torch.zeros((B, W, Hkv, Dh), dtype=kv_dtype, device=dev),
             "pos": torch.full((B, W), -1, dtype=torch.int32, device=dev)}
        if quant:
            c["k_scale"] = torch.zeros((B, W, Hkv), dtype=torch.float32,
                                       device=dev)
            c["v_scale"] = torch.zeros_like(c["k_scale"])
        return c

    if cfg.layout == "attn":
        kv_dtype = torch.int8 if cfg.kv_cache_quant else dtype
        state["attn"] = [
            cache(min(w, cache_len) if w > 0 else cache_len, kv_dtype,
                  cfg.kv_cache_quant)
            for w in cfg.attn_window_pattern]
        return state
    spec = mamba_spec_of(cfg)
    state["mamba"] = [{
        "h": torch.zeros((B, spec.n_heads, spec.d_state, spec.headdim),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((B, spec.d_conv - 1, spec.conv_ch),
                            dtype=dtype, device=dev),
    } for _ in range(cfg.n_layers)]
    n_sites = sum(_is_shared_site(cfg, l) for l in range(cfg.n_layers))
    state["attn"] = [cache(cache_len, dtype, False) for _ in range(n_sites)]
    return state


def _place(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """Write a prompt's last min(S, W) K/V rows into a cache of W slots at
    ``position % W``, in place; an int8 cache takes them quantized, with
    their per-head scales."""
    S, W = k.shape[1], cache["k"].shape[1]
    n = min(S, W)
    pos = torch.arange(S - n, S, dtype=torch.int32, device=k.device)
    idx = pos.long() % W
    if "k_scale" in cache:
        for name, u in (("k", k), ("v", v)):
            q, sc = attention.quantize_int8(u[:, S - n:])
            cache[name][:, idx] = q
            cache[name + "_scale"][:, idx] = sc
    else:
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


def _attn_post(lp: dict, cfg: ArchConfig, out: torch.Tensor) -> torch.Tensor:
    """gemma's post-attention norm (identity for every other arch)."""
    if not cfg.gemma_norm:
        return out
    return layers.rms_norm(out, lp["ln1_post"], eps=cfg.norm_eps,
                           gemma_style=True)


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor | None,
            cache_len: int, *, embeds: torch.Tensor | None = None):
    """Run a batch of equal-length prompts tokens [B, S] (an embeds arch:
    ``embeds`` [B, S, d], tokens None); returns the last-token logits
    [B, 1, Vp] and the decode state (positions S).

    ``attn`` layout: every layer attends causally on K8 (within its
    window, if it has one) and places its K/V in its cache, then runs its
    FFN (MoE on ``moe_ffn``).  ``mamba``/``hybrid``: every Mamba layer
    runs its chunked scan on K9 and keeps its final state and raw conv
    context; every shared-attention site of a hybrid attends causally on
    K8 and places its K/V in the site's cache."""
    _check_supported(cfg)
    h = embed_in(params, cfg, tokens, embeds=embeds)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    state = init_decode_state(cfg, B, cache_len, dtype=h.dtype,
                              start_pos=S, device=h.device)
    if cfg.layout == "attn":
        ropes = _rope_tables(cfg, positions)
        for l, lp in enumerate(params["layers"]):
            w = cfg.attn_window_pattern[l]
            cos, sin = _layer_rope(cfg, w, ropes)
            x = layers.rms_norm(h, lp["ln1"], eps=cfg.norm_eps,
                                gemma_style=cfg.gemma_norm)
            out, (k, v) = attention.attention(
                lp["attn"], x, positions, cos, sin,
                window=w if w > 0 else None, soft_cap=cfg.soft_cap)
            h, _ = ffn_block(lp, cfg, h + _attn_post(lp, cfg, out))
            _place(state["attn"][l], k, v)
    else:
        spec = mamba_spec_of(cfg)
        if cfg.layout == "hybrid":
            cos, sin = layers.rope_angles(positions, cfg.head_dim,
                                          cfg.rope_theta)
        ai = 0
        for l, lp in enumerate(params["layers"]):
            x = layers.rms_norm(h, lp["ln"], eps=cfg.norm_eps)
            out, (hs, tail) = ssm.mamba_forward(lp["mamba"], spec, x,
                                                return_state=True)
            h = h + out
            state["mamba"][l] = {
                "h": hs, "conv": _conv_context(tail, spec).to(h.dtype)}
            if _is_shared_site(cfg, l):
                sp = params["shared"]
                x = layers.rms_norm(h, sp["ln1"], eps=cfg.norm_eps)
                out, (k, v) = attention.attention(sp["attn"], x, positions,
                                                  cos, sin)
                h = _shared_mlp(sp, cfg, h + out)
                _place(state["attn"][ai], k, v)
                ai += 1
    h = layers.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    return logits_out(params, cfg, h[:, -1:, :]), state


def decode_step(params: dict, cfg: ArchConfig, state: dict,
                tokens: torch.Tensor | None, *,
                embeds: torch.Tensor | None = None):
    """One token per sequence, tokens [B, 1] (an embeds arch: ``embeds``
    [B, 1, d], tokens None).  ``attn`` layout: per layer
    the new K/V written at its cache's ring slot and attention over the
    cache (int8 caches quantize on write and dequantize on read), then
    the FFN (MoE on ``moe_ffn``).  ``mamba``/``hybrid``: the O(1)
    Mamba-2 recurrence per layer and dense-cache attention at each shared
    site.  The attention here is plain torch, as it is XLA in the JAX
    package.  Returns (logits [B, 1, Vp], the new state); the caches are
    updated in place and carried over."""
    _check_supported(cfg)
    h = embed_in(params, cfg, tokens, embeds=embeds)
    pos = state["positions"]
    positions = pos[:, None]
    new_attn = list(state["attn"])
    new_mamba = list(state["mamba"])
    if cfg.layout == "attn":
        ropes = _rope_tables(cfg, positions)
        for l, lp in enumerate(params["layers"]):
            w = cfg.attn_window_pattern[l]
            cos, sin = _layer_rope(cfg, w, ropes)
            x = layers.rms_norm(h, lp["ln1"], eps=cfg.norm_eps,
                                gemma_style=cfg.gemma_norm)
            c = state["attn"][l]
            out, *caches = attention.decode_attention(
                lp["attn"], x, c["k"], c["v"], c["pos"], positions, cos,
                sin, window=w if w > 0 else None, soft_cap=cfg.soft_cap,
                k_scale=c.get("k_scale"), v_scale=c.get("v_scale"))
            h, _ = ffn_block(lp, cfg, h + _attn_post(lp, cfg, out))
            new_attn[l] = dict(zip(("k", "v", "pos", "k_scale", "v_scale"),
                                   caches))
    else:
        spec = mamba_spec_of(cfg)
        if cfg.layout == "hybrid":
            cos, sin = layers.rope_angles(positions, cfg.head_dim,
                                          cfg.rope_theta)
        ai = 0
        for l, lp in enumerate(params["layers"]):
            x = layers.rms_norm(h, lp["ln"], eps=cfg.norm_eps)
            st = state["mamba"][l]
            out, hs, cs = ssm.mamba_decode_step(lp["mamba"], spec, x,
                                                st["h"], st["conv"])
            h = h + out
            new_mamba[l] = {"h": hs, "conv": cs}
            if _is_shared_site(cfg, l):
                sp = params["shared"]
                x = layers.rms_norm(h, sp["ln1"], eps=cfg.norm_eps)
                c = state["attn"][ai]
                out, kc, vc, pc = attention.decode_attention(
                    sp["attn"], x, c["k"], c["v"], c["pos"], positions, cos,
                    sin)
                h = _shared_mlp(sp, cfg, h + out)
                new_attn[ai] = {"k": kc, "v": vc, "pos": pc}
                ai += 1
    h = layers.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    logits = logits_out(params, cfg, h)
    return logits, {"positions": pos + 1, "attn": new_attn,
                    "mamba": new_mamba}


# =============================================================================
# training forward: the loss and its gradient under autograd
# =============================================================================

def _sdpa(q, k, v, bias, mi: sh.MeshInfo | None, *,
          soft_cap: float | None = None):
    """The training attention: the plain ``sdpa``, on each rank's shards
    under a mesh."""
    if mi is None:
        return attention.sdpa(q, k, v, bias, soft_cap=soft_cap)
    return attention.sdpa_sharded(q, k, v, bias, mi, soft_cap=soft_cap)


def _train_attn_layer(h: torch.Tensor, lp: dict, cfg: ArchConfig,
                      window: int, cos: torch.Tensor, sin: torch.Tensor,
                      bias: torch.Tensor, mi: sh.MeshInfo | None = None):
    """One ``attn`` layer: pre-norm attention on the plain ``sdpa`` (K8
    has no backward) with the optional gemma post-norm, then the FFN.
    Returns (h, expert counts, load-balancing loss); the last two are
    None for a dense FFN."""
    x = layers.rms_norm(h, lp["ln1"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    q, k, v = attention.project_qkv(lp["attn"], x, cos, sin)
    out = _sdpa(q, k, v, bias, mi, soft_cap=cfg.soft_cap)
    out = attention._out_proj(out, lp["attn"]["wo"])
    h, counts, probs, idx = _ffn(lp, cfg, h + _attn_post(lp, cfg, out),
                                 mi=mi)
    aux = (moe.aux_load_balance_loss(probs, idx, cfg.n_experts)
           if cfg.is_moe else None)
    return h, counts, aux


def _train_mamba_layer(h: torch.Tensor, lp: dict, sp: dict | None,
                       cfg: ArchConfig, spec: ssm.MambaSpec,
                       cos: torch.Tensor, sin: torch.Tensor,
                       bias: torch.Tensor,
                       mi: sh.MeshInfo | None = None) -> torch.Tensor:
    """One Mamba-2 layer on the plain chunked scan; ``sp`` (a hybrid's
    shared block at a shared site, else None) then attends causally with
    the shared weights and runs the shared SwiGLU."""
    x = layers.rms_norm(h, lp["ln"], eps=cfg.norm_eps)
    if mi is None:
        h = h + ssm.mamba_forward(lp["mamba"], spec, x,
                                  scan=ssm.ssd_chunked)
    else:
        h = h + ssm.mamba_forward_sharded(lp["mamba"], spec, x, mi)
    if sp is not None:
        x = layers.rms_norm(h, sp["ln1"], eps=cfg.norm_eps)
        q, k, v = attention.project_qkv(sp["attn"], x, cos, sin)
        out = attention._out_proj(_sdpa(q, k, v, bias, mi),
                                  sp["attn"]["wo"])
        h = _shared_mlp(sp, cfg, h + out)
    return h


def forward_hidden(params: dict, cfg: ArchConfig, batch: dict,
                   mi: sh.MeshInfo | None = None):
    """Final-normed hidden states [B, S, d] of a training batch
    (``{"tokens": [B, S]}`` or, for an embeds arch, ``{"embeds": [B, S,
    d]}``) and the metrics: ``moe_aux``, the load-balancing loss summed
    over the layers (float32 0 without MoE), and for an MoE arch
    ``expert_counts``, the int32 [E] histogram summed over the layers.
    The JAX ``forward_hidden`` as a loop over the layer list with its
    per-layer window, global-RoPE and shared-site decisions.  Attention
    runs the plain ``sdpa`` over ``_mask_bias`` and the Mamba-2 scan the
    plain ``ssd_chunked``, so autograd differentiates both; with
    ``cfg.remat`` each layer is a ``torch.utils.checkpoint`` (its
    activations are recomputed in the backward, and its router routes
    the same rows again).  The only kernels it launches are an MoE
    layer's: ``moe_ffn`` forward (2 launches a layer, 2 more in each
    recompute) and ``moe_ffn_bwd`` in the backward (3 a layer)."""
    _check_supported(cfg)
    h = embed_in(params, cfg, batch.get("tokens"),
                 embeds=batch.get("embeds"), mi=mi)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    ropes = _rope_tables(cfg, positions)
    if mi is not None:
        aspec = sh.act_spec(cfg, mi, seq=True)
        inner = sh.act_spec(cfg, mi, seq=False)

    def run(fn, h, *args):
        if mi is not None:      # gathered over the sequence for the block
            h = sh.constrain(h, mi, inner)
        if cfg.remat:
            out = torch.utils.checkpoint.checkpoint(fn, h, *args,
                                                    use_reentrant=False)
        else:
            out = fn(h, *args)
        if mi is None:
            return out
        if isinstance(out, tuple):
            return (sh.constrain(out[0], mi, aspec), *out[1:])
        return sh.constrain(out, mi, aspec)

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    counts = (torch.zeros((cfg.n_experts,), dtype=torch.int32,
                          device=h.device) if cfg.is_moe else None)
    if cfg.layout == "attn":
        wins = cfg.attn_window_pattern
        biases = {w: attention._mask_bias(positions, positions, w)
                  for w in set(wins)}
        for l, lp in enumerate(params["layers"]):
            cos, sin = _layer_rope(cfg, wins[l], ropes)
            h, c, a = run(_train_attn_layer, h, lp, cfg, wins[l], cos,
                          sin, biases[wins[l]], mi)
            if cfg.is_moe:
                counts = counts + c
                aux = aux + a
    else:
        spec = mamba_spec_of(cfg)
        cos, sin = ropes[0]
        bias = (attention._mask_bias(positions, positions, None)
                if cfg.layout == "hybrid" else None)
        for l, lp in enumerate(params["layers"]):
            sp = params["shared"] if _is_shared_site(cfg, l) else None
            h = run(_train_mamba_layer, h, lp, sp, cfg, spec, cos, sin,
                    bias, mi)
    h = layers.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    metrics = {"moe_aux": aux}
    if counts is not None:
        metrics["expert_counts"] = counts
    return h, metrics


def loss_fn(params: dict, cfg: ArchConfig, batch: dict,
            mi: sh.MeshInfo | None = None):
    """(total loss, metrics) of a batch with ``labels`` [B, S]: the mean
    token cross-entropy of ``logits_out`` plus ``aux_loss_weight`` x the
    MoE load-balancing loss (0 without MoE); metrics add ``ce_loss``.
    With a mesh (DTensor parameters, under ``implicit_replication``) the
    final hidden states are gathered over the sequence and the logits
    over the vocabulary (split over ``model`` by the unembedding) before
    the cross-entropy picks each label's logit."""
    h, metrics = forward_hidden(params, cfg, batch, mi)
    if mi is not None:
        h = sh.constrain(h, mi, sh.act_spec(cfg, mi, seq=False))
    logits = logits_out(params, cfg, h, mi)
    labels = batch["labels"]
    if mi is not None:
        logits = sh.constrain(logits, mi, sh.act_spec(cfg, mi, seq=False))
        labels = sh.constrain(labels, mi, (mi.dp_axes, None))
    loss = layers.softmax_cross_entropy(logits, labels)
    total = loss + cfg.aux_loss_weight * metrics["moe_aux"]
    return total, dict(metrics, ce_loss=loss)
