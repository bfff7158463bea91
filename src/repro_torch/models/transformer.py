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


def _rows(mi: sh.MeshInfo, batch: int):
    """The spec entry of a batch of ``batch`` rows: the data axes, or
    whole where they do not divide it."""
    return mi.dp_axes if batch % mi.n_data == 0 else None


def embed_in(params: dict, cfg: ArchConfig, tokens: torch.Tensor | None,
             *, embeds: torch.Tensor | None = None,
             mi: sh.MeshInfo | None = None) -> torch.Tensor:
    """tokens [B, S] -> hidden [B, S, d]; an ``input_mode="embeds"`` arch
    takes ``embeds`` [B, S, d] (the stubbed frontend's output) as the
    hidden states instead, and no tokens.  With a mesh, plain tokens or
    embeds enter split over the data axes (whole on every rank where the
    batch does not divide over them, as a long-context decode's one
    sequence), and the lookup is DTensor's embedding over the table's
    shards (its gradient a sum over them)."""
    if mi is not None:
        x = tokens if tokens is not None else embeds
        dp = _rows(mi, x.shape[0])
        if tokens is not None:
            tokens = sh.constrain(tokens, mi, (dp, None))
        if embeds is not None:
            embeds = sh.constrain(embeds, mi, (dp, None, None))
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
    else:
        y = _mlp(lp["mlp"], cfg, x, mi)
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
                      device: str | torch.device | None = "cuda",
                      mi: sh.MeshInfo | None = None) -> dict:
    """Empty caches for ``cache_len`` tokens of context.  ``attn`` layout:
    per layer a K/V cache [B, W, Hkv, Dh] with the position each slot
    holds (-1 = empty), W = min(window, cache_len) for a windowed layer
    (a ring written at ``position % W``) and ``cache_len`` for a global
    one; with ``kv_cache_quant`` the caches are int8 with float32 scales
    ``k_scale``/``v_scale`` [B, W, Hkv].  ``mamba``/``hybrid``: per Mamba
    layer the SSM state h [B, H, N, P] (float32) and the raw conv context
    [B, d_conv-1, conv_ch]; per shared-attention site of a hybrid a dense
    K/V cache [B, cache_len, Hkv, Dh], written as a ring at ``position %
    cache_len``.  With a mesh every leaf is a DTensor laid out as
    ``prefill`` writes it (``sharding.decode_state_specs(...,
    min_split=0)``: every cache's slots over ``model``), only its local
    shard allocated (meta tensors too)."""
    _check_supported(cfg)
    if mi is not None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():          # the whole tree's shapes, unmade
            shapes = init_decode_state(cfg, batch_size, cache_len,
                                       dtype=dtype, start_pos=start_pos,
                                       device="cpu")
        specs = sh.decode_state_specs(shapes, mi, min_split=0)
        fills = {"positions": start_pos, "pos": -1}

        def make(t, spec, name=""):
            if isinstance(t, dict):
                return {k: make(t[k], spec[k], k) for k in t}
            if isinstance(t, list):
                return [make(a, b, name) for a, b in zip(t, spec)]
            return sh.empty(tuple(t.shape), spec, mi, dtype=t.dtype,
                            device=device, fill=fills.get(name, 0))
        return make(shapes, specs)
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


def _mlp(m: dict, cfg: ArchConfig, x: torch.Tensor,
         mi: sh.MeshInfo | None = None) -> torch.Tensor:
    """The dense FFN (SwiGLU, or GELU for musicgen).  With a mesh it runs
    on each rank's d_ff slice of the column/row-split weights
    (``param_specs``), the rows whole over ``model``, and the partial
    outputs are summed over ``model`` (Megatron's MLP): DTensor would
    take the weights' gradients whole on every rank, the gradient
    arriving split over the sequence while the weights split d_ff."""
    def ffn(x, m):
        if cfg.mlp_kind == "gelu":
            return layers.gelu_mlp(x, m["w_up"], m["w_down"])
        return layers.swiglu_mlp(x, m["w_gate"], m["w_up"], m["w_down"])
    if mi is None:
        return ffn(x, m)
    # the rows whole over model (a norm of a partial sum is one too)
    x = x.redistribute(mi.mesh, sh.like_batch(x))
    xl = sh.local(x, mi, (mi.model_axis,))
    y = ffn(xl, {k: sh.local(w, mi, mi.dp_axes) for k, w in m.items()})
    return sh.psum(y, mi, x)


def _shared_mlp(sp: dict, cfg: ArchConfig, h: torch.Tensor,
                mi: sh.MeshInfo | None = None) -> torch.Tensor:
    x = layers.rms_norm(h, sp["ln2"], eps=cfg.norm_eps)
    return h + _mlp(sp["mlp"], cfg, x, mi)


def _attn_post(lp: dict, cfg: ArchConfig, out: torch.Tensor) -> torch.Tensor:
    """gemma's post-attention norm (identity for every other arch)."""
    if not cfg.gemma_norm:
        return out
    return layers.rms_norm(out, lp["ln1_post"], eps=cfg.norm_eps,
                           gemma_style=True)


def _context(cfg: ArchConfig, mi: sh.MeshInfo | None) -> bool:
    """Whether attention runs in context mode on ``mi``'s mesh: the heads
    do not divide ``model``, so each ``model`` rank attends with its rows
    of the sequence (``attention.sdpa_sharded``)."""
    return mi is not None and sh.attn_mode(cfg, mi) == "context"


def _add_rows(h, out, cfg: ArchConfig, mi: sh.MeshInfo):
    """``h + out`` whole along the sequence (the FFN's input), where
    context-mode attention's ``out`` lies split along it: added where h
    is split too, then gathered; gathered first where h is whole.  One
    all-gather either way."""
    inner = sh.act_spec(cfg, mi, seq=False)
    if sh.split_dims(h, 1):
        return sh.constrain(h + out, mi, inner)
    return h + sh.constrain(out, mi, inner)


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor | None,
            cache_len: int, *, embeds: torch.Tensor | None = None,
            mi: sh.MeshInfo | None = None):
    """Run a batch of equal-length prompts tokens [B, S] (an embeds arch:
    ``embeds`` [B, S, d], tokens None); returns the last-token logits
    [B, 1, Vp] and the decode state (positions S).

    ``attn`` layout: every layer attends causally on K8 (within its
    window, if it has one) and places its K/V in its cache, then runs its
    FFN (MoE on ``moe_ffn``).  ``mamba``/``hybrid``: every Mamba layer
    runs its chunked scan on K9 and keeps its final state and raw conv
    context; every shared-attention site of a hybrid attends causally on
    K8 and places its K/V in the site's cache.

    With a mesh ``mi`` (DTensor parameters by ``param_specs``; opened
    under ``implicit_replication`` here, so the caller must not hold one
    open): the prompts split over the data axes, the activations laid out
    by ``act_spec`` between layers (JAX's constraint), K8 on each rank's
    heads and batch rows (megatron mode) or, in context mode (heads that
    do not divide ``model``), on its rows of the sequence from their first
    position against K/V gathered along it (``attention.attention_rows``),
    K9 on each rank's heads (``mamba_forward_sharded``),
    the MoE FFN on ``moe.moe_apply``'s expert- or tensor-parallel branch
    on ``moe_ffn``, and the caches written in ``kv_cache_spec``'s layout
    (slots over ``model``, ``_place_sharded``).  The state is DTensors
    (``init_decode_state(..., mi=)``)."""
    _check_supported(cfg)
    if mi is not None:
        return _prefill_sharded(params, cfg, tokens, cache_len, embeds, mi)
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
                embeds: torch.Tensor | None = None,
                mi: sh.MeshInfo | None = None):
    """One token per sequence, tokens [B, 1] (an embeds arch: ``embeds``
    [B, 1, d], tokens None).  ``attn`` layout: per layer
    the new K/V written at its cache's ring slot and attention over the
    cache (int8 caches quantize on write and dequantize on read), then
    the FFN (MoE on ``moe_ffn``).  ``mamba``/``hybrid``: the O(1)
    Mamba-2 recurrence per layer and dense-cache attention at each shared
    site.  The attention here is plain torch, as it is XLA in the JAX
    package.  Returns (logits [B, 1, Vp], the new state); the caches are
    updated in place and carried over.

    With a mesh ``mi`` the state is DTensors in any layout of
    ``sharding.decode_state_specs`` (``prefill``'s, or the dry run's
    ``decode_input_specs``): attention is
    ``attention.decode_attention_sharded`` (each rank its slot range, the
    partial softmax merged over the slot split), Mamba-2
    ``ssm.mamba_decode_step_sharded``, MoE ``moe.moe_apply``; the caches
    keep their layout (updated in place)."""
    _check_supported(cfg)
    if mi is not None:
        return _decode_sharded(params, cfg, state, tokens, embeds, mi)
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


def _place_sharded(cache: dict, k, v, mi: sh.MeshInfo) -> dict:
    """``_place`` of DTensor caches: each rank writes, in place, the
    prompt rows whose ring slot falls in its slot range of the sequences
    it holds (k/v gathered onto the cache's batch layout first)."""
    kc = cache["k"]
    W, S = kc.shape[1], k.shape[1]
    n = min(S, W)
    rows = sh.like_batch(kc)
    kl, vl = (t.redistribute(mi.mesh, rows).to_local() for t in (k, v))
    loc = {name: t.to_local() for name, t in cache.items()}
    lo, Wl = sh.local_offset(kc)[1], loc["k"].shape[1]
    src = [p for p in range(S - n, S) if lo <= p % W < lo + Wl]
    if not src:
        return cache
    dev = kl.device
    at = torch.tensor([p % W - lo for p in src], device=dev)
    rows_at = torch.tensor(src, device=dev)
    for name, u in (("k", kl), ("v", vl)):
        if "k_scale" in loc:
            q, sc = attention.quantize_int8(u[:, rows_at])
            loc[name][:, at] = q
            loc[name + "_scale"][:, at] = sc
        else:
            loc[name][:, at] = u[:, rows_at].to(loc[name].dtype)
    loc["pos"][:, at] = rows_at.to(torch.int32)
    return cache


def _prefill_sharded(params, cfg, tokens, cache_len, embeds, mi):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import flash_attention as K8
    from repro_torch.kernels import ssd_scan as K9
    with implicit_replication():
        h = embed_in(params, cfg, tokens, embeds=embeds, mi=mi)
        B, S, _ = h.shape
        dev = h.device
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(B, S)
        state = init_decode_state(cfg, B, cache_len, dtype=h.dtype,
                                  start_pos=S, device=dev, mi=mi)
        aspec = sh.act_spec(cfg, mi, seq=True)
        inner = sh.act_spec(cfg, mi, seq=False)
        ctx = _context(cfg, mi)

        def attend(p, x, cos, sin, window=None):
            """Attention on K8 and its K/V.  Context mode projects each
            rank's rows and gathers K/V once (for K8 and the cache); K8
            runs the rank's queries from their first position."""
            if cfg.soft_cap is not None:
                raise NotImplementedError("attention: K8 has no logit soft "
                                          "cap")

            def k8(a, b, c, s):
                return K8.flash_attention(a, b, c, causal=True,
                                          window=window or 0, q_start=s)
            if ctx:
                return attention.attention_rows(p, x, cos, sin, mi, k8)
            q, k, v = attention.project_qkv(p, x, cos, sin)
            out = attention.sdpa_sharded(q, k, v, mi, k8)
            return attention._out_proj(out, p["wo"]), k, v

        def add(h, out):
            return _add_rows(h, out, cfg, mi) if ctx else h + out

        if cfg.layout == "attn":
            ropes = _rope_tables(cfg, positions)
            for l, lp in enumerate(params["layers"]):
                w = cfg.attn_window_pattern[l]
                cos, sin = _layer_rope(cfg, w, ropes)
                # context mode attends on its rows of the sequence
                h = sh.constrain(h, mi, aspec if ctx else inner)
                x = layers.rms_norm(h, lp["ln1"], eps=cfg.norm_eps,
                                    gemma_style=cfg.gemma_norm)
                out, k, v = attend(lp["attn"], x, cos, sin, w)
                h = _ffn(lp, cfg, add(h, _attn_post(lp, cfg, out)), mi=mi)[0]
                _place_sharded(state["attn"][l], k, v, mi)
                h = sh.constrain(h, mi, aspec)
        else:
            spec = mamba_spec_of(cfg)
            cos, sin = _rope_tables(cfg, positions)[0]
            ai = 0
            for l, lp in enumerate(params["layers"]):
                h = sh.constrain(h, mi, inner)
                x = layers.rms_norm(h, lp["ln"], eps=cfg.norm_eps)
                out, (hs, conv) = ssm.mamba_forward_sharded(
                    lp["mamba"], spec, x, mi, scan=K9.ssd_scan,
                    return_state=True)
                h = h + out
                state["mamba"][l] = {"h": hs, "conv": conv.to(h.dtype)}
                if _is_shared_site(cfg, l):
                    sp = params["shared"]
                    x = layers.rms_norm(h, sp["ln1"], eps=cfg.norm_eps)
                    out, k, v = attend(sp["attn"], x, cos, sin)
                    h = _shared_mlp(sp, cfg, add(h, out), mi)
                    _place_sharded(state["attn"][ai], k, v, mi)
                    ai += 1
                h = sh.constrain(h, mi, aspec)
        h = sh.constrain(h, mi, inner)
        h = layers.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                            gemma_style=cfg.gemma_norm)
        return logits_out(params, cfg, h[:, -1:, :], mi), state


def _decode_sharded(params, cfg, state, tokens, embeds, mi):
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        h = embed_in(params, cfg, tokens, embeds=embeds, mi=mi)
        # the lookup's partial sum (a vocab-split table) reduced at once:
        # torch 2.11's DTensor cannot reduce it a second time, where the
        # norm and the residual both read it
        h = sh.constrain(h, mi, (_rows(mi, h.shape[0]), None, None))
        pos = state["positions"]
        pos_all = sh.full(pos)          # the new tokens' positions, whole
        positions = pos_all[:, None]
        new_attn = list(state["attn"])
        new_mamba = list(state["mamba"])
        if cfg.layout == "attn":
            ropes = _rope_tables(cfg, positions)
            for l, lp in enumerate(params["layers"]):
                w = cfg.attn_window_pattern[l]
                cos, sin = _layer_rope(cfg, w, ropes)
                x = layers.rms_norm(h, lp["ln1"], eps=cfg.norm_eps,
                                    gemma_style=cfg.gemma_norm)
                out, new_attn[l] = attention.decode_attention_sharded(
                    lp["attn"], x, state["attn"][l], pos_all, cos, sin, mi,
                    window=w if w > 0 else None, soft_cap=cfg.soft_cap)
                h = _ffn(lp, cfg, h + _attn_post(lp, cfg, out), mi=mi)[0]
        else:
            spec = mamba_spec_of(cfg)
            cos, sin = _rope_tables(cfg, positions)[0]
            ai = 0
            for l, lp in enumerate(params["layers"]):
                x = layers.rms_norm(h, lp["ln"], eps=cfg.norm_eps)
                st = state["mamba"][l]
                out, hs, cs = ssm.mamba_decode_step_sharded(
                    lp["mamba"], spec, x, st["h"], st["conv"], mi)
                h = h + out
                new_mamba[l] = {"h": hs, "conv": cs}
                if _is_shared_site(cfg, l):
                    sp = params["shared"]
                    x = layers.rms_norm(h, sp["ln1"], eps=cfg.norm_eps)
                    out, new_attn[ai] = attention.decode_attention_sharded(
                        sp["attn"], x, state["attn"][ai], pos_all, cos, sin,
                        mi)
                    h = _shared_mlp(sp, cfg, h + out, mi)
                    ai += 1
        h = layers.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                            gemma_style=cfg.gemma_norm)
        logits = logits_out(params, cfg, h, mi)
        return logits, {"positions": pos + 1, "attn": new_attn,
                        "mamba": new_mamba}


# =============================================================================
# training forward: the loss and its gradient under autograd
# =============================================================================

def _train_attention(p: dict, x, cos, sin, bias, mi: sh.MeshInfo | None,
                     ctx: bool, *, soft_cap: float | None = None,
                     q_chunk: int | None = None,
                     positions: torch.Tensor | None = None,
                     window: int | None = None):
    """The training attention block's output [B, S, d]: the projections,
    the plain ``sdpa`` over ``bias`` or, with ``q_chunk``
    (``cfg.attn_q_chunk``), ``sdpa_qchunked`` over ``positions`` and
    ``window``, and the output projection; on each rank's shards under a
    mesh (the training batch's rows of ``bias`` and ``positions`` are
    equal).  In context mode (``ctx``, ``attention.attention_rows``) the
    queries are the rank's rows of the sequence from ``q_start``, so they
    take those rows of ``bias``, or of ``positions`` as ``q_positions``,
    and the output leaves split along the sequence."""
    def attend(q, k, v, q_start=0):
        B, rows = q.shape[0], slice(q_start, q_start + q.shape[1])
        if q_chunk:
            return attention.sdpa_qchunked(
                q, k, v, positions[:B], q_positions=positions[:B, rows],
                window=window, soft_cap=soft_cap, q_chunk=q_chunk)
        return attention.sdpa(q, k, v, bias[:B, rows], soft_cap=soft_cap)
    if ctx:
        return attention.attention_rows(p, x, cos, sin, mi, attend)[0]
    q, k, v = attention.project_qkv(p, x, cos, sin)
    out = (attend(q, k, v) if mi is None
           else attention.sdpa_sharded(q, k, v, mi, attend))
    return attention._out_proj(out, p["wo"])


def _train_attn_layer(h: torch.Tensor, lp: dict, cfg: ArchConfig,
                      window: int, cos: torch.Tensor, sin: torch.Tensor,
                      bias: torch.Tensor, positions: torch.Tensor,
                      mi: sh.MeshInfo | None = None):
    """One ``attn`` layer: pre-norm attention on the plain ``sdpa`` (K8
    has no backward) with the optional gemma post-norm, then the FFN.
    Returns (h, expert counts, load-balancing loss); the last two are
    None for a dense FFN."""
    ctx = _context(cfg, mi)
    x = layers.rms_norm(h, lp["ln1"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    out = _attn_post(lp, cfg, _train_attention(
        lp["attn"], x, cos, sin, bias, mi, ctx, soft_cap=cfg.soft_cap,
        q_chunk=cfg.attn_q_chunk, positions=positions, window=window))
    h = _add_rows(h, out, cfg, mi) if ctx else h + out
    h, counts, probs, idx = _ffn(lp, cfg, h, mi=mi)
    aux = (moe.aux_load_balance_loss(probs, idx, cfg.n_experts)
           if cfg.is_moe else None)
    return h, counts, aux


def _train_mamba_layer(h: torch.Tensor, lp: dict, sp: dict | None,
                       cfg: ArchConfig, spec: ssm.MambaSpec,
                       cos: torch.Tensor, sin: torch.Tensor,
                       bias: torch.Tensor, positions: torch.Tensor,
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
        ctx = _context(cfg, mi)
        x = layers.rms_norm(h, sp["ln1"], eps=cfg.norm_eps)
        out = _train_attention(sp["attn"], x, cos, sin, bias, mi, ctx,
                               q_chunk=cfg.attn_q_chunk, positions=positions)
        h = _shared_mlp(sp, cfg, _add_rows(h, out, cfg, mi) if ctx
                        else h + out, mi)
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
    # context mode: an attn layer attends on its rows of the sequence and
    # gathers them after (_add_rows); the first takes the embedding's
    # output split along the sequence too
    ctx = cfg.layout == "attn" and _context(cfg, mi)

    def run(fn, h, *args):
        if mi is not None:      # the block's input: whole along the
            # sequence, or split along it in context mode
            h = sh.constrain(h, mi, aspec if ctx else inner)
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
        # every row's positions are 0..S-1: one row's bias, broadcast
        biases = {w: (None if cfg.attn_q_chunk else
                      attention._mask_bias(positions[:1], positions[:1], w))
                  for w in set(wins)}
        for l, lp in enumerate(params["layers"]):
            cos, sin = _layer_rope(cfg, wins[l], ropes)
            h, c, a = run(_train_attn_layer, h, lp, cfg, wins[l], cos,
                          sin, biases[wins[l]], positions, mi)
            if cfg.is_moe:
                counts = counts + c
                aux = aux + a
    else:
        spec = mamba_spec_of(cfg)
        cos, sin = ropes[0]
        bias = (attention._mask_bias(positions[:1], positions[:1], None)
                if cfg.layout == "hybrid" and not cfg.attn_q_chunk else None)
        for l, lp in enumerate(params["layers"]):
            sp = params["shared"] if _is_shared_site(cfg, l) else None
            h = run(_train_mamba_layer, h, lp, sp, cfg, spec, cos, sin,
                    bias, positions, mi)
    h = layers.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                        gemma_style=cfg.gemma_norm)
    metrics = {"moe_aux": aux}
    if counts is not None:
        metrics["expert_counts"] = counts
    return h, metrics


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token negative log-likelihood of logits whose vocabulary is
    split over the mesh dims ``dims``: each rank holds the vocabulary
    columns ``lo`` .. ``lo + V_local`` of its rows.  The log-sum-exp's
    max and sum and the label's logit are reduced over ``dims`` with
    functional collectives; the gradient, softmax minus the label's
    one-hot, is each rank's own columns (no collective)."""

    @staticmethod
    def forward(ctx, ll, labels, lo, mesh, dims):
        from torch.distributed import _functional_collectives as funcol
        x = ll.float()
        m = x.amax(dim=-1)
        for d in dims:
            m = funcol.all_reduce(m, "max", (mesh, d))
        se = torch.exp(x - m[..., None]).sum(dim=-1)
        mine = (labels >= lo) & (labels < lo + x.shape[-1])
        at = (labels - lo).clamp(0, max(x.shape[-1] - 1, 0)).long()
        picked = torch.where(mine, torch.gather(x, -1, at[..., None])[..., 0],
                             torch.zeros((), dtype=x.dtype, device=x.device))
        for d in dims:
            se = funcol.all_reduce(se, "sum", (mesh, d))
            picked = funcol.all_reduce(picked, "sum", (mesh, d))
        lse = m + torch.log(se)
        ctx.save_for_backward(ll, lse, at, mine)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        ll, lse, at, mine = ctx.saved_tensors
        p = torch.exp(ll.float() - lse[..., None])
        hit = torch.zeros_like(p).scatter_(-1, at[..., None],
                                           mine[..., None].to(p.dtype))
        return ((p - hit) * g[..., None]).to(ll.dtype), None, None, None, None


def _sharded_cross_entropy(logits, labels, mi: sh.MeshInfo):
    """The mean token cross-entropy of DTensor logits [B, S, V] and labels
    [B, S], the rows split over the data axes and the vocabulary left as
    the unembedding split it (over ``model``): each rank's token sum on
    its rows and vocabulary columns (``_VocabParallelNLL``), summed over
    the data axes and divided by B * S.  Nothing vocabulary-wide is
    gathered, and DTensor, which would make the label gather's gradient
    whole on every rank, is kept out of it."""
    from torch.distributed.tensor import Partial, Replicate
    rows = (mi.dp_axes, None)
    logits = sh.constrain(logits, mi, (*rows, mi.model_axis))
    labels = sh.constrain(labels, mi, rows)
    nll = _VocabParallelNLL.apply(
        sh.local(logits, mi), labels.to_local(), sh.local_offset(logits)[2],
        mi.mesh, sh.split_dims(logits, 2))
    total = sh.from_local(nll.sum(), mi, [
        Partial() if n in mi.dp_axes else Replicate()
        for n in mi.mesh.mesh_dim_names], ())
    total = total.redistribute(mi.mesh, [Replicate()] * mi.mesh.ndim)
    return total / labels.numel()


def loss_fn(params: dict, cfg: ArchConfig, batch: dict,
            mi: sh.MeshInfo | None = None):
    """(total loss, metrics) of a batch with ``labels`` [B, S]: the mean
    token cross-entropy of ``logits_out`` plus ``aux_loss_weight`` x the
    MoE load-balancing loss (0 without MoE); metrics add ``ce_loss``.
    With a mesh (DTensor parameters, under ``implicit_replication``) the
    final hidden states are gathered over the sequence, and the
    cross-entropy runs on each rank's rows and vocabulary columns (the
    unembedding splits the vocabulary over ``model``;
    ``_sharded_cross_entropy``)."""
    h, metrics = forward_hidden(params, cfg, batch, mi)
    if mi is not None:
        h = sh.constrain(h, mi, sh.act_spec(cfg, mi, seq=False))
    logits = logits_out(params, cfg, h, mi)
    labels = batch["labels"]
    if mi is None:
        loss = layers.softmax_cross_entropy(logits, labels)
    else:
        loss = _sharded_cross_entropy(logits, labels, mi)
    total = loss + cfg.aux_loss_weight * metrics["moe_aux"]
    return total, dict(metrics, ce_loss=loss)
