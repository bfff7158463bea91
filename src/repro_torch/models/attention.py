"""Attention (torch twin of ``repro.models.attention``): the QKV
projections with RoPE, the causal/sliding-window mask bias, the
KV-expansion ``sdpa`` (the plain form of kernel K8), full self-attention
over a prompt (``attention``, on K8), and the grouped-query ``sdpa_grouped``
with the dense, ring-buffer or int8 cache ``decode_attention`` (plain
torch: XLA in the JAX package too).

Weights keep the JAX layout: wq [d, Hq, Dh], wk/wv [d, Hkv, Dh],
wo [Hq, Dh, d]; each projection is one ``torch.matmul`` over the
flattened head axes.  Shapes: x [B, S, d]; q [B, S, Hq, Dh]; k/v
[B, S, Hkv, Dh].
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as K8
from repro_torch.kernels import kv_append as KA

from . import layers

NEG_INF = -2.0e38
_INT32_MAX = 2 ** 31 - 1
QK_NORM_EPS = 1e-6      # the per-head qk-norm's eps (rms_norm's default)


def project_raw(p: dict, x: torch.Tensor):
    """The projections with their optional bias, before qk-norm and RoPE
    (the paged serving path hands them to ``qkv_rope_append``).
    x: [B, S, d] -> q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh]."""
    B, S, d = x.shape

    def proj(w):
        return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if p.get("bq") is not None:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def project_qkv(p: dict, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor):
    """Project + (optional bias, qk-norm) + RoPE.  x: [B, S, d] ->
    q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh]."""
    q, k, v = project_raw(p, x)
    q, k = norm_rope(q, k, p.get("q_norm"), p.get("k_norm"), cos, sin)
    return q, k, v


def norm_rope(q: torch.Tensor, k: torch.Tensor, q_norm, k_norm,
              cos: torch.Tensor, sin: torch.Tensor):
    """The per-head qk-norm (weights ``q_norm``/``k_norm`` [Dh], or None)
    and RoPE of q and k."""
    if q_norm is not None:
        q = layers.rms_norm(q, q_norm, eps=QK_NORM_EPS)
        k = layers.rms_norm(k, k_norm, eps=QK_NORM_EPS)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)


def rope_append_plain(q, k, v, q_norm, k_norm, cos, sin, fast, pin, f_idx,
                      p_idx, off) -> torch.Tensor:
    """``rope_append``'s eager composition, the one CPU tensors take (and
    the version the kernel is held to on the card): ``norm_rope``, the
    masked append, then q * Dh**-0.5 grouped in the pool dtype."""
    q, k = norm_rope(q, k, q_norm, k_norm, cos, sin)
    KA.kv_append_plain(fast, pin, f_idx, p_idx, off, k, v)
    R, Hq, D = q.shape
    Hkv = k.shape[1]
    return (q * D ** -0.5).reshape(R, Hkv, Hq // Hkv, D).to(fast.dtype)


def rope_append(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_norm: torch.Tensor | None, k_norm: torch.Tensor | None,
                cos: torch.Tensor, sin: torch.Tensor, fast: torch.Tensor,
                pin: torch.Tensor | None, f_idx: torch.Tensor,
                p_idx: torch.Tensor | None, off: torch.Tensor
                ) -> torch.Tensor:
    """The paged path's attention input of one layer: raw projections
    q [R, Hq, Dh], k/v [R, Hkv, Dh] (bias added), qk-norm weights [Dh]
    (or None), float32 RoPE tables cos/sin [R, Dh/2].  K is normed,
    rotated and written with V at in-page offset ``off`` of slot
    ``f_idx`` of ``fast`` and slot ``p_idx`` of ``pin`` (views [slots, 2,
    page, Hkv, Dh]; ``pin``/``p_idx`` None for one pool; out-of-range
    slots write nothing).  Returns q normed, rotated and scaled by
    Dh**-0.5 as [R, Hkv, G, Dh] in the pool dtype.  CUDA tensors: one
    launch of ``kernels.kv_append.qkv_rope_append``; CPU tensors:
    ``rope_append_plain``."""
    if q.device.type == "cpu":
        return rope_append_plain(q, k, v, q_norm, k_norm, cos, sin, fast,
                                 pin, f_idx, p_idx, off)
    return KA.qkv_rope_append(q, k, v, q_norm, k_norm, cos, sin, fast, pin,
                              f_idx, p_idx, off, eps=QK_NORM_EPS)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int | None) -> torch.Tensor:
    """Additive mask bias [.., Sq, Sk]: causal plus an optional sliding
    window of ``window`` tokens of look-back (<= 0 or None: full causal).
    Positions may be batched ([B, S]) or flat ([S])."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = dk <= dq
    if window is not None:
        ok = ok & ((dq - dk) < (window if window > 0 else _INT32_MAX))
    return torch.where(ok, 0.0, NEG_INF).float()


def sdpa_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask_bias: torch.Tensor, scale: float,
               soft_cap: float | None = None) -> torch.Tensor:
    """The body of ``sdpa`` with an explicit ``scale`` (K8's plain
    version passes its own)."""
    Hq, Hkv = q.shape[2], k.shape[2]
    G = Hq // Hkv
    k = layers.repeat_heads(k, G, dim=2)
    v = layers.repeat_heads(v, G, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if soft_cap is not None:
        logits = torch.tanh(logits / soft_cap) * soft_cap
    logits = logits + mask_bias[:, None, :, :]
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask_bias: torch.Tensor, *, soft_cap: float | None = None
         ) -> torch.Tensor:
    """Scaled dot-product attention, KV-expansion form.  q [B, Sq, Hq, Dh];
    k/v [B, Sk, Hkv, Dh]; mask_bias [B|1, Sq, Sk].  GQA KV is expanded to
    Hq heads; q is scaled by Dh**-0.5 in float32."""
    return sdpa_dense(q, k, v, mask_bias, q.shape[3] ** -0.5, soft_cap)


def sdpa_qchunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, *,
                  q_positions: torch.Tensor | None = None,
                  window: int | None = None,
                  soft_cap: float | None = None, q_chunk: int = 1024
                  ) -> torch.Tensor:
    """Query-chunked ``sdpa`` (JAX ``sdpa_qchunked``): the queries in
    chunks of ``q_chunk``, each chunk's mask built from the keys'
    ``positions`` [B, Sk] and the queries' ``q_positions`` [B, Sq]
    (default ``positions``: queries and keys the same rows) and its body
    a ``torch.utils.checkpoint``, so no [Sq, Sk] mask and no logits block
    larger than [B, H, q_chunk, Sk] is kept for the backward.  Where
    ``Sq`` is not a multiple of ``q_chunk`` or is no longer than it, the
    plain ``sdpa`` over the whole mask."""
    import torch.utils.checkpoint
    B, Sq, Hq, Dh = q.shape
    G = Hq // k.shape[2]
    k = layers.repeat_heads(k, G, dim=2)
    v = layers.repeat_heads(v, G, dim=2)
    q_pos = positions if q_positions is None else q_positions
    if Sq % q_chunk or Sq <= q_chunk:
        return sdpa(q, k, v, _mask_bias(q_pos, positions, window),
                    soft_cap=soft_cap)
    scale = Dh ** -0.5
    kf = k.float()

    def body(qc, qpos):
        logits = torch.einsum("bqhd,bkhd->bhqk", qc.float() * scale, kf)
        if soft_cap is not None:
            logits = torch.tanh(logits / soft_cap) * soft_cap
        logits = logits + _mask_bias(qpos, positions, window)[:, None]
        w = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)

    outs = [torch.utils.checkpoint.checkpoint(
                body, q[:, i:i + q_chunk], q_pos[:, i:i + q_chunk],
                use_reentrant=False)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


def _head_places(mi, split: bool) -> list:
    """Placements of a [B, S, H, D] tensor with the batch over the data
    axes and, where ``split``, the heads over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(2) if n == mi.model_axis and split
            else Shard(0) if n in mi.dp_axes else Replicate()
            for n in mi.mesh.mesh_dim_names]


def gather_kv(k, v, mi):
    """Context mode's K and V: DTensors k, v [B, S, Hkv, Dh] whole along
    the sequence on every ``model`` rank (the batch split kept), gathered
    with their Hkv heads."""
    from repro_torch.parallel import sharding as sh
    return (k.redistribute(mi.mesh, sh.like_batch(k)),
            v.redistribute(mi.mesh, sh.like_batch(v)))


def sdpa_sharded(q, k, v, mi, attend):
    """Attention of DTensors q, k, v over ``mi``'s mesh, run on each rank's
    shards by ``attend(q_local, k_local, v_local, q_start)``, where
    ``q_start`` is the position of the rank's first query row; the batch
    is split over the data axes.

    Megatron mode (the heads divide ``model``): the heads over ``model``,
    ``q_start`` 0.  k/v heads that do not divide ``model`` are expanded to
    Hq first (replicated, then each rank keeps its q heads' copies).

    Context mode (they do not), the JAX package's layout: q keeps each
    ``model`` rank's rows of the sequence (torch's ``chunk`` sizes where
    ``model`` does not divide S) and k, v are all-gathered along the
    sequence over ``model`` (``gather_kv``).  They are gathered with
    their Hkv heads, G times fewer bytes than expanded (JAX's GSPMD
    gathers them expanded); ``attend`` expands them on the rank.  Each
    rank's K/V gradient covers its own queries only, so it is declared a
    partial sum over ``model``: the gather's backward is a reduce-scatter
    of dK and dV.  The output leaves split along the sequence.

    The training step's ``attend`` is ``sdpa`` (or ``sdpa_qchunked``),
    the prefill's K8."""
    from repro_torch.parallel import sharding as sh
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq % mi.n_model:
        place = sh.seq_rows(q, mi)
        q = q.redistribute(mi.mesh, place)
        k, v = gather_kv(k, v, mi)
        kl, vl = (sh.local(t, mi, (mi.model_axis,)) for t in (k, v))
        out = attend(q.to_local(), kl, vl, sh.local_offset(q)[1])
        return sh.from_local(out, mi, place, q.shape)
    place = _head_places(mi, True)
    if Hkv % mi.n_model:
        whole = _head_places(mi, False)
        k = layers.repeat_heads(k.redistribute(mi.mesh, whole), Hq // Hkv,
                                dim=2)
        v = layers.repeat_heads(v.redistribute(mi.mesh, whole), Hq // Hkv,
                                dim=2)
    ql, kl, vl = (t.redistribute(mi.mesh, place).to_local()
                  for t in (q, k, v))
    return sh.from_local(attend(ql, kl, vl, 0), mi, place, q.shape)


def sdpa_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask_bias: torch.Tensor, *,
                 soft_cap: float | None = None) -> torch.Tensor:
    """Grouped-query form (decode): never expands the KV cache.
    q [B, Sq, Hq, Dh]; k/v [B, Sk, Hkv, Dh]; mask_bias [B, Sq, Sk]."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * Dh ** -0.5,
                          k.float())
    if soft_cap is not None:
        logits = torch.tanh(logits / soft_cap) * soft_cap
    logits = logits + mask_bias[:, None, None, :, :]
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, Dh)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """[B, S, Hq, Dh] x wo [Hq, Dh, d] -> [B, S, d]."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[2])


def attention_rows(p: dict, x, cos: torch.Tensor, sin: torch.Tensor, mi,
                   attend):
    """A context-mode attention block on each ``model`` rank's rows of the
    sequence, as the JAX package's GSPMD runs it: DTensor x [B, S, d]
    split along the sequence (``sharding.seq_rows``; a slice where it is
    whole), the QKV projections with RoPE (``cos``/``sin`` [B, S, Dh/2],
    the rank's rows taken) and the output projection on the rank's rows,
    K and V gathered along the sequence (``gather_kv``) and
    ``sdpa_sharded``'s context branch with ``attend``.  The projections
    run on local tensors (DTensor's matmul of a [B, S, d] split over two
    dims flattens both into one, which it cannot always view back), the
    weights gathered whole first (replicated, or split for FSDP) and
    their gradients declared partial sums over every mesh axis, since
    each rank projects its own rows; each weight's gradient is reduced
    straight into ZeRO's layout (``sharding.zero_places``), so no rank
    holds the whole gradients of its replicated attention weights.
    Returns (out [B, S, d] split along the sequence, k, v [B, S, Hkv, Dh]
    whole along it)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.parallel import sharding as sh
    axes = tuple(mi.mesh.mesh_dim_names)
    whole = [Replicate()] * mi.mesh.ndim

    def w_local(w):
        if not isinstance(w, DTensor):
            return w
        w = sh.grad_as(w, sh.zero_places(w, mi))
        if any(not isinstance(pl, Replicate) for pl in w.placements):
            w = w.redistribute(mi.mesh, whole)
        return sh.local(w, mi, axes)

    x = x.redistribute(mi.mesh, sh.seq_rows(x, mi))
    b0, s0 = sh.local_offset(x)[:2]
    xl = sh.local(x, mi)
    B, S = x.shape[:2]
    rows = (slice(b0, b0 + xl.shape[0]), slice(s0, s0 + xl.shape[1]))
    wl = {name: w_local(w) for name, w in p.items() if name != "wo"}
    q, k, v = (sh.from_local(t, mi, x.placements, (B, S, *t.shape[2:]))
               for t in project_qkv(wl, xl, cos[rows], sin[rows]))
    k, v = gather_kv(k, v, mi)
    out = sdpa_sharded(q, k, v, mi, attend)
    y = _out_proj(sh.local(out, mi), w_local(p["wo"]))
    return sh.from_local(y, mi, x.placements, x.shape), k, v


def attention(p: dict, x: torch.Tensor, positions: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor, *,
              window: int | None = None, soft_cap: float | None = None):
    """Full causal self-attention over a prompt x [B, S, d] on kernel K8.
    Returns (out [B, S, d], (k, v)).

    K8 masks by index, so ``positions`` must be 0..S-1 in every row, as
    the prefill gives them (they enter only through ``cos``/``sin``).  K8
    has no logit soft cap; no config of this path sets one."""
    if soft_cap is not None:
        raise NotImplementedError("attention: K8 has no logit soft cap")
    q, k, v = project_qkv(p, x, cos, sin)
    out = K8.flash_attention(q, k, v, causal=True, window=window or 0)
    return _out_proj(out, p["wo"]), (k, v)


def quantize_int8(u: torch.Tensor):
    """Per-head int8 of K/V rows u [..., Dh]: scale = max|u| / 127 in
    float32 (at least 1e-8), values round(u / scale) clipped to +-127.
    Returns (int8 [..., Dh], float32 scales [...])."""
    uf = u.float()
    sc = torch.clamp(uf.abs().amax(dim=-1) / 127.0, min=1e-8)
    return (torch.clamp(torch.round(uf / sc[..., None]), -127, 127)
            .to(torch.int8), sc)


def decode_attention(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos_cache: torch.Tensor,
                     positions: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, *, window: int | None = None,
                     soft_cap: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None):
    """One-token decode against a dense or ring-buffer KV cache.

    x [B, 1, d]; k/v_cache [B, Smax, Hkv, Dh]; pos_cache int32 [B, Smax],
    the token position each slot holds (-1 = empty); positions [B, 1].
    The new K/V are written at slot ``position % Smax`` *in place* (the
    JAX function returns new arrays; the port updates the caches it was
    given, so decode never copies a cache).  With int8 caches (k/v_scale
    given, float32 [B, Smax, Hkv]) the new K/V quantize on write
    (``quantize_int8``) and the attention reads the cache dequantized in
    float32.  Returns (out [B, 1, d], k_cache, v_cache, pos_cache[,
    k_scale, v_scale])."""
    B = x.shape[0]
    Smax = k_cache.shape[1]
    q, k_new, v_new = project_qkv(p, x, cos, sin)
    b_idx = torch.arange(B, device=x.device)
    pos = positions[:, 0]
    slot = pos.long() % Smax
    quantized = k_scale is not None
    if quantized:
        k8, ks = quantize_int8(k_new[:, 0])
        v8, vs = quantize_int8(v_new[:, 0])
        k_cache[b_idx, slot] = k8
        v_cache[b_idx, slot] = v8
        k_scale[b_idx, slot] = ks
        v_scale[b_idx, slot] = vs
        k_read = k_cache.float() * k_scale[..., None]
        v_read = v_cache.float() * v_scale[..., None]
    else:
        k_cache[b_idx, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[b_idx, slot] = v_new[:, 0].to(v_cache.dtype)
        k_read, v_read = k_cache, v_cache
    pos_cache[b_idx, slot] = pos.to(pos_cache.dtype)

    valid = (pos_cache >= 0) & (pos_cache <= pos[:, None])
    if window is not None and window > 0:
        valid = valid & ((pos[:, None] - pos_cache) < window)
    bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, :]
    out = sdpa_grouped(q, k_read, v_read, bias, soft_cap=soft_cap)
    out = _out_proj(out.to(x.dtype), p["wo"])
    if quantized:
        return out, k_cache, v_cache, pos_cache, k_scale, v_scale
    return out, k_cache, v_cache, pos_cache


def decode_attention_sharded(p: dict, x, cache: dict, pos: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor, mi, *,
                             window: int | None = None,
                             soft_cap: float | None = None):
    """``decode_attention`` over ``mi``'s mesh: x [B, 1, d] and the weights
    DTensors, ``cache`` a dict of DTensors (``k``/``v`` [B, W, Hkv, Dh],
    ``pos`` [B, W], int8 scales [B, W, Hkv]) laid out by
    ``sharding.decode_state_specs``, ``pos`` the plain int32 [B] positions
    of the new tokens.  q, k and v are gathered over the heads (one token:
    a few hundred bytes a row) onto the cache's batch layout.  Each rank
    owns a contiguous slot range of each sequence it holds (the whole
    cache where the slots are not split); it writes the new token's K/V
    there, in place, only if ``pos % W`` falls in its range, and attends
    over its slots.  Where the slots are split, the ranks' partial max,
    sum and P.V are merged over the splitting mesh dims with functional
    collectives (distributed flash-decode); where they are not, the
    attention is ``sdpa_grouped``'s, bit for bit.  Returns (out [B, 1, d]
    DTensor, cache)."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.parallel import sharding as sh
    kc = cache["k"]
    W = kc.shape[1]
    rows = sh.like_batch(kc)
    q, k_new, v_new = project_qkv(p, x, cos, sin)
    ql, kn, vn = (t.redistribute(mi.mesh, rows).to_local()
                  for t in (q, k_new, v_new))
    b0, lo = sh.local_offset(kc)[:2]
    loc = {name: t.to_local() for name, t in cache.items()}
    Bl, Wl = loc["k"].shape[:2]
    pl = pos[b0:b0 + Bl]
    b_idx = torch.arange(Bl, device=pl.device)
    slot = pl.long() % W
    mine = (slot >= lo) & (slot < lo + Wl)
    at = (slot - lo).clamp(0, max(Wl - 1, 0))

    def write(name, new):
        t = loc[name]
        m = mine.reshape(-1, *([1] * (new.dim() - 1)))
        t[b_idx, at] = torch.where(m, new.to(t.dtype), t[b_idx, at])

    quantized = "k_scale" in loc
    if quantized:
        k8, ks = quantize_int8(kn[:, 0])
        v8, vs = quantize_int8(vn[:, 0])
        for name, new in (("k", k8), ("v", v8), ("k_scale", ks),
                          ("v_scale", vs)):
            write(name, new)
        k_read = loc["k"].float() * loc["k_scale"][..., None]
        v_read = loc["v"].float() * loc["v_scale"][..., None]
    else:
        write("k", kn[:, 0])
        write("v", vn[:, 0])
        k_read, v_read = loc["k"], loc["v"]
    write("pos", pl)
    pc = loc["pos"]
    valid = (pc >= 0) & (pc <= pl[:, None])
    if window is not None and window > 0:
        valid = valid & ((pl[:, None] - pc) < window)
    bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, :]
    split = sh.split_dims(kc, 1)
    if all(mi.mesh.size(d) == 1 for d in split):
        out = sdpa_grouped(ql, k_read, v_read, bias, soft_cap=soft_cap)
    else:
        _, Sq, Hq, Dh = ql.shape
        Hkv = k_read.shape[2]
        qg = ql.reshape(Bl, Sq, Hkv, Hq // Hkv, Dh)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * Dh ** -0.5,
                              k_read.float())
        if soft_cap is not None:
            logits = torch.tanh(logits / soft_cap) * soft_cap
        logits = logits + bias[:, None, None, :, :]
        m = logits.amax(dim=-1, keepdim=True)               # [b,h,g,q,1]
        e = torch.exp(logits - m)
        s = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bkhd->bhgqd", e, v_read.float())
        big = m
        for d in split:
            big = funcol.all_reduce(big, "max", (mi.mesh, d))
        corr = torch.exp(m - big)
        s, o = s * corr, o * corr
        for d in split:
            s = funcol.all_reduce(s, "sum", (mi.mesh, d))
            o = funcol.all_reduce(o, "sum", (mi.mesh, d))
        out = (o / s).permute(0, 3, 1, 2, 4).reshape(Bl, Sq, Hq, Dh)
        out = out.to(v_read.dtype)
    out = sh.from_local(out, mi, rows, q.shape)
    return _out_proj(out.to(x.dtype), p["wo"]), cache
