"""K1 — paged attention over the memos-managed KV page pool: decode and
packed prefill, over one pool or two.

``paged_attention`` is the engine-facing decode wrapper (q [B, Hq, D],
scaled here); ``paged_attention_pooled`` takes q pre-scaled as
[B, Hkv, G, D], like the Pallas kernel it replaces
(``repro.kernels.paged_attention.paged_attention.paged_attention_pooled``).
``paged_attention_prefill`` / ``_prefill_pooled`` take the JAX
``paged_attention_prefill`` signature: one query row per packed position
of a prefill bucket, each with its own segment's block table and its
causal prefix as its length.  On CUDA tensors they launch the decode or
the prefill body of ``csrc/paged_attention.cu``; on CPU tensors they run
``paged_attention_plain``, the gather + fp32 softmax reference
(``repro.kernels.paged_attention.ref.paged_attention_ref``), which
computes both.

The pools may be strided views — the engine passes
``pool[:, layer, 0]`` of the [slots, L, 2, page, Hkv, D] page pool — and
are never copied: the kernels take their slot/row/head strides.

``paged_attention_dual`` and ``paged_attention_prefill_dual`` are the
dual-pool variants of the pinned-host NVM tier: each page of a table
lives either in the tier-0 pool or in a second pool (``pool_sel`` = 1),
which on the card is pinned host memory read in place through its mapped
device address.  The JAX package gathers both pools and selects per page
before attending (``repro.serving.engine._decode_core_pinned`` over
``paged_attention_pages``, ``paged_attention_prefill_pages``);
``paged_attention_dual_plain`` is that computation.  The kernels choose
a base pointer per page and nothing else, so the dual form is
bit-identical to the single-pool one on the same pages.

The decode and prefill bodies sum in different orders, so a prefill
position no longer equals a decode step at that position bitwise (the
JAX docstring of ``paged_attention_prefill`` promises that); the two
agree within the float tolerance.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_C] * 6 + [_I] * 6 + [_L] * 6 + [_C]
_DUAL_ARGTYPES = [_C] * 9 + [_I] * 6 + [_L] * 12 + [_C]
# (prefill, dual) -> the launch count's name; its C entries add _f32/_bf16
_NAMES = {(False, False): "paged_attention",
          (False, True): "paged_attention_dual",
          (True, False): "paged_attention_prefill",
          (True, True): "paged_attention_prefill_dual"}
_SUFFIX = {torch.float32: "_f32", torch.bfloat16: "_bf16"}
MAX_G = 8
MAX_D = 256


def launch_info(prefill: bool, dual: bool, dtype: torch.dtype, rows: int,
                Hkv: int, G: int, D: int) -> dict:
    """How the body for these shapes launches on the current card (the
    plan ``csrc/paged_attention.cu`` launches with; builds the kernels):
    grid CTAs, threads per CTA, dynamic shared memory bytes, CTAs
    resident per SM by the occupancy calculator, and the cluster size.
    ``rows`` is B for decode, the bucket's L for prefill.  Shared memory
    depends on G and D only: pages stream through the rings in blocks of
    16 keys, so every page size is taken."""
    info = (ctypes.c_int * 5)()
    fn = _build.function("paged_attention_launch_info",
                         [_I] * 7 + [ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(int(prefill), int(dual), int(dtype == torch.bfloat16),
                    rows, Hkv, G, D, info), "paged_attention_launch_info")
    ctas, threads, smem, per_sm, cluster = info
    return {"ctas": ctas, "threads": threads, "smem_bytes": smem,
            "ctas_per_sm": per_sm, "cluster": cluster}


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Gather the pages, attend densely in fp32 with positions >= lengths
    masked to -1e30.  q pre-scaled [B, Hkv, G, D] -> [B, Hkv, G, D]."""
    bt = block_table.long()
    return _attend_pages(q, k_pool[bt], v_pool[bt], lengths)


def paged_attention_dual_plain(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, k_pool2: torch.Tensor,
                               v_pool2: torch.Tensor,
                               block_table: torch.Tensor,
                               pool_sel: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Gather each page from both pools (indices clamped into each
    pool; the second pool may lie in host memory), keep the one
    ``pool_sel`` names, attend as the single-pool version does."""
    bt = block_table.long()
    sel = (pool_sel > 0)[:, :, None, None, None]
    b1 = bt.clamp(0, k_pool.shape[0] - 1)
    b2 = bt.clamp(0, k_pool2.shape[0] - 1).to(k_pool2.device)
    k = torch.where(sel, k_pool2[b2].to(k_pool.device, k_pool.dtype),
                    k_pool[b1])
    v = torch.where(sel, v_pool2[b2].to(v_pool.device, v_pool.dtype),
                    v_pool[b1])
    return _attend_pages(q, k, v, lengths)


def _attend_pages(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, lengths: torch.Tensor
                  ) -> torch.Tensor:
    """Attention over pre-gathered pages [B, n_pages, page, Hkv, D] (the
    JAX ``paged_attention_pages_ref``)."""
    B, Hkv, G, D = q.shape
    n_pages, page = k_pages.shape[1:3]
    k = k_pages.reshape(B, n_pages * page, Hkv, D).float()
    v = v_pages.reshape(B, n_pages * page, Hkv, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k)
    pos = torch.arange(n_pages * page, device=q.device)
    s = s.masked_fill(pos[None, None, None, :]
                      >= lengths.long()[:, None, None, None], -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", w, v).to(q.dtype)


def _launch(q, k_pool, v_pool, block_table, lengths, k_pool2, v_pool2,
            pool_sel, prefill: bool) -> torch.Tensor:
    """Validate and launch K1's decode or prefill body; with a second
    pool and ``pool_sel`` its dual-pool entry (the second pool may be
    pinned host memory)."""
    B, Hkv, G, D = q.shape
    n_slots, page, hkv_pool, d_pool = k_pool.shape
    P = block_table.shape[1]
    dev = q.device
    dual = pool_sel is not None
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {dev}")
    if dual:
        for name, t in (("k_pool2", k_pool2), ("v_pool2", v_pool2)):
            if t.dtype != k_pool.dtype or t.shape[1:] != k_pool.shape[1:] \
                    or t.stride(3) != 1:
                raise ValueError(f"paged_attention: {name} "
                                 f"{t.dtype} {tuple(t.shape)} does not match "
                                 f"k_pool {k_pool.dtype} "
                                 f"{tuple(k_pool.shape)} with unit-stride "
                                 f"head_dim")
        if pool_sel.dtype != torch.int32 or pool_sel.device != dev \
                or pool_sel.shape != block_table.shape \
                or not pool_sel.is_contiguous():
            raise ValueError("paged_attention: pool_sel must be a "
                             "contiguous int32 tensor shaped like "
                             "block_table on q's device")
    if q.dtype not in _SUFFIX or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}")
    if v_pool.shape != k_pool.shape or (hkv_pool, d_pool) != (Hkv, D):
        raise ValueError(f"paged_attention: pool shapes {tuple(k_pool.shape)}"
                         f"/{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: block_table and lengths must be "
                        "int32")
    if block_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_attention: block_table/lengths batch does "
                         "not match q")
    if not (q.is_contiguous() and block_table.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("paged_attention: q, block_table and lengths must "
                         "be contiguous")
    if k_pool.stride(3) != 1 or v_pool.stride(3) != 1:
        raise ValueError("paged_attention: pool head_dim must be unit-stride")
    if not 1 <= G <= MAX_G or not 8 <= D <= MAX_D or D % 8:
        raise ValueError(f"paged_attention: G={G} (max {MAX_G}), D={D} "
                         f"(a multiple of 8, max {MAX_D}) outside the "
                         f"kernel's range")
    # the kernels copy K/V rows 16 bytes at a time (a pinned pool's mapped
    # device address has its host address's offset within the allocation)
    el = q.element_size()
    for t in (k_pool, v_pool) + ((k_pool2, v_pool2) if dual else ()):
        st = t.stride()
        if t.data_ptr() % 16 or (st[0] * el) % 16 or (st[1] * el) % 16 \
                or (st[2] * el) % 16:
            raise ValueError("paged_attention: a pool's base or slot/row/"
                             "head stride is not 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:                  # nothing to launch, nothing counted
        return out
    ks, vs = k_pool.stride(), v_pool.stride()
    stream = _build.current_stream(dev.index)
    name = _NAMES[(prefill, dual)]
    fn_name = name + _SUFFIX[q.dtype]
    if not dual:
        fn = _build.function(fn_name, _ARGTYPES)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 B, Hkv, G, D, page, P, ks[0], ks[1], ks[2], vs[0], vs[1],
                 vs[2], stream)
    else:
        k2s, v2s = k_pool2.stride(), v_pool2.stride()
        fn = _build.function(fn_name, _DUAL_ARGTYPES)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 _build.device_address(k_pool2),
                 _build.device_address(v_pool2), block_table.data_ptr(),
                 pool_sel.data_ptr(), lengths.data_ptr(), out.data_ptr(), B,
                 Hkv, G, D, page, P, ks[0], ks[1], ks[2], vs[0], vs[1],
                 vs[2], k2s[0], k2s[1], k2s[2], v2s[0], v2s[1], v2s[2],
                 stream)
    _build.check(err, fn_name)
    count_launch(name)
    return out


def _pooled(prefill: bool, q, k_pool, v_pool, block_table, lengths,
            k_pool2=None, v_pool2=None, pool_sel=None) -> torch.Tensor:
    """The plain version for CPU tensors, else the kernel (or raise)."""
    if q.device.type == "cpu":
        if pool_sel is None:
            return paged_attention_plain(q, k_pool, v_pool, block_table,
                                         lengths)
        return paged_attention_dual_plain(q, k_pool, v_pool, k_pool2,
                                          v_pool2, block_table, pool_sel,
                                          lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, block_table, lengths, k_pool2, v_pool2,
                   pool_sel, prefill)


def _grouped(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """Engine queries [rows, Hq, D] scaled by D**-0.5 and grouped as
    [rows, Hkv, G, D]."""
    B, Hq, D = q.shape
    return (q * D ** -0.5).reshape(B, Hkv, Hq // Hkv, D)


def paged_attention_pooled(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q pre-scaled [B, Hkv, G, D]; k/v_pool [n_slots, page, Hkv, D];
    block_table int32 [B, n_pages]; lengths int32 [B] -> [B, Hkv, G, D].
    A row of length 0 gives zeros on the card (the plain version the
    mean of its masked values)."""
    return _pooled(False, q, k_pool, v_pool, block_table, lengths)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D] decode queries; k/v_pool [n_slots, page, Hkv, D];
    block_table [B, n_pages]; lengths [B].  Returns [B, Hq, D]."""
    out = paged_attention_pooled(_grouped(q, k_pool.shape[2]), k_pool,
                                 v_pool, block_table, lengths)
    return out.reshape(q.shape)


def paged_attention_dual_pooled(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, k_pool2: torch.Tensor,
                                v_pool2: torch.Tensor,
                                block_table: torch.Tensor,
                                pool_sel: torch.Tensor,
                                lengths: torch.Tensor) -> torch.Tensor:
    """q pre-scaled [B, Hkv, G, D]; k/v_pool [n_slots, page, Hkv, D] (tier
    0) and k/v_pool2 [n_slots2, page, Hkv, D]; block_table int32 [B, P]
    holds each page's slot in its own pool and pool_sel int32 [B, P] is 1
    for the second pool -> [B, Hkv, G, D]."""
    return _pooled(False, q, k_pool, v_pool, block_table, lengths, k_pool2,
                   v_pool2, pool_sel)


def paged_attention_dual(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, k_pool2: torch.Tensor,
                         v_pool2: torch.Tensor, block_table: torch.Tensor,
                         pool_sel: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """The engine-facing dual-pool decode: q [B, Hq, D] decode queries,
    scaled here.  Returns [B, Hq, D]."""
    out = paged_attention_dual_pooled(_grouped(q, k_pool.shape[2]), k_pool,
                                      v_pool, k_pool2, v_pool2, block_table,
                                      pool_sel, lengths)
    return out.reshape(q.shape)


def paged_attention_prefill_pooled(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   row_tables: torch.Tensor,
                                   lengths: torch.Tensor) -> torch.Tensor:
    """Packed prefill, q pre-scaled [L, Hkv, G, D]: row i attends through
    its own table row_tables[i] (int32 [L, Pp], the pages of its
    segment) to positions < lengths[i] (its causal prefix; 0 for a
    padding row, which gives zeros on the card).  -> [L, Hkv, G, D]."""
    return _pooled(True, q, k_pool, v_pool, row_tables, lengths)


def paged_attention_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, row_tables: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """The JAX ``paged_attention_prefill``: q [L, Hq, D], one row per
    packed position, scaled here; row_tables [L, Pp]; lengths [L].
    Returns [L, Hq, D]."""
    out = paged_attention_prefill_pooled(_grouped(q, k_pool.shape[2]),
                                         k_pool, v_pool, row_tables, lengths)
    return out.reshape(q.shape)


def paged_attention_prefill_dual_pooled(q: torch.Tensor,
                                        k_pool: torch.Tensor,
                                        v_pool: torch.Tensor,
                                        k_pool2: torch.Tensor,
                                        v_pool2: torch.Tensor,
                                        row_tables: torch.Tensor,
                                        pool_sel: torch.Tensor,
                                        lengths: torch.Tensor
                                        ) -> torch.Tensor:
    """The packed prefill over two pools: row_tables [L, Pp] hold each
    page's slot in its own pool, pool_sel [L, Pp] is 1 for the second."""
    return _pooled(True, q, k_pool, v_pool, row_tables, lengths, k_pool2,
                   v_pool2, pool_sel)


def paged_attention_prefill_dual(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, k_pool2: torch.Tensor,
                                 v_pool2: torch.Tensor,
                                 row_tables: torch.Tensor,
                                 pool_sel: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """The JAX ``paged_attention_prefill_pages`` over the two pools in
    place: q [L, Hq, D] scaled here.  Returns [L, Hq, D]."""
    out = paged_attention_prefill_dual_pooled(
        _grouped(q, k_pool.shape[2]), k_pool, v_pool, k_pool2, v_pool2,
        row_tables, pool_sel, lengths)
    return out.reshape(q.shape)
