"""K1 — paged decode attention over the memos-managed KV page pool.

``paged_attention`` is the engine-facing wrapper (q [B, Hq, D], scaled
here); ``paged_attention_pooled`` takes q pre-scaled as [B, Hkv, G, D],
like the Pallas kernel it replaces
(``repro.kernels.paged_attention.paged_attention.paged_attention_pooled``).
On CUDA tensors it launches ``csrc/paged_attention.cu``; on CPU tensors
it runs ``paged_attention_plain``, the gather + fp32 softmax reference
(``repro.kernels.paged_attention.ref.paged_attention_ref``).

The pools may be strided views — the engine passes
``pool[:, layer, 0]`` of the [slots, L, 2, page, Hkv, D] page pool — and
are never copied: the kernel takes their slot/row/head strides.
``lengths[b]`` must be >= 1.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_C] * 6 + [_I] * 6 + [_L] * 6 + [_C]
_FN = {torch.float32: "paged_attention_f32",
       torch.bfloat16: "paged_attention_bf16"}
MAX_G = 8
MAX_D = 256


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Gather the pages, attend densely in fp32 with positions >= lengths
    masked to -1e30.  q pre-scaled [B, Hkv, G, D] -> [B, Hkv, G, D]."""
    B, Hkv, G, D = q.shape
    page = k_pool.shape[1]
    n_pages = block_table.shape[1]
    bt = block_table.long()
    k = k_pool[bt].reshape(B, n_pages * page, Hkv, D).float()
    v = v_pool[bt].reshape(B, n_pages * page, Hkv, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k)
    pos = torch.arange(n_pages * page, device=q.device)
    s = s.masked_fill(pos[None, None, None, :]
                      >= lengths.long()[:, None, None, None], -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", w, v).to(q.dtype)


def _launch(q, k_pool, v_pool, block_table, lengths) -> torch.Tensor:
    B, Hkv, G, D = q.shape
    n_slots, page, hkv_pool, d_pool = k_pool.shape
    P = block_table.shape[1]
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {dev}")
    if q.dtype not in _FN or k_pool.dtype != q.dtype \
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
    if not 1 <= G <= MAX_G or not 1 <= D <= MAX_D:
        raise ValueError(f"paged_attention: G={G} (max {MAX_G}), D={D} "
                         f"(max {MAX_D}) outside the kernel's range")
    if 4 * (G * D + G * page + 3 * G) > 48 * 1024:
        raise ValueError("paged_attention: page too large for the kernel's "
                         "shared-memory tile")
    out = torch.empty_like(q)
    if q.numel() == 0:                  # nothing to launch, nothing counted
        return out
    fn = _build.function(_FN[q.dtype], _ARGTYPES)
    ks, vs = k_pool.stride(), v_pool.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             B, Hkv, G, D, page, P, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
             stream)
    _build.check(err, _FN[q.dtype])
    count_launch("paged_attention")
    return out


def paged_attention_pooled(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q pre-scaled [B, Hkv, G, D]; k/v_pool [n_slots, page, Hkv, D];
    block_table int32 [B, n_pages]; lengths int32 [B] -> [B, Hkv, G, D]."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, block_table, lengths)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D] decode queries; k/v_pool [n_slots, page, Hkv, D];
    block_table [B, n_pages]; lengths [B].  Returns [B, Hq, D]."""
    B, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    qg = (q * D ** -0.5).reshape(B, Hkv, Hq // Hkv, D)
    out = paged_attention_pooled(qg, k_pool, v_pool, block_table, lengths)
    return out.reshape(B, Hq, D)
