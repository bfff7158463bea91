"""K5 — per-page integrity checksum over the stored bits.

Replaces ``repro.kernels.page_checksum.page_checksum.page_checksum_pallas``:
``checksums[i] = sum_j u[j] * (2*j + 1) mod 2**32`` over page
``pool[idx[i]]`` viewed as unsigned integers of its element width
(float32 as uint32, bfloat16 as uint16, int8 as uint8), the definition
in ``repro.kernels.page_checksum.ref``.  Every weight is odd, so any
single-bit flip of a page changes its checksum.

The index vector says where the work runs.  On the card
``csrc/page_checksum.cu`` reads the pool in place — in HBM, or in pinned
host memory through its mapped device address — and returns uint32
sums; CPU tensors take ``page_checksum_plain`` (int64 accumulation, then
``& 0xFFFFFFFF``; two's-complement wraparound of the int64 sum keeps the
low 32 bits exact).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, count_launch

_C = ctypes.c_void_p
_ARGTYPES = [_C, _C, _C, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _C]
# stored bits of each element width, as a signed view and its mask
_BITS = {1: (torch.uint8, 0xFF), 2: (torch.int16, 0xFFFF),
         4: (torch.int32, 0xFFFFFFFF)}
_UINT_NP = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def checksum_np(pages: np.ndarray) -> np.ndarray:
    """Numpy checksum of host pages in storage format: [k, *page]
    (any <=4-byte dtype) -> uint32 [k]; the host tiers' form."""
    itemsize = pages.dtype.itemsize
    if itemsize not in _UINT_NP:
        raise TypeError(f"unsupported element width {itemsize} bytes")
    u = np.ascontiguousarray(pages).view(_UINT_NP[itemsize])
    u = u.reshape(pages.shape[0], -1).astype(np.uint32)
    w = 2 * np.arange(u.shape[1], dtype=np.uint32) + 1
    return (u * w[None, :]).sum(axis=1, dtype=np.uint32)


def _stored_bits(pages: torch.Tensor) -> torch.Tensor:
    """[k, N] int64 unsigned values of each element's stored bits."""
    width = pages.element_size()
    if width not in _BITS:
        raise TypeError(f"page_checksum: unsupported element width {width}")
    view, mask = _BITS[width]
    return pages.reshape(pages.shape[0], -1).view(view).long() & mask


def page_checksum_plain(pool: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """Gather the pages where the pool lies, sum on idx's device."""
    u = _stored_bits(pool[idx.to(pool.device).long()].to(idx.device))
    w = 2 * torch.arange(u.shape[1], dtype=torch.int64,
                         device=u.device) + 1
    s = (u * w).sum(dim=1) & 0xFFFFFFFF
    # the low 32 bits, reinterpreted (int64 -> int32 keeps them)
    return s.to(torch.int32).view(torch.uint32)


def page_checksum(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """checksums[i] = checksum(pool[idx[i]]); idx int32 [k] -> uint32 [k]
    on idx's device."""
    if idx.device.type == "cpu" and pool.device.type == "cpu":
        return page_checksum_plain(pool, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"page_checksum: idx on {idx.device} with a pool "
                         f"on {pool.device}")
    if not pool.is_contiguous():
        raise ValueError("page_checksum: pool must be contiguous")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("page_checksum: idx must be a contiguous int32 "
                         "vector")
    width = pool.element_size()
    if width not in _BITS:
        raise TypeError(f"page_checksum: unsupported element width {width}")
    out = torch.zeros(idx.shape[0], dtype=torch.int32, device=idx.device)
    page_bytes = pool[0].numel() * width if pool.shape[0] else 0
    if out.numel() == 0 or page_bytes == 0:   # nothing launched or counted
        return out.view(torch.uint32)
    fn = _build.function("page_checksum", _ARGTYPES)
    err = fn(_build.device_address(pool), idx.data_ptr(), out.data_ptr(),
             idx.shape[0], page_bytes, width,
             _build.current_stream(idx.device.index))
    _build.check(err, "page_checksum")
    count_launch("page_checksum")
    return out.view(torch.uint32)
