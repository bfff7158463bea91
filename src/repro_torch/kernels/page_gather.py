"""K3 — page gather / scatter, the migration engine's data mover.

Replaces ``repro.kernels.page_gather.page_gather.page_gather_pallas``
(``staging[i] = pool[idx[i]]``) and ``page_scatter_pallas``
(``pool[idx[i]] = pages[i]``, in place, other slots untouched).  CUDA
tensors launch ``csrc/page_gather.cu``; CPU tensors take the plain
indexing versions.  Index vectors arrive pow2-padded by repeating the
last slot (``core/tiers.py``), which both versions tolerate: a repeated
scatter index carries an identical page.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_C = ctypes.c_void_p
_GATHER_ARGS = [_C, _C, _C, ctypes.c_int, ctypes.c_longlong, _C]


def page_gather_plain(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return pool[idx.long()]


def page_scatter_plain(pool: torch.Tensor, idx: torch.Tensor,
                       pages: torch.Tensor) -> torch.Tensor:
    pool[idx.long()] = pages
    return pool


def _check(pool: torch.Tensor, idx: torch.Tensor, name: str) -> None:
    if not pool.is_contiguous():
        raise ValueError(f"{name}: pool must be contiguous")
    if idx.dtype != torch.int32 or idx.dim() != 1 \
            or not idx.is_contiguous() or idx.device != pool.device:
        raise ValueError(f"{name}: idx must be a contiguous int32 vector "
                         f"on {pool.device}")


def _page_bytes(pool: torch.Tensor) -> int:
    return pool[0].numel() * pool.element_size() if pool.shape[0] else 0


def page_gather(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """staging[i] = pool[idx[i]].  idx int32 [k] -> [k, *page_shape]."""
    if pool.device.type == "cpu":
        return page_gather_plain(pool, idx)
    if pool.device.type != "cuda":
        raise ValueError(f"page_gather: unsupported device {pool.device}")
    _check(pool, idx, "page_gather")
    out = torch.empty((idx.shape[0], *pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    if out.numel() == 0:               # nothing to launch, nothing counted
        return out
    fn = _build.function("page_gather", _GATHER_ARGS)
    err = fn(pool.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
             _page_bytes(pool), torch.cuda.current_stream(pool.device)
             .cuda_stream)
    _build.check(err, "page_gather")
    count_launch("page_gather")
    return out


def page_scatter(pool: torch.Tensor, idx: torch.Tensor,
                 pages: torch.Tensor) -> torch.Tensor:
    """pool[idx[i]] = pages[i] in place; returns ``pool``."""
    if pool.device.type == "cpu":
        return page_scatter_plain(pool, idx, pages)
    if pool.device.type != "cuda":
        raise ValueError(f"page_scatter: unsupported device {pool.device}")
    _check(pool, idx, "page_scatter")
    if pages.dtype != pool.dtype or pages.device != pool.device \
            or not pages.is_contiguous() \
            or tuple(pages.shape) != (idx.shape[0], *pool.shape[1:]):
        raise ValueError(f"page_scatter: pages must be a contiguous "
                         f"{pool.dtype} [{idx.shape[0]}, *page] tensor on "
                         f"{pool.device}, got {pages.dtype} "
                         f"{tuple(pages.shape)}")
    if pages.numel() == 0:
        return pool
    fn = _build.function("page_scatter", _GATHER_ARGS)
    err = fn(pool.data_ptr(), idx.data_ptr(), pages.data_ptr(),
             idx.shape[0], _page_bytes(pool),
             torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(err, "page_scatter")
    count_launch("page_scatter")
    return pool
