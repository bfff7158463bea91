"""K3 — page gather / scatter, the migration engine's data mover.

Replaces ``repro.kernels.page_gather.page_gather.page_gather_pallas``
(``staging[i] = pool[idx[i]]``) and ``page_scatter_pallas``
(``pool[idx[i]] = pages[i]``, in place, other slots untouched).  CUDA
tensors launch ``csrc/page_gather.cu``; CPU tensors take the plain
indexing versions.  Index vectors arrive pow2-padded by repeating the
last slot (``core/tiers.py``), which both versions tolerate: a repeated
scatter index carries an identical page.

The index vector says where the work runs: on the CPU both tensors lie
on the CPU; on the card the pool lies in HBM or in pinned host memory
(the pinned-host NVM tier), which the kernel reads and writes in place
through its mapped device address (``_build.device_address``).
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


def _on_cpu(pool: torch.Tensor, idx: torch.Tensor, name: str) -> bool:
    """True when both tensors lie on the CPU (the plain version runs);
    False when idx lies on the card (the kernel runs); raises otherwise."""
    if idx.device.type == "cpu" and pool.device.type == "cpu":
        return True
    if idx.device.type != "cuda":
        raise ValueError(f"{name}: idx on {idx.device} with a pool on "
                         f"{pool.device}")
    return False


def _check(pool: torch.Tensor, idx: torch.Tensor, name: str) -> None:
    if not pool.is_contiguous():
        raise ValueError(f"{name}: pool must be contiguous")
    if idx.dtype != torch.int32 or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be a contiguous int32 vector")


def _page_bytes(pool: torch.Tensor) -> int:
    return pool[0].numel() * pool.element_size() if pool.shape[0] else 0


def page_gather(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """staging[i] = pool[idx[i]].  idx int32 [k] -> [k, *page_shape] on
    idx's device."""
    if _on_cpu(pool, idx, "page_gather"):
        return page_gather_plain(pool, idx)
    _check(pool, idx, "page_gather")
    out = torch.empty((idx.shape[0], *pool.shape[1:]), dtype=pool.dtype,
                      device=idx.device)
    if out.numel() == 0:               # nothing to launch, nothing counted
        return out
    fn = _build.function("page_gather", _GATHER_ARGS)
    err = fn(_build.device_address(pool), idx.data_ptr(), out.data_ptr(),
             idx.shape[0], _page_bytes(pool),
             _build.current_stream(idx.device.index))
    _build.check(err, "page_gather")
    count_launch("page_gather")
    return out


def page_scatter(pool: torch.Tensor, idx: torch.Tensor,
                 pages: torch.Tensor) -> torch.Tensor:
    """pool[idx[i]] = pages[i] in place; returns ``pool``."""
    if _on_cpu(pool, idx, "page_scatter"):
        return page_scatter_plain(pool, idx, pages)
    _check(pool, idx, "page_scatter")
    if pages.dtype != pool.dtype or pages.device != idx.device \
            or not pages.is_contiguous() \
            or tuple(pages.shape) != (idx.shape[0], *pool.shape[1:]):
        raise ValueError(f"page_scatter: pages must be a contiguous "
                         f"{pool.dtype} [{idx.shape[0]}, *page] tensor on "
                         f"{idx.device}, got {pages.dtype} "
                         f"{tuple(pages.shape)}")
    if pages.numel() == 0:
        return pool
    fn = _build.function("page_scatter", _GATHER_ARGS)
    err = fn(_build.device_address(pool), idx.data_ptr(), pages.data_ptr(),
             idx.shape[0], _page_bytes(pool),
             _build.current_stream(idx.device.index))
    _build.check(err, "page_scatter")
    count_launch("page_scatter")
    return pool
