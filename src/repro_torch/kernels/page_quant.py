"""K6 — fused page gather + per-page int8 quantize, and ``dequant_gather``,
its inverse: the data movers of the int8 soft-NVM tiers.

``page_gather_quant`` replaces
``repro.kernels.page_gather.page_gather.page_gather_quant_pallas``:
``scale[i] = max(absmax(pool[idx[i]]), 1e-8) / 127`` and
``q[i] = clip(round(pool[idx[i]] / scale[i]), -127, 127)`` in float32
(round half to even), the numpy host quantizer's bits
(``repro.core.tiers.HostPool.write_batch``).  ``dequant_gather`` is the
port's kernel for the XLA computation ``page_gather_dequant``:
``out[i] = float32(q[idx[i]]) * scale[idx[i]]``, written in the caller's
dtype (one rounding to bfloat16 for a bf16 HBM pool, the cast the JAX
scatter applies after it).

The index vector says where the work runs: CPU tensors take the plain
versions; on the card ``csrc/page_quant.cu`` reads the pool in place —
HBM, or pinned host memory through its mapped device address — and
allocates its outputs on idx's device.  K6 is one launch: a
thread-block cluster per page holds the page in its CTAs' shared memory
(``launch_info`` is the plan) and combines their absmax through
distributed shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_QUANT_ARGS = [_C] * 4 + [_I, _L, _I, _I, _L, _L, _I, _C]
_DEQUANT_ARGS = [_C] * 4 + [_I, _L, _I, _C]
_SRC_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 1024
UNIT = 16                   # values a thread quantizes into one 16-byte store
MAX_CLUSTER = 16            # non-portable cluster size (H100)
MIN_SLICE_BYTES = 32 * 1024  # the least a CTA of a cluster is given
# shared memory a CTA may stage: the 227 KB a block can use, less 1 KB
# for the kernel's static shared memory (the first launch of a plan has
# the card confirm it, and that its clusters fit)
SMEM_BYTES = 227 * 1024 - 1024


def launch_info(n_elems: int, elem_bytes: int, k: int,
                aligned: bool = True) -> dict:
    """K6's plan for k pages of ``n_elems`` values of ``elem_bytes``:
    a cluster of ``cluster`` CTAs per page (grid [cluster, k]), CTA r
    taking units [r * per, (r + 1) * per) of the page — units of 16
    values when the page is 16-byte aligned (``vec``), else single
    values — and staging the first ``held_units`` of them in
    ``smem_bytes`` of shared memory; the rest of its slice
    (``reread_units``) is read from the pool a second time.  Unaligned
    pages stage nothing."""
    vec = bool(aligned) and n_elems % UNIT == 0
    unit = UNIT if vec else 1
    units = n_elems // unit
    unit_bytes = unit * elem_bytes
    want = -(-n_elems * elem_bytes // MIN_SLICE_BYTES)
    cluster = max(1, min(MAX_CLUSTER, want, units))
    per = -(-units // cluster)
    cluster = -(-units // per)          # every CTA gets a non-empty slice
    held = min(per, SMEM_BYTES // unit_bytes) if vec else 0
    return {"cluster": cluster, "grid": [cluster, k], "threads": THREADS,
            "vec": vec, "unit_elems": unit, "units_per_cta": per,
            "slice_elems": per * unit, "held_units": held,
            "smem_bytes": held * unit_bytes, "reread_units": per - held}


def quantize_pages_plain(pages: torch.Tensor):
    """float pages [k, *page] -> (int8 [k, *page], float32 scale [k])."""
    x = pages.float().reshape(pages.shape[0], -1)
    amax = torch.clamp_min(x.abs().amax(dim=1), 1e-8)
    # tensor / tensor: on the card a division by a Python scalar runs as a
    # product with its reciprocal, which is not the quantizer's rounding
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(pages.shape), scale


def page_gather_quant_plain(pool: torch.Tensor, idx: torch.Tensor):
    return quantize_pages_plain(pool[idx.to(pool.device).long()].to(
        idx.device))


def dequant_gather_plain(pool_q: torch.Tensor, pool_scale: torch.Tensor,
                         idx: torch.Tensor, dtype: torch.dtype
                         ) -> torch.Tensor:
    i = idx.to(pool_q.device).long()
    q = pool_q[i].to(idx.device).float()
    s = pool_scale[i].to(idx.device).float()
    return (q * s.reshape((-1,) + (1,) * (q.dim() - 1))).to(dtype)


def _on_cpu(pool: torch.Tensor, idx: torch.Tensor, name: str) -> bool:
    """True when both tensors lie on the CPU (the plain version runs);
    False when idx lies on the card (the kernel runs); raises otherwise."""
    if idx.device.type == "cpu" and pool.device.type == "cpu":
        return True
    if idx.device.type != "cuda":
        raise ValueError(f"{name}: idx on {idx.device} with a pool on "
                         f"{pool.device}")
    if not pool.is_contiguous():
        raise ValueError(f"{name}: pool must be contiguous")
    if idx.dtype != torch.int32 or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be a contiguous int32 vector")
    return False


def page_gather_quant(pool: torch.Tensor, idx: torch.Tensor):
    """(q, scale) = quantize(pool[idx]); pool [slots, *page] float32 or
    bfloat16, idx int32 [k] -> int8 [k, *page] and float32 [k] on idx's
    device."""
    if _on_cpu(pool, idx, "page_gather_quant"):
        return page_gather_quant_plain(pool, idx)
    if pool.dtype not in _SRC_DTYPES:
        raise TypeError(f"page_gather_quant: pool dtype {pool.dtype} is "
                        f"not float32 or bfloat16")
    k = idx.shape[0]
    q = torch.empty((k, *pool.shape[1:]), dtype=torch.int8,
                    device=idx.device)
    scale = torch.empty(k, dtype=torch.float32, device=idx.device)
    n = pool[0].numel() if pool.shape[0] else 0
    if q.numel() == 0:                 # nothing to launch, nothing counted
        return q, scale
    base = _build.device_address(pool)
    plan = launch_info(n, pool.element_size(), k, aligned=base % 16 == 0)
    fn = _build.function("page_gather_quant", _QUANT_ARGS)
    err = fn(base, idx.data_ptr(), q.data_ptr(), scale.data_ptr(), k, n,
             pool.element_size(), plan["cluster"], plan["units_per_cta"],
             plan["held_units"], int(plan["vec"]),
             _build.current_stream(idx.device.index))
    _build.check(err, "page_gather_quant")
    count_launch("page_gather_quant")
    return q, scale


def dequant_gather(pool_q: torch.Tensor, pool_scale: torch.Tensor,
                   idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """out[i] = pool_q[idx[i]] * pool_scale[idx[i]] as ``dtype`` (float32
    or bfloat16); pool_q int8 [slots, *page], pool_scale float32 [slots],
    idx int32 [k] -> [k, *page] on idx's device."""
    if _on_cpu(pool_q, idx, "dequant_gather"):
        return dequant_gather_plain(pool_q, pool_scale, idx, dtype)
    if pool_q.dtype != torch.int8 or pool_scale.dtype != torch.float32 \
            or pool_scale.shape != pool_q.shape[:1] \
            or not pool_scale.is_contiguous():
        raise TypeError("dequant_gather: needs an int8 pool and a "
                        "contiguous float32 scale per slot")
    if dtype not in _SRC_DTYPES:
        raise TypeError(f"dequant_gather: output dtype {dtype} is not "
                        f"float32 or bfloat16")
    k = idx.shape[0]
    out = torch.empty((k, *pool_q.shape[1:]), dtype=dtype,
                      device=idx.device)
    if out.numel() == 0:
        return out
    fn = _build.function("dequant_gather", _DEQUANT_ARGS)
    err = fn(_build.device_address(pool_q), _build.device_address(pool_scale),
             idx.data_ptr(), out.data_ptr(), k, pool_q[0].numel(),
             int(dtype == torch.bfloat16),
             _build.current_stream(idx.device.index))
    _build.check(err, "dequant_gather")
    count_launch("dequant_gather")
    return out
