"""K8 — flash attention forward: causal, sliding window, GQA.

Replaces ``repro.kernels.flash_attention.flash_attention.
flash_attention_bhsd``: an online softmax over blocks of keys in float32,
keys masked where k >= ``seq_len``, where k > q (``causal``) and where
q - k >= ``window`` (``window`` > 0), q head h reading kv head h // G.
``repro_torch.models.attention.attention`` calls ``flash_attention`` at
every shared-attention site of the hybrid prefill.

On CUDA tensors ``flash_attention`` launches ``csrc/flash_attention.cu``,
which reads q [B, Sq, Hq, D] and k/v [B, Sk, Hkv, D] in place through
their strides (no transposes, no padding of D in device memory) and
applies ``scale`` in float32, as the model's ``sdpa`` does, at any D up
to ``MAX_D``.  bfloat16 runs on ``wgmma`` from TMA-loaded tiles (so
``tma_strides`` must accept each operand), in one kernel for D <= 64, one
for D <= 128 and one for 128 < D <= 256 (persistent, one CTA an SM;
``wide_launch_info`` reports its plan).  float32 runs on the tensor cores
to float32 accuracy (3xTF32: each operand split into two TF32 terms,
three products; any view with a unit stride over D): up to D 128 on
``mma.sync``, past it on ``wgmma`` after a pre-pass that writes K's and
V^T's terms into scratch this wrapper allocates
(``f32_scratch_floats``).  On CPU tensors, at any D, it runs
``flash_attention_plain``: the KV-expansion ``sdpa`` in float32 with the
``_mask_bias`` causal/window bias plus the ``seq_len`` mask.  Either
returns [B, Sq, Hq, D] in q's type.  Meta tensors (the dry run) get an
empty output and add 4 D operations per scored (query, key) pair and
head to ``kernels.meta_flops()``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, add_meta_flops, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_C] * 4 + [_I] * 9 + [ctypes.c_float] + [_L] * 9 + [_C]
_FN = {torch.float32: "flash_attention_f32",
       torch.bfloat16: "flash_attention_bf16"}
MAX_D = 256            # the kernels' widest head dim (the plain version: any)
NARROW_D = 128         # float32 past this runs the wgmma kernel and its pre-pass
WIDE_KEY_TILE = 32     # keys per tile of that kernel (its scratch's unit)
TMA_ALIGN = 16         # bytes: TMA's base address and stride alignment


def tma_strides(t: torch.Tensor, name: str = "q") -> tuple[int, int, int]:
    """The (B, S, H) element strides of a bfloat16 [B, S, H, D] operand
    as the bf16 kernel's TMA tensor map takes them, or ValueError where
    TMA cannot address it: D not a multiple of 8, D not unit-stride, a
    base address or a B/S/H stride not 16-byte aligned.  A dimension of
    size 1 is never stepped, so its stride is replaced by the contiguous
    one (an aligned value)."""
    B, S, H, D = t.shape
    size = t.element_size()
    if D % (TMA_ALIGN // size) or t.stride(3) != 1:
        raise ValueError(f"flash_attention: {name} has D={D} (stride "
                         f"{t.stride(3)}); the bf16 kernel needs a "
                         f"unit-stride D that is a multiple of "
                         f"{TMA_ALIGN // size}")
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"flash_attention: {name}'s base address is not "
                         f"{TMA_ALIGN}-byte aligned")
    out = []
    inner = D
    for dim, n in ((2, H), (1, S), (0, B)):
        st = t.stride(dim) if n > 1 else inner
        if st * size % TMA_ALIGN:
            raise ValueError(f"flash_attention: {name}'s stride {st} over "
                             f"dim {dim} is not {TMA_ALIGN}-byte aligned")
        out.append(st)
        inner *= n
    h, s, b = out
    return b, s, h


def f32_scratch_floats(B: int, Sk: int, Hkv: int) -> int:
    """Floats of scratch the float32 entry past D 128 takes: K's and
    V^T's two TF32 terms, D padded to 256, in tiles of 32 keys (at least
    one), per kv head."""
    tiles = max(1, -(-Sk // WIDE_KEY_TILE))
    return 2 * B * Hkv * tiles * 2 * WIDE_KEY_TILE * MAX_D


def launch_info(B: int, Sq: int, Hq: int, D: int) -> dict:
    """How the float32 entry's main kernel launches for these shapes on
    the current card (builds the kernels): grid CTAs, threads per CTA,
    dynamic shared memory bytes and CTAs resident per SM by the occupancy
    calculator."""
    info = (ctypes.c_int * 4)()
    fn = _build.function("flash_attention_f32_launch_info",
                         [_I] * 4 + [ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(B, Sq, Hq, D, info), "flash_attention_f32_launch_info")
    ctas, threads, smem, per_sm = info
    return {"ctas": ctas, "threads": threads, "smem_bytes": smem,
            "ctas_per_sm": per_sm}


def wide_launch_info(B: int, Sq: int, Hq: int) -> dict:
    """How the bf16 entry's kernel past D 128 (``flash_d256_kernel``)
    launches for these shapes on the current card (builds the kernels):
    grid CTAs (persistent: at most one an SM), threads per CTA, dynamic
    shared memory bytes, CTAs resident per SM by the occupancy calculator
    and registers a thread at launch."""
    info = (ctypes.c_int * 5)()
    fn = _build.function("flash_attention_bf16_wide_launch_info",
                         [_I] * 3 + [ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(B, Sq, Hq, info),
                 "flash_attention_bf16_wide_launch_info")
    ctas, threads, smem, per_sm, regs = info
    return {"ctas": ctas, "threads": threads, "smem_bytes": smem,
            "ctas_per_sm": per_sm, "registers": regs}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          seq_len: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The plain version: KV-expansion ``sdpa`` over float32 copies of
    q, k, v with the causal/window bias and keys >= ``seq_len`` masked;
    the result in q's type."""
    from repro_torch.models.attention import NEG_INF, _mask_bias, sdpa_dense
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[3]
    dev = q.device
    q_pos = torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    if causal:
        bias = _mask_bias(q_pos, k_pos, window if window > 0 else None)
    else:
        ok = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        if window > 0:
            ok = (q_pos[:, None] - k_pos[None, :]) < window
        bias = torch.where(ok, 0.0, NEG_INF).float()
    if seq_len is not None and seq_len < Sk:
        bias = bias.masked_fill(k_pos[None, :] >= seq_len, NEG_INF)
    out = sdpa_dense(q.float(), k.float(), v.float(), bias[None],
                     D ** -0.5 if scale is None else scale)
    return out.to(q.dtype)


def key_pairs(Sq: int, Sk: int, causal: bool, window: int,
              seq_len: int) -> int:
    """(query, key) pairs the kernel scores: keys below ``seq_len``, at
    or before the query (``causal``) and less than ``window`` behind it
    (``window`` > 0)."""
    import numpy as np
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, seq_len - 1) if causal else np.full(Sq, seq_len - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(Sq,
                                                                  np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _meta(q, k, causal, window, seq_len):
    """Meta tensors: the output's shape and type, and the kernel's
    operations (QK^T and PV, 4 D a scored pair and head)."""
    B, Sq, Hq, D = q.shape
    add_meta_flops("flash_attention", 4.0 * B * Hq * D * key_pairs(
        Sq, k.shape[1], causal, window, seq_len))
    return torch.empty(q.shape, dtype=q.dtype, device="meta")


def _launch(q, k, v, causal, window, seq_len, scale):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: head_dim must be unit-stride")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:               # nothing to launch, nothing counted
        return out
    name, argtypes, extra = _FN[q.dtype], _ARGTYPES, ()
    if q.dtype == torch.bfloat16:
        qs, ks, vs = (tma_strides(t, n) for n, t in (("q", q), ("k", k),
                                                       ("v", v)))
    else:
        qs, ks, vs = q.stride(), k.stride(), v.stride()
        if D > NARROW_D:
            scratch = torch.empty(f32_scratch_floats(B, Sk, Hkv),
                                  dtype=torch.float32, device=dev)
            name, argtypes = "flash_attention_f32_d256", _ARGTYPES + [_C]
            extra = (scratch.data_ptr(),)
    fn = _build.function(name, argtypes)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
             Sk, Hq, Hkv, D, seq_len, int(causal), window, scale, qs[0],
             qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
             _build.current_stream(dev.index), *extra)
    _build.check(err, name)
    count_launch("flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    seq_len: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D] in q's
    type.  ``scale`` defaults to D**-0.5; ``seq_len`` (default Sk) masks
    the keys at and past it; ``window`` <= 0 means none."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         f"(Hq must be a multiple of Hkv)")
    seq_len = Sk if seq_len is None else int(seq_len)
    if not 0 <= seq_len <= Sk:
        raise ValueError(f"flash_attention: seq_len={seq_len} not in "
                         f"0..{Sk}")
    window = max(int(window or 0), 0)
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     seq_len=seq_len, scale=scale)
    if q.device.type == "meta":
        return _meta(q, k, causal, window, seq_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"flash_attention: D={D} outside 1..{MAX_D} on "
                         f"the card")
    return _launch(q, k, v, causal, window, seq_len, scale)
