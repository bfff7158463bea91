"""Mamba-2 (SSD, state-space duality) block — torch twin of
``repro.models.ssm``.

Chunked SSD forward (``mamba_forward``: the prefill's scan is kernel K9
``kernels.ssd_scan``, training's the plain ``ssd_chunked``) and the
O(1)-state decode step (``mamba_decode_step``, plain torch: XLA in the
JAX package too).
``ssd_chunked`` is the plain chunked scan, line by line the JAX function,
with any number of B/C groups; K9's plain version calls it with G = 1.

Layouts at every function boundary are the JAX package's: x
[B, L, H, P], dt [B, L, H], Bm/Cm [B, L, G, N], h [B, H, N, P], conv
state [B, d_conv-1, conv_ch].  Parameters are a dict with the leaf names
of ``MambaParams``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as K9

from . import layers


class MambaSpec(NamedTuple):
    d_model: int
    d_inner: int
    headdim: int
    n_heads: int
    d_state: int
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128

    @property
    def conv_ch(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def make_spec(d_model: int, *, expand: int = 2, headdim: int = 64,
              d_state: int = 128, d_conv: int = 4, chunk: int = 128
              ) -> MambaSpec:
    d_inner = expand * d_model
    return MambaSpec(d_model=d_model, d_inner=d_inner, headdim=headdim,
                     n_heads=d_inner // headdim, d_state=d_state,
                     d_conv=d_conv, chunk=chunk)


def init_mamba_params(spec: MambaSpec, gen: torch.Generator, *,
                      dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cpu") -> dict:
    """Random weights with the JAX scales: projections normal *
    d_model**-0.5, conv * 0.1, dt_bias -4 (softplus ~0.018), A_log 0
    (A = -1), D 1, norm 1, out_proj * d_inner**-0.5; drawn from ``gen``
    (on ``device``), so the values differ from ``jax.random``'s."""
    d, di, H = spec.d_model, spec.d_inner, spec.n_heads
    gn = spec.n_groups * spec.d_state

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(std).to(dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    s = d ** -0.5
    return {
        "in_proj_z": normal((d, di), s),
        "in_proj_x": normal((d, di), s),
        "in_proj_B": normal((d, gn), s),
        "in_proj_C": normal((d, gn), s),
        "in_proj_dt": normal((d, H), s),
        "conv_w": normal((spec.d_conv, spec.conv_ch), 0.1),
        "conv_b": full((spec.conv_ch,), 0.0),
        "dt_bias": full((H,), -4.0),
        "A_log": full((H,), 0.0),
        "D": full((H,), 1.0),
        "norm": full((di,), 1.0),
        "out_proj": normal((di, d), di ** -0.5),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` (``logaddexp(x, 0)``, no
    linear cut-off)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x [B, L, C]; w [K, C]: depthwise causal conv + silu, as the JAX sum
    of K shifted products over a zero history (not ``F.conv1d``, which
    runs through cuDNN, in TF32 by default, and sums in another order)."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:L, :] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + L, :] * w[i]
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None):
    """Plain chunked SSD scan in float32.

    x [B, L, H, P]; dt [B, L, H] (post-softplus); A [H] (negative);
    Bm/Cm [B, L, G, N].  Returns (y [B, L, H, P], h_final [B, H, N, P]).
    A ragged L is padded to a chunk multiple with identity steps (dt = 0).
    """
    Bsz, L, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = chunk
    L0 = L
    if L % Q:
        pad = Q - L % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))       # dt=0 -> decay 1, no input
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        L = L + pad
    nC = L // Q

    f32 = torch.float32
    xq = x.reshape(Bsz, nC, Q, H, Pd).to(f32)
    dtq = dt.reshape(Bsz, nC, Q, H).to(f32)
    Bq = Bm.reshape(Bsz, nC, Q, G, N).to(f32)
    Cq = Cm.reshape(Bsz, nC, Q, G, N).to(f32)

    dA = dtq * A.to(f32)                               # [B, nC, Q, H]
    dA_cs = torch.cumsum(dA, dim=2)                    # inclusive

    # intra-chunk: att[b,c,h,i,j] = (C_i . B_j) exp(cs_i - cs_j) dt_j, j<=i
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cq, Bq)    # [B, nC, G, Q, Q]
    CB = layers.repeat_heads(CB, hpg, dim=2)
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]   # [B,nC,Q,Q,H]
    seg = seg.permute(0, 1, 4, 2, 3)                   # [B, nC, H, Q, Q]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    att = torch.where(tri, CB * torch.exp(seg), torch.zeros((), dtype=f32,
                                                            device=x.device))
    att = att * dtq.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", att, xq)

    # chunk states: S_c = sum_j exp(cs_end - cs_j) dt_j B_j (x) x_j
    dA_sum = dA_cs[:, :, -1:, :]                       # [B, nC, 1, H]
    decay_to_end = torch.exp(dA_sum - dA_cs)           # [B, nC, Q, H]
    Bh = layers.repeat_heads(Bq, hpg, dim=3)
    Bh = Bh.reshape(Bsz, nC, Q, H, N)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", decay_to_end * dtq,
                          Bh, xq)

    # inter-chunk recurrence, emitting the state *before* each chunk
    chunk_decay = torch.exp(dA_sum[:, :, 0, :])        # [B, nC, H]
    h = (torch.zeros((Bsz, H, N, Pd), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prev = []
    for c in range(nC):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                # [B, nC, H, N, P]

    # inter-chunk output: C_i . h_prev * exp(cs_i)
    Ch = layers.repeat_heads(Cq, hpg, dim=3)
    Ch = Ch.reshape(Bsz, nC, Q, H, N)
    y_off = torch.einsum("bcqhn,bchnp->bcqhp", Ch, h_prev)
    y_off = y_off * torch.exp(dA_cs)[..., None]

    y = (y_diag + y_off).reshape(Bsz, L, H, Pd)[:, :L0]
    return y, h


def mamba_forward(p: dict, spec: MambaSpec, x: torch.Tensor, *,
                  h0: torch.Tensor | None = None,
                  conv0: torch.Tensor | None = None,
                  return_state: bool = False, scan=None):
    """Full Mamba-2 block over x [B, L, d] -> [B, L, d].  ``scan`` is the
    chunked SSD scan, called as ``ssd_chunked``: K9 when None (the
    prefill; the kernel has no backward), the plain ``ssd_chunked`` under
    autograd in training, as the JAX training forward runs the jnp scan.

    With ``return_state`` also returns (h_final [B, H, N, P] float32, the
    raw conv context: the last min(L, d_conv-1) rows of x ‖ B ‖ C before
    the convolution, as the JAX function keeps them)."""
    Bsz, L, d = x.shape
    H, Pd, N, G = spec.n_heads, spec.headdim, spec.d_state, spec.n_groups

    z = x @ p["in_proj_z"]
    xs = x @ p["in_proj_x"]
    Bp = x @ p["in_proj_B"]
    Cp = x @ p["in_proj_C"]
    dt = x @ p["in_proj_dt"]

    di, gn = spec.d_inner, G * N
    conv_tail_raw = None
    if return_state:
        k = spec.d_conv - 1
        conv_tail_raw = torch.cat([xs[:, -k:], Bp[:, -k:], Cp[:, -k:]],
                                  dim=-1)

    def conv_part(u, lo, hi, ctx=None):
        w, b = p["conv_w"][:, lo:hi], p["conv_b"][lo:hi]
        if ctx is not None:
            u2 = torch.cat([ctx, u], dim=1)
            return _causal_depthwise_conv(u2, w, b)[:, ctx.shape[1]:]
        return _causal_depthwise_conv(u, w, b)

    c0 = (None, None, None) if conv0 is None else (
        conv0[..., :di], conv0[..., di:di + gn], conv0[..., di + gn:])
    xs = conv_part(xs, 0, di, c0[0])
    Bp = conv_part(Bp, di, di + gn, c0[1])
    Cp = conv_part(Cp, di + gn, di + 2 * gn, c0[2])

    xh = xs.reshape(Bsz, L, H, Pd)
    Bm = Bp.reshape(Bsz, L, G, N)
    Cm = Cp.reshape(Bsz, L, G, N)
    dt = softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    y, h_fin = (scan or K9.ssd_scan)(xh, dt, A, Bm, Cm, spec.chunk, h0=h0)
    y = y + xh.float() * p["D"].float()[:, None]
    y = y.reshape(Bsz, L, spec.d_inner)

    # gated RMSNorm, then the out-projection
    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * p["norm"].float()
    out = y.to(x.dtype) @ p["out_proj"]
    if return_state:
        return out, (h_fin, conv_tail_raw)
    return out


def _local_params(p: dict, mi, everyone) -> dict:
    """Each rank's shards of the Mamba weights: B, C and dt projections,
    conv, ``dt_bias``, ``A_log`` and ``D`` whole (their gradients partial
    sums over ``everyone``), the rest split over ``model`` by
    ``param_specs``."""
    from repro_torch.parallel.sharding import local
    whole = ("in_proj_B", "in_proj_C", "in_proj_dt", "conv_w", "conv_b",
             "dt_bias", "A_log", "D")
    return {k: local(v, mi, everyone if k in whole else mi.dp_axes)
            for k, v in p.items()}


def _head_slices(spec: MambaSpec, mi):
    n, m = mi.n_model, mi.mesh.get_local_rank(mi.model_axis)
    H, di = spec.n_heads, spec.d_inner
    if spec.n_groups != 1:
        raise NotImplementedError("sharded Mamba-2: one B/C group")
    if H % n:
        raise ValueError(f"sharded Mamba-2: {H} heads over {n} model shards")
    Hl, dil = H // n, di // n
    return slice(m * Hl, (m + 1) * Hl), slice(m * dil, (m + 1) * dil)


def mamba_forward_sharded(p: dict, spec: MambaSpec, x, mi, *, scan=None,
                          return_state: bool = False):
    """``mamba_forward`` over ``mi``'s mesh, on each rank's shards (DTensor
    has no sharding rule for the chunked scan's reshapes): the heads split
    over ``model`` (``in_proj_z``/``_x``, ``norm`` and ``out_proj``'s
    rows as ``param_specs`` lays them out), B, C and dt computed whole on
    every rank and the rank's heads taken from them and from the
    replicated conv, ``dt_bias``, ``A_log`` and ``D``.  The gated
    RMSNorm's sum of squares over d_inner is summed over ``model``, and
    the row-split ``out_proj``'s partial outputs too.  x [B, L, d] is a
    DTensor split over the data axes; returns the block's output as one.
    ``scan`` as ``mamba_forward``'s, the plain ``ssd_chunked`` by default
    (training); the prefill passes K9, which runs on the rank's heads.
    With ``return_state`` also returns the state as DTensors in the
    decode layout (``sharding.decode_state_specs``): h [B, H, N, P] with
    the heads over ``model``, and the raw conv context [B, d_conv-1,
    conv_ch] (zero-padded on the left to d_conv-1 rows) with the channels
    over ``model``, its x channels gathered over ``model`` first.  On a
    ``model`` axis of one rank the block is ``mamba_forward`` on the
    local tensors."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Shard

    from repro_torch.parallel.sharding import (from_local, like_batch, local,
                                               psum)
    scan = scan or ssd_chunked
    heads, chans = _head_slices(spec, mi)
    everyone = (mi.model_axis, *mi.dp_axes)
    xl = local(x, mi, (mi.model_axis,))
    pl = _local_params(p, mi, everyone)
    Bsz, L, _ = xl.shape
    H, Pd, di, gn = spec.n_heads, spec.headdim, spec.d_inner, spec.d_state
    names = mi.mesh.mesh_dim_names
    rows = like_batch(x)

    def state(hs, tail):
        tail = F.pad(tail, (0, 0, spec.d_conv - 1 - tail.shape[1], 0))
        h_pl = [Shard(1) if n == mi.model_axis else r
                for n, r in zip(names, rows)]
        hs = from_local(hs, mi, h_pl, (x.shape[0], H, gn, Pd))
        tail = from_local(tail, mi, rows,
                          (x.shape[0], spec.d_conv - 1, spec.conv_ch))
        return hs, tail.redistribute(mi.mesh, [
            Shard(2) if n == mi.model_axis else r
            for n, r in zip(names, rows)])

    if mi.n_model == 1:
        out = mamba_forward(pl, spec, xl, return_state=return_state,
                            scan=scan)
        y = from_local(out[0] if return_state else out, mi, rows, x.shape)
        if not return_state:
            return y
        return y, state(*out[1])

    Hl, dil = H // mi.n_model, di // mi.n_model
    z = xl @ pl["in_proj_z"]
    xs = xl @ pl["in_proj_x"]
    Bp = xl @ pl["in_proj_B"]
    Cp = xl @ pl["in_proj_C"]
    dt = (xl @ pl["in_proj_dt"])[..., heads]
    tails = None
    if return_state:
        k = spec.d_conv - 1
        xt = from_local(xs[:, -k:].contiguous(), mi, [
            Shard(2) if n == mi.model_axis else r
            for n, r in zip(names, rows)], (x.shape[0], min(k, L), di))
        xt = xt.redistribute(mi.mesh, rows).to_local()
        tails = torch.cat([xt, Bp[:, -k:], Cp[:, -k:]], dim=-1)
    cw, cb = pl["conv_w"], pl["conv_b"]
    xs = _causal_depthwise_conv(xs, cw[:, chans], cb[chans])
    Bp = _causal_depthwise_conv(Bp, cw[:, di:di + gn], cb[di:di + gn])
    Cp = _causal_depthwise_conv(Cp, cw[:, di + gn:], cb[di + gn:])

    xh = xs.reshape(Bsz, L, Hl, Pd)
    dt = softplus(dt.float() + pl["dt_bias"][heads].float())
    A = -torch.exp(pl["A_log"][heads].float())
    y, h_fin = scan(xh, dt, A, Bp.reshape(Bsz, L, 1, gn),
                    Cp.reshape(Bsz, L, 1, gn), spec.chunk)
    y = y + xh.float() * pl["D"][heads].float()[:, None]
    y = y.reshape(Bsz, L, dil) * F.silu(z.float())

    ss = psum(y.square().sum(dim=-1, keepdim=True), mi, x)
    ss = local(ss, mi, (mi.model_axis,))
    y = y * torch.rsqrt(ss / di + 1e-6) * pl["norm"].float()
    out = psum(y.to(xl.dtype) @ pl["out_proj"], mi, x)
    if not return_state:
        return out
    return out, state(h_fin, tails)


def mamba_decode_step_sharded(p: dict, spec: MambaSpec, x, h, conv_state,
                              mi):
    """``mamba_decode_step`` over ``mi``'s mesh in the JAX decode layout:
    x [B, 1, d], h [B, H, N, P] with the heads over ``model``, the raw
    conv context [B, d_conv-1, conv_ch] with its channels over ``model``
    (DTensors, the batch over the data axes or whole).  The channel split
    cuts across x | B | C, which every head reads, so the step gathers
    the context and the new token's x channels over ``model`` (two small
    all-gathers), runs the conv over the whole window, and keeps its own
    channels of the new context; the recurrence runs on the rank's heads,
    the gated norm's sum of squares and ``out_proj``'s partial outputs
    are summed over ``model``.  Returns (out [B, 1, d], h, conv_state) as
    DTensors in their input layouts.  On a ``model`` axis of one rank it
    is ``mamba_decode_step`` on the local tensors."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Shard

    from repro_torch.parallel.sharding import (from_local, like_batch, local,
                                               local_offset, psum)
    rows = like_batch(h)
    names = mi.mesh.mesh_dim_names
    xl = x.redistribute(mi.mesh, rows).to_local()
    pl = _local_params(p, mi, (mi.model_axis, *mi.dp_axes))
    hl = h.to_local()
    out_shape = (h.shape[0], 1, spec.d_model)

    def back(out, hs, cs):
        return (from_local(out, mi, rows, out_shape),
                from_local(hs, mi, h.placements, h.shape),
                from_local(cs, mi, conv_state.placements, conv_state.shape))

    if mi.n_model == 1:
        return back(*mamba_decode_step(pl, spec, xl, hl,
                                       conv_state.to_local()))
    heads, chans = _head_slices(spec, mi)
    Bsz = xl.shape[0]
    H, Pd, N, di = spec.n_heads, spec.headdim, spec.d_state, spec.d_inner
    Hl, dil = H // mi.n_model, di // mi.n_model
    z = (xl @ pl["in_proj_z"])[:, 0]
    xs = (xl @ pl["in_proj_x"])[:, 0]
    Bp = (xl @ pl["in_proj_B"])[:, 0]
    Cp = (xl @ pl["in_proj_C"])[:, 0]
    dt = (xl @ pl["in_proj_dt"])[:, 0, heads]
    xs_all = from_local(xs, mi, [
        Shard(1) if n == mi.model_axis else r for n, r in zip(names, rows)],
        (h.shape[0], di))
    xs_all = xs_all.redistribute(mi.mesh, rows).to_local()
    ctx = conv_state.redistribute(mi.mesh, rows).to_local()
    xbc = torch.cat([xs_all, Bp, Cp], dim=-1)            # [B, conv_ch]
    window = torch.cat([ctx, xbc[:, None, :]], dim=1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, pl["conv_w"])
                      + pl["conv_b"])
    lo, c0 = local_offset(conv_state)[2], conv_state.to_local().shape[2]
    new_ctx = window[:, 1:, lo:lo + c0]

    xh = conv_out[:, chans].reshape(Bsz, Hl, Pd).float()
    Bm = conv_out[:, di:di + N].float()
    Cm = conv_out[:, di + N:].float()
    dt = softplus(dt.float() + pl["dt_bias"][heads].float())
    A = -torch.exp(pl["A_log"][heads].float())
    dec = torch.exp(dt * A)
    hs = hl * dec[:, :, None, None] + torch.einsum("bh,bn,bhp->bhnp", dt,
                                                   Bm, xh)
    y = torch.einsum("bn,bhnp->bhp", Cm, hs)
    y = y + xh * pl["D"][heads].float()[:, None]
    y = y.reshape(Bsz, dil) * F.silu(z.float())
    like = from_local(xl[:, 0], mi, rows, (h.shape[0], spec.d_model))
    ss = local(psum(y.square().sum(dim=-1, keepdim=True), mi, like), mi,
               (mi.model_axis,))
    y = y * torch.rsqrt(ss / di + 1e-6) * pl["norm"].float()
    out = local(psum(y.to(xl.dtype) @ pl["out_proj"], mi, like), mi,
                (mi.model_axis,))
    return back(out[:, None, :], hs, new_ctx.contiguous())


def mamba_decode_step(p: dict, spec: MambaSpec, x: torch.Tensor,
                      h: torch.Tensor, conv_state: torch.Tensor):
    """One-token decode.  x [B, 1, d]; h [B, H, N, P]; conv_state
    [B, d_conv-1, conv_ch] rolling raw xBC context.  Returns
    (out [B, 1, d], h, conv_state)."""
    Bsz = x.shape[0]
    H, Pd, N, G = spec.n_heads, spec.headdim, spec.d_state, spec.n_groups

    z = (x @ p["in_proj_z"])[:, 0]
    xs = (x @ p["in_proj_x"])[:, 0]
    Bp = (x @ p["in_proj_B"])[:, 0]
    Cp = (x @ p["in_proj_C"])[:, 0]
    dt = (x @ p["in_proj_dt"])[:, 0]

    xbc = torch.cat([xs, Bp, Cp], dim=-1)              # [B, conv_ch]
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    conv_state = window[:, 1:, :]

    xs = conv_out[..., :spec.d_inner].reshape(Bsz, H, Pd).float()
    Bm = conv_out[..., spec.d_inner:spec.d_inner + G * N].reshape(Bsz, G, N)
    Cm = conv_out[..., spec.d_inner + G * N:].reshape(Bsz, G, N)
    hpg = H // G
    Bh = torch.repeat_interleave(Bm, hpg, dim=1).float()   # [B, H, N]
    Ch = torch.repeat_interleave(Cm, hpg, dim=1).float()

    dt = softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    dec = torch.exp(dt * A)                                # [B, H]
    h = h * dec[:, :, None, None] + torch.einsum("bh,bhn,bhp->bhnp", dt,
                                                 Bh, xs)
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    y = y + xs * p["D"].float()[:, None]
    y = y.reshape(Bsz, spec.d_inner)

    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * p["norm"].float()
    out = y.to(x.dtype) @ p["out_proj"]
    return out[:, None, :], h, conv_state
