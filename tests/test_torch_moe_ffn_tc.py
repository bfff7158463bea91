"""The arithmetic of ``moe_ffn``'s tensor-core entries, on the CPU.

``csrc/moe_ffn.cu`` computes the grouped SwiGLU of the JAX package's
``_grouped_ffn`` (three ``lax.ragged_dot``, float32 sums, h rounded to
the rows' type) times the gate weights on the tensor cores:

- bfloat16 on ``wgmma.m64n128k16``: exact bf16 products, summed over
  each k16 step and added to a float32 accumulator (``mm_bf16``);
- float32 in 3xTF32 on ``mma.sync.m16n8k8`` (``split_tf32`` in
  ``common.cuh``): each operand split into a big TF32 term (rounded to
  nearest, ties away) and a small one that the tensor cores read
  truncated; per k8 step small.big, then big.small, then big.big, each
  ``mma.sync`` rounding its float32 sum toward zero; each 32-deep stage
  starts from zero and is added to the output's float32 sum with one
  rounded add (``mm_3xtf32``).

The emulations below (test helpers, on no path) are held against JAX
``_grouped_ffn`` at the tolerances ``chip_smoke.py`` holds the kernel to
against its plain version on the card (bf16 3e-3 of max|y|, float32
1e-5).  The controls show the tests can fail: one TF32 term per operand
misses 1e-5, and so does one float32 accumulator fed by every
``mma.sync`` (no per-stage sums) at mixtral's ff of 14336.

``csrc/moe_ffn_bwd.cu``, the float32 backward, runs 3xTF32 on
``wgmma.m64n128k8`` (which also reads a TF32 operand truncated and
rounds its float32 sum toward zero: ``tools/moe_bwd_probe.py``): A split
as above, B split by truncation (its float32 value is the big term as
the tensor cores read it, x - trunc(x) the small one); per k8 step
small.big, big.small, big.big, each 32-deep stage from zero and then
added to the output's float32 sum (``mm_bwd``), over d for the down
product's input gradient, 2 ff for the rows' and a group's rows for the
weights'.  ``grouped_ffn_bwd``
emulates its three launches from the forward's g, u and h and is held
against ``jax.vjp`` of ``_grouped_ffn``; the k walk alone is held against
float64 at olmoe's depths (d 2048, 2 ff 2048) and at the weight
gradients' worst group (all 16384 rows of a step in one expert), where
one TF32 term per operand misses.

The kernels' shared memory and work units are sized in the kernel
source; ``smem_bytes`` and ``units`` mirror them, so the launch plan is
checked here at the edges of what the wrapper takes (the card test
holds the mirror against ``moe_ffn.launch_info``).  ``bwd16_plan``,
``bwd16_units`` and ``bwd16_dw_order`` do the same for the bf16
backward's three launches (shared memory, ring stages, units at olmoe's
and mixtral's training shapes and at 1 row and 256 experts, the weight
gradients' heaviest-first walk; on a card against
``moe_ffn.bwd_launch_info``).
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import cap_threads, cuda_device
from repro_torch.kernels import moe_ffn as KM

cap_threads()

BF16_TOL, F32_TOL = 3e-3, 1e-5   # chip_smoke.py's MOE_TOL, MOE_F32_TOL
MAX_SMEM = 232448   # the dynamic shared memory of an H100 CTA
STAGE_K = 32        # the float32 entry's depth of a stage sum


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds the big term."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read a TF32 operand: low 13 bits ignored."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two TF32 terms of ``split_tf32``."""
    big = tf32(x)
    return big, trunc_tf32(x - big)


def to_f32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero, as ``mma.sync`` rounds its
    float32 sum (tools/mma_tf32_probe.cu)."""
    r = x.to(torch.float32)
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def trunc_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's B operand: the float32 value is its own big term
    (read truncated) and x - trunc(x) the small one (read truncated)."""
    big = trunc_tf32(x)
    return big, trunc_tf32(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, scheme: str = "3xtf32",
              stage_k: int | None = STAGE_K,
              b_split: str = "round") -> torch.Tensor:
    """a [R, K] . b [K, N] in float32 as the float32 entry computes it.
    ``scheme`` "1xtf32": one TF32 term per operand (the control);
    ``stage_k`` None: one accumulator over all of K (the control);
    ``b_split`` "trunc": B split as the backward splits it
    (``trunc_split``)."""
    R, K = a.shape
    if scheme == "3xtf32":
        (ab, as_) = split(a)
        bb, bs = split(b) if b_split == "round" else trunc_split(b)
        terms = ((as_, bb), (ab, bs), (ab, bb))
    elif scheme == "1xtf32":
        terms = ((tf32(a), tf32(b)),)
    else:
        raise ValueError(scheme)
    terms = [(x.double(), y.double()) for x, y in terms]
    acc = torch.zeros(R, b.shape[1])
    part = torch.zeros(R, b.shape[1])
    for k0 in range(0, K, 8):
        for x, y in terms:
            part = to_f32_toward_zero(part.double()
                                      + x[:, k0:k0 + 8] @ y[k0:k0 + 8])
        if stage_k and (k0 + 8) % stage_k == 0:
            acc = acc + part
            part = torch.zeros_like(part)
    return acc + part


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [R, K] . b [K, N] from bf16 operands as the bf16 entry computes
    it: the exact products of each k16 step summed, then added to a
    float32 accumulator."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 16):
        acc = acc + a[:, k0:k0 + 16].float() @ b[k0:k0 + 16].float()
    return acc


def grouped_ffn(xg, sizes, wg, wu, wd, gate, mm):
    """The kernel's two launches with products from ``mm``: h = silu(g)
    * u in float32 (g / (1 + exp(-g)) * u) rounded to xg's type, then
    y = h . W_down times the gate weight."""
    y = torch.zeros(xg.shape[0], wd.shape[2])
    r0 = 0
    for e, n in enumerate(sizes):
        if n:
            x = xg[r0:r0 + n]
            g, u = mm(x, wg[e]), mm(x, wu[e])
            h = (g / (1 + torch.exp(-g)) * u).to(xg.dtype)
            y[r0:r0 + n] = mm(h, wd[e]) * gate[r0:r0 + n, None]
        r0 += n
    return y


def _inputs(sizes, d, ff, seed):
    rng = np.random.RandomState(seed)
    e, R = len(sizes), sum(sizes)
    s = d ** -0.5
    return (rng.standard_normal((R, d)).astype(np.float32),
            *(rng.standard_normal(shape).astype(np.float32) * s
              for shape in ((e, d, ff), (e, d, ff), (e, ff, d))),
            (rng.rand(R) / 2).astype(np.float32))


def _jax_grouped_ffn(xg, sizes, wg, wu, wd, gate, dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    jt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    y = jmoe._grouped_ffn(jnp.asarray(xg, jt), jnp.asarray(sizes, jnp.int32),
                          jnp.asarray(wg, jt), jnp.asarray(wu, jt),
                          jnp.asarray(wd, jt))
    return np.asarray(y) * gate[:, None]


def _excess(got, want, tol) -> float:
    """max |got - want| / (tol max|want| + tol |want|): <= 1 holds."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want)
                  / (tol * np.abs(want).max() + tol * np.abs(want))).max())


SIZES = [5, 0, 37, 1, 19]


@pytest.mark.parametrize("dtype,mm,tol", [
    (torch.bfloat16, mm_bf16, BF16_TOL),
    (torch.float32, mm_3xtf32, F32_TOL)])
def test_emulation_holds_against_grouped_ffn(dtype, mm, tol):
    """Each entry's arithmetic against JAX ``_grouped_ffn`` on the same
    inputs (bf16: the inputs rounded to bf16 for both)."""
    xg, wg, wu, wd, gate = _inputs(SIZES, 128, 192, 1)
    want = _jax_grouped_ffn(xg, SIZES, wg, wu, wd, gate, dtype)
    t = [torch.from_numpy(a).to(dtype) for a in (xg, wg, wu, wd)]
    got = grouped_ffn(*t[:1], SIZES, *t[1:], torch.from_numpy(gate), mm)
    assert _excess(got, want, tol) <= 1


def test_f32_emulation_holds_against_float64():
    """3xTF32 with per-stage sums against float64 at olmoe's d (2048):
    well inside 1e-5 (the kernel's margin against plain)."""
    xg, wg, wu, wd, gate = _inputs([9, 3], 2048, 64, 2)
    f64 = [torch.from_numpy(a).double() for a in (xg, wg, wu, wd)]
    want = grouped_ffn(f64[0], [9, 3], *f64[1:], torch.from_numpy(gate),
                       lambda a, b: a @ b)
    t = [torch.from_numpy(a) for a in (xg, wg, wu, wd)]
    got = grouped_ffn(t[0], [9, 3], *t[1:], torch.from_numpy(gate),
                      mm_3xtf32)
    assert _excess(got, want, F32_TOL) <= 0.2


def test_one_tf32_term_misses():
    """The control: one TF32 term per operand (a TF32 matmul) misses the
    float32 tolerance against JAX, so the test above can fail."""
    xg, wg, wu, wd, gate = _inputs(SIZES, 128, 192, 1)
    want = _jax_grouped_ffn(xg, SIZES, wg, wu, wd, gate, torch.float32)
    t = [torch.from_numpy(a) for a in (xg, wg, wu, wd)]
    got = grouped_ffn(t[0], SIZES, *t[1:], torch.from_numpy(gate),
                      lambda a, b: mm_3xtf32(a, b, scheme="1xtf32"))
    assert _excess(got, want, F32_TOL) > 3


def test_per_stage_sums_hold_at_mixtral_depth():
    """Over mixtral's ff (14336) one accumulator fed by every mma.sync
    (rounding toward zero) drifts past 1e-5 of max|y| against float64;
    the kernel's 32-deep stages summed in float32 stay far inside."""
    rng = np.random.RandomState(3)
    K = 14336
    a = torch.from_numpy(rng.standard_normal((8, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, 64)) * K ** -0.5)
                         .astype(np.float32))
    want = (a.double() @ b.double()).numpy()
    assert _excess(mm_3xtf32(a, b), want, F32_TOL) <= 0.2
    assert _excess(mm_3xtf32(a, b, stage_k=None), want, F32_TOL) > 2


# =============================================================================
# the backward's arithmetic (csrc/moe_ffn_bwd.cu)
# =============================================================================

def mm_bwd(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """The backward's products: A split as ``split_tf32`` splits it, B by
    truncation, 32-deep stage sums."""
    return mm_3xtf32(a, b, b_split="trunc", **kw)


def grouped_ffn_bwd(dy, xg, sizes, wg, wu, wd, gate, mm):
    """The backward's three launches with products from ``mm``, from the
    forward's g = mm(x, Wg), u = mm(x, Wu) and h = silu(g) u: t =
    dy.Wd^T over d with the SwiGLU backward and dc in the epilogue; dx =
    [dg | du].[Wg | Wu]^T over 2 ff; dWg = X^T.dg, dWu = X^T.du and
    dWd = ((c dy)^T.H)^T over the group's rows.  Returns (dx, dWg, dWu,
    dWd, dgate)."""
    R, d = xg.shape
    dx = torch.zeros(R, d)
    dgate = torch.zeros(R)
    dws = [torch.zeros_like(w) for w in (wg, wu, wd)]
    r0 = 0
    for e, n in enumerate(sizes):
        if n:
            x, dye, c = xg[r0:r0 + n], dy[r0:r0 + n], gate[r0:r0 + n, None]
            g, u = mm(x, wg[e]), mm(x, wu[e])
            h = g / (1 + torch.exp(-g)) * u
            t = mm(dye, wd[e].T.contiguous())
            dgate[r0:r0 + n] = (h * t).sum(-1)
            s = 1 / (1 + torch.exp(-g))
            dh = c * t
            dg = dh * u * (s * (1 + g * (1 - s)))
            du = dh * (g / (1 + torch.exp(-g)))
            dx[r0:r0 + n] = mm(torch.cat([dg, du], 1),
                               torch.cat([wg[e], wu[e]], 1).T.contiguous())
            dws[0][e] = mm(x.T.contiguous(), dg)
            dws[1][e] = mm(x.T.contiguous(), du)
            dws[2][e] = mm((c * dye).T.contiguous(), h).T
        r0 += n
    return (dx, *dws, dgate)


def test_bwd_emulation_holds_against_jax_vjp():
    """The backward's arithmetic against ``jax.vjp`` of ``_grouped_ffn``
    times the gate weights on the same inputs, every output within 1e-5
    of its largest magnitude (``chip_smoke.py``'s ``MOE_BWD_TOL``, the
    kernel against its plain version)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    xg, wg, wu, wd, gate = _inputs(SIZES, 128, 192, 4)
    dy = np.random.RandomState(5).standard_normal(xg.shape).astype(
        np.float32)
    gs = jnp.asarray(SIZES, jnp.int32)
    _, vjp = jax.vjp(
        lambda x, a, b, c, g: jmoe._grouped_ffn(x, gs, a, b, c) * g[:, None],
        *(jnp.asarray(t) for t in (xg, wg, wu, wd, gate)))
    want = vjp(jnp.asarray(dy))
    got = grouped_ffn_bwd(*(torch.from_numpy(t) for t in (dy, xg)), SIZES,
                          *(torch.from_numpy(t) for t in (wg, wu, wd, gate)),
                          mm_bwd)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert float(np.abs(g.numpy() - w).max()) <= \
            F32_TOL * float(np.abs(w).max())


@pytest.mark.parametrize("name,K,seed", [("down dgrad over d", 2048, 6),
                                         ("x dgrad over 2 ff", 2048, 7),
                                         ("dW over the worst group", 16384,
                                          8)])
def test_bwd_k_walk_holds_at_olmoe_depth(name, K, seed):
    """The k walk at olmoe's training depths against float64: far inside
    1e-5 of the largest output; one TF32 term per operand misses it."""
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.standard_normal((8, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, 64)) * K ** -0.5)
                         .astype(np.float32))
    want = (a.double() @ b.double()).numpy()
    assert _excess(mm_bwd(a, b), want, F32_TOL) <= 0.2, name
    assert _excess(mm_bwd(a, b, scheme="1xtf32"), want, F32_TOL) > 1, name


# =============================================================================
# the launch plan: a mirror of the kernel source's sizes
# =============================================================================

PLAN_BYTES = 4 * (3 * KM.MAX_EXPERTS + 1)    # offs, unit prefix, sizes


def smem_bytes(dtype, R: int, E: int) -> dict:
    """The launch plan of ``csrc/moe_ffn.cu`` at R rows over E experts:
    bf16 a 4-stage ring of 6 TMA boxes of 64 x 128 B (two 64-row boxes of
    rows, four 64-column boxes of weights) plus 1 KB of alignment and the
    barriers, one CTA an SM; float32 3 stages (rows at a stride of the
    depth + 4 floats, weight rows at 136), 64 deep of a 128-row unit, one
    CTA an SM, or, while R <= 32 E, 32 deep of a 16-row unit, three CTAs
    an SM."""
    if dtype == torch.bfloat16:
        return {"smem_bytes": 1024 + 4 * 6 * 64 * 128 + 16 * 4 + PLAN_BYTES,
                "stages": 4, "unit_rows": 128, "threads": 288,
                "ctas_per_sm": 1, "gate_up_unit_columns": 256,
                "down_unit_columns": 256}
    rows, depth, stages, threads, ctas = ((16, 32, 3, 128, 3)
                                          if R <= 32 * E
                                          else (128, 64, 3, 256, 1))
    stage = rows * (depth + 4) + depth * 136
    return {"smem_bytes": 4 * stages * stage + PLAN_BYTES,
            "stages": stages, "unit_rows": rows, "threads": threads,
            "ctas_per_sm": ctas, "gate_up_unit_columns": 128,
            "down_unit_columns": 128}


def units(dtype, sizes, d: int, ff: int) -> tuple[int, int]:
    """Work units of the gate/up and the down launch: row tiles of each
    group times column tiles (bf16 128 columns of h or 256 of y; float32
    64 of h or 128 of y)."""
    plan = smem_bytes(dtype, sum(sizes), len(sizes))
    bm = plan["unit_rows"]
    h_cols = plan["gate_up_unit_columns"] // 2
    tiles = sum(-(-n // bm) for n in sizes)
    return (tiles * -(-ff // h_cols),
            tiles * -(-d // plan["down_unit_columns"]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,E", [(1, 1), (32, 1), (33, 1), (64, 64),
                                 (2048, 64), (8184, 8), (1, 256),
                                 (8192, 256)])
def test_launch_plan_fits(dtype, R, E):
    """Every plan fits the H100's shared memory, at the edges of the
    float32 tiling choice and of the expert count the wrapper takes."""
    plan = smem_bytes(dtype, R, E)
    assert plan["smem_bytes"] * plan["ctas_per_sm"] <= MAX_SMEM
    if dtype == torch.float32:
        assert plan["unit_rows"] == (16 if R <= 32 * E else 128)


def test_units_at_the_main_path_shapes():
    """olmoe's decode (40 touched experts, 1-3 rows each) and mixtral's
    prefill (8320 rows over 8 experts) in units a launch."""
    decode = [2] * 24 + [1] * 16 + [0] * 24
    assert units(torch.bfloat16, decode, 2048, 1024) == (320, 320)
    assert units(torch.float32, decode, 2048, 1024) == (640, 640)
    prefill = [1040] * 8
    assert units(torch.bfloat16, prefill, 4096, 14336) == (8064, 1152)
    assert units(torch.float32, [1023] * 8, 4096, 14336) == (14336, 2048)


def test_wrapper_refuses_more_experts_than_the_plan_holds():
    E = KM.MAX_EXPERTS + 1
    xg = torch.zeros(2, 64)
    w = torch.zeros(E, 64, 64)
    offs = torch.zeros(E + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        KM._check(xg, offs, w, w, w, torch.zeros(2))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,E", [(64, 64), (2048, 64), (8184, 8), (2, 8)])
def test_launch_plan_mirror_matches_the_card(dtype, R, E):
    cuda_device()
    info = KM.launch_info(dtype, R, E)
    want = smem_bytes(dtype, R, E)
    assert {k: info[k] for k in want} == want
    assert info["ctas"] == want["ctas_per_sm"] * torch.cuda.\
        get_device_properties(0).multi_processor_count


# =============================================================================
# the bf16 backward's launch plan: a mirror of csrc/moe_ffn_bwd.cu's b16
# =============================================================================

BOX = 64 * 128               # a TMA box: 64 lines of 128 bytes
BWD16_PLAN_BYTES = 4 * (4 * KM.MAX_EXPERTS + 1)  # offs' plan, kDw's order
# by launch: ring stages, bytes a stage, store-tile bytes, columns a unit
BWD16_LAUNCHES = {
    "down_dgrad": (3, 8 * BOX, 0, 256),      # dy (float32) 4 boxes, Wd 4
    "x_dgrad": (4, 6 * BOX, 0, 256),         # dg or du 2, Wg or Wu 4
    "weight_grads": (3, 6 * BOX, 8 * BOX, 256)}  # x or h 2, dg/du/c dy
                                                 # 4; the dW tile stored


def bwd16_plan() -> dict:
    """The bf16 ``moe_ffn_bwd``'s launch plan by launch: one CTA an SM of
    384 threads (two consumer warpgroups of 64 rows, a producer), a ring
    of TMA boxes 64 deep, 1 KB of alignment, three barriers a stage and
    the unit plan in shared memory; 128-row units."""
    plan = {}
    for name, (stages, stage, store, cols) in BWD16_LAUNCHES.items():
        plan[name] = {"threads": 384, "stages": stages, "ctas_per_sm": 1,
                      "unit_rows": 128, "unit_columns": cols,
                      "smem_bytes": 1024 + stages * stage + store
                      + 24 * stages + BWD16_PLAN_BYTES}
    return plan


def bwd16_units(sizes, d: int, ff: int) -> dict:
    """Units a launch walks: the down dgrad over 128-row tiles of each
    group x 256 columns of ff, the x dgrad x 256 columns of d, the weight
    gradients over every expert's 128 x 256 tiles of dWg, dWu ([d, ff])
    and dWd ([ff, d]), an expert without rows too (it stores zeros)."""
    c = lambda a, b: -(-a // b)
    tiles = sum(c(n, 128) for n in sizes)
    per_expert = 2 * c(d, 128) * c(ff, 256) + c(ff, 128) * c(d, 256)
    return {"down_dgrad": tiles * c(ff, 256), "x_dgrad": tiles * c(d, 256),
            "weight_grads": len(sizes) * per_expert}


def bwd16_dw_order(sizes) -> list[int]:
    """The weight gradients' walk over experts, as the kernel ranks them:
    expert e goes to place #{f: rows_f > rows_e or (rows_f = rows_e and
    f < e)}."""
    order = [0] * len(sizes)
    for e, n in enumerate(sizes):
        order[sum(m > n or (m == n and f < e)
                  for f, m in enumerate(sizes))] = e
    return order


def test_bwd16_plan_fits():
    """Every launch's ring, store tile and plan fit an H100 CTA's shared
    memory at one CTA an SM, and no ring could take one more stage."""
    for name, plan in bwd16_plan().items():
        assert plan["smem_bytes"] * plan["ctas_per_sm"] <= MAX_SMEM, name
        stage = BWD16_LAUNCHES[name][1] + 24
        assert plan["smem_bytes"] + stage > MAX_SMEM, name
    assert bwd16_plan()["weight_grads"]["smem_bytes"] == 218188
    assert bwd16_plan()["x_dgrad"]["smem_bytes"] == 201828
    assert bwd16_plan()["down_dgrad"]["smem_bytes"] == 201804


@pytest.mark.parametrize("sizes,d,ff,want", [
    ([256] * 64, 2048, 1024, (512, 1024, 12288)),       # olmoe, training
    ([1024] * 8, 4096, 14336, (3584, 1024, 43008)),     # mixtral, training
    ([1], 2048, 1024, (4, 8, 192)),                     # one row
    ([1] + [0] * 255, 2048, 1024, (4, 8, 49152)),       # 256 experts
    ([0] * 255 + [1], 4096, 14336, (56, 16, 256 * 5376)),
    ([16384] + [0] * 63, 2048, 1024, (512, 1024, 12288)),  # one group
    ([129, 127, 65, 63], 256, 192, (5, 5, 4 * 6)),      # tile edges
])
def test_bwd16_units_at_the_training_shapes_and_edges(sizes, d, ff, want):
    got = bwd16_units(sizes, d, ff)
    assert (got["down_dgrad"], got["x_dgrad"], got["weight_grads"]) == want


@pytest.mark.parametrize("sizes", [
    [3, 70, 5, 130, 1, 0, 61, 70],
    [256] * 64,
    [0] * 255 + [1],
    list(np.random.default_rng(7).multinomial(16384, np.ones(64) / 64))])
def test_bwd16_dw_walk_is_heaviest_first_ties_by_index(sizes):
    order = bwd16_dw_order(sizes)
    assert sorted(order) == list(range(len(sizes)))
    assert order == sorted(range(len(sizes)), key=lambda e: (-sizes[e], e))
    if sizes[:8] == [3, 70, 5, 130, 1, 0, 61, 70]:
        assert order == [3, 1, 7, 6, 2, 0, 4, 5]


@pytest.mark.requires_cuda
def test_bwd16_launch_plan_mirror_matches_the_card():
    cuda_device()
    info = KM.bwd_launch_info()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, want in bwd16_plan().items():
        assert {k: info[name][k] for k in want} == want, name
        assert info[name]["ctas"] == sms
