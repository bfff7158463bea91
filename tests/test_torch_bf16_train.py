"""bf16-parameter training in the port against the JAX package on the
CPU, as the JAX dry run's train cells build it (``PARAM_DTYPE =
bfloat16``), at smoke width.

  * ``moe_ffn_backward``'s bf16 plain version (the bf16 kernel's
    arithmetic: bf16 operands, float32 sums, JAX's rounding points)
    against ``jax.vjp`` of ``_grouped_ffn`` on the same bf16 rows and
    weights: dtypes equal (bf16 dx and weight gradients, float32 dgate)
    and each output within ``BWD_REL`` of its largest magnitude: the
    kernel rounds dg, du and dy to bf16 where JAX keeps them in float32,
    about one bf16 ulp (2**-8) of an output's scale;
  * one ``make_train_step`` step of every arch of the training set on
    bf16 weights (the same bf16 values in both packages) against JAX's:
    the loss within ``LOSS_REL`` and the grad norm within ``GNORM_REL``
    relative; every parameter within the reach of AdamW's first step
    (2 lr (1 + wd |p|): a gradient's sign may differ where it is tiny)
    plus one bf16 ulp of |p| + 2 lr; the first moment (0.1 g) of every
    leaf no further from the float32 step on the same weights than
    ``MOMENT_REL`` of the leaf's largest magnitude or twice as far as
    JAX's own bf16 step is.  An MoE arch routes every token by its top-k
    margin, and on any random batch some tokens' margins (down to 1e-7
    here) lie under bf16's rounding of the hidden states: the two
    packages (and each against float32) route some of those tokens to
    other experts, which moves every leaf's gradient (one flipped token
    of 32 moves smoke mixtral's router gradient by up to 90 % of its
    largest).  Their first moments are held as a whole: the norm of the
    port's difference from the float32 step within ``MOE_MOMENT_REL`` of
    that step's norm or twice JAX's own (the bf16 backward itself is held
    tightly by the first test);
  * ``moe_ffn_train``'s bf16 plain forward: y and h those of
    ``moe_ffn_plain``, bit for bit.

On a card (``requires_cuda``, no JAX: the JAX package is imported
inside the tests that compare with it): the bf16 ``moe_ffn_bwd`` kernel
against its plain version within ``BWD_REL`` of each output's largest,
also at olmoe's and mixtral's widths with groups at the edges of its
64-deep stages and 128-row tiles and experts without rows (their weight
gradients exactly zero); its bit rules there (a row's dx and dgate bits
alone, in 128 rows or in 2048 are the same, a group's dW bits do not
depend on the groups before it, two calls repeat every bit); and the
bf16 step on the card against the CPU's within the tolerances above.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import cap_threads, cuda_device
from repro_torch import tree
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.data import SyntheticLM
from repro_torch.kernels import moe_ffn as KM
from repro_torch.launch.train import make_train_step, micro_batches
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

cap_threads()

ARCHS = ["qwen2_vl_72b", "qwen2_5_14b", "phi3_mini_3_8b", "qwen3_4b",
         "gemma3_4b", "zamba2_7b", "mamba2_1_3b", "musicgen_medium",
         "olmoe_1b_7b", "mixtral_8x7b"]
B, S, N_MICRO, LR, WD = 4, 16, 2, 3e-4, 0.1
LOSS_REL = 1e-3
GNORM_REL = 2e-2
MOMENT_REL = 5e-2
BWD_REL = 1e-2
BF16_ULP = 2.0 ** -7      # bf16's spacing relative to a power of two
MOE_MOMENT_REL = 0.1      # MoE, whole tree: bf16 flips near-tied routes


def _jax():
    """The JAX package's pieces these tests compare with."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.configs import smoke as jsmoke
    from repro.launch import train as JTrain
    from repro.models.moe import _grouped_ffn
    from repro.optim import adamw as jadamw
    return jax, jnp, jregistry, jsmoke, JTrain, _grouped_ffn, jadamw


def _moe_inputs(R, d, ff, E, seed):
    """Rows and weights (bf16), gate weights and dy (float32), offsets and
    group sizes, from a numpy generator; expert 1 has no rows."""
    rng = np.random.default_rng(seed)
    sizes = rng.multinomial(R, np.ones(E) / E)
    sizes[1] = 0                                  # an expert with no rows
    sizes[0] += R - sizes.sum()
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    s = d ** -0.5
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()
    return {"xg": bf(rng.standard_normal((R, d))),
            "wg": bf(rng.standard_normal((E, d, ff)) * s),
            "wu": bf(rng.standard_normal((E, d, ff)) * s),
            "wd": bf(rng.standard_normal((E, ff, d)) * ff ** -0.5),
            "gate": torch.from_numpy(rng.uniform(0.1, 1.0, R)
                                     .astype(np.float32)),
            "dy": torch.from_numpy(rng.standard_normal((R, d))
                                   .astype(np.float32)),
            "offs": torch.from_numpy(offs), "sizes": sizes.astype(np.int32)}


ARGS = ("xg", "offs", "wg", "wu", "wd", "gate")


@pytest.mark.parametrize("shape", [(96, 64, 64, 4), (200, 128, 192, 8)])
def test_moe_ffn_backward_bf16_plain_matches_jax(shape):
    jax, jnp, _, _, _, _grouped_ffn, _ = _jax()
    R, d, ff, E = shape
    a = _moe_inputs(R, d, ff, E, seed=R)
    j = lambda t: jnp.asarray(t.float().numpy(), (
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32))

    def f(xg, wg, wu, wd, gate):
        return _grouped_ffn(xg, jnp.asarray(a["sizes"]), wg, wu,
                            wd) * gate[:, None]
    _, vjp = jax.vjp(f, *(j(a[k]) for k in
                          ("xg", "wg", "wu", "wd", "gate")))
    want = vjp(j(a["dy"]))
    args = [a[k] for k in ARGS]
    y, g, u, h = KM.moe_ffn_train(*args)
    got = KM.moe_ffn_backward(a["dy"], *args, g, u, h)
    for name, x, w in zip(("dx", "dWg", "dWu", "dWd", "dgate"), got, want):
        assert str(x.dtype).removeprefix("torch.") == str(w.dtype), name
        w = np.asarray(w, np.float32)
        err = np.abs(x.float().numpy() - w).max()
        assert err <= BWD_REL * np.abs(w).max(), (name, err)
    # the empty expert's weight gradients are exactly zero
    for dw in got[1:4]:
        assert int(torch.count_nonzero(dw[1])) == 0


def test_moe_ffn_train_bf16_plain_is_moe_ffn_plain():
    a = _moe_inputs(64, 64, 64, 4, seed=3)
    args = [a[k] for k in ARGS]
    y, g, u, h = KM.moe_ffn_train(*args)
    assert h.dtype == torch.bfloat16 and g.dtype == torch.float32
    assert torch.equal(y, KM.moe_ffn_plain(*args))


def _weights(cfg):
    """The port's seeded bf16 weights, and their values stacked in the
    JAX layout (float32 numpy, exact)."""
    p = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    f = lambda t: t.float().numpy()
    np_p = {k: tree.map_leaves(f, v) for k, v in p.items() if k != "layers"}
    per_layer = [tree.map_leaves(f, lp) for lp in p["layers"]]
    np_p["layers"] = tree.unflatten(per_layer[0], [
        np.stack(xs) for xs in zip(*map(tree.leaves, per_layer))])
    return p, np_p


def _batch(cfg):
    raw = SyntheticLM(cfg.vocab, S, B, seed=5, input_mode=cfg.input_mode,
                      d_model=cfg.d_model).batch(0)
    return micro_batches(raw, N_MICRO)


def _jax_step(jcfg, np_p, batch, dtype):
    jax, jnp, _, _, JTrain, _, jadamw = _jax()
    jp = jax.tree.map(lambda x: jnp.asarray(x, dtype), np_p)
    jb = {k: jnp.asarray(v, dtype if k == "embeds" else None)
          for k, v in batch.items()}
    new, opt, m = jax.jit(JTrain.make_train_step(jcfg, None))(
        jp, jadamw.init(jp), jb)
    return new, opt, m


def _port(jtree, cfg):
    jax = _jax()[0]
    t = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     jtree), cfg, device="cpu")
    return dict(zip(*tree.flatten_with_names(t)))


def _check_step(cfg, jcfg, np_p, batch, new, opt, m):
    """The port's bf16 step (``new``, ``opt``, metrics ``m``) against
    JAX's bf16 step and its float32 step on the same weights."""
    jnp = _jax()[1]
    jnew, jopt, jm = _jax_step(jcfg, np_p, batch, jnp.bfloat16)
    _, fopt, _ = _jax_step(jcfg, np_p, batch, jnp.float32)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        LOSS_REL * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        GNORM_REL * float(jm["grad_norm"])
    wp, wm, fm = _port(jnew, cfg), _port(jopt.m, cfg), _port(fopt.m, cfg)
    names = tree.flatten_with_names(new)[0]
    assert sorted(names) == sorted(wp)
    norm = lambda ts: sum(float((t.double() ** 2).sum()) for t in ts) ** .5
    if cfg.is_moe:
        mine = norm(mo.cpu() - fm[n] for n, mo in zip(names,
                                                      tree.leaves(opt.m)))
        theirs = norm(wm[n] - fm[n] for n in names)
        assert mine <= max(MOE_MOMENT_REL * norm(fm.values()), 2 * theirs)
    for name, p, mo in zip(names, tree.leaves(new), tree.leaves(opt.m)):
        assert p.dtype == torch.bfloat16 and mo.dtype == torch.float32
        ref = wp[name].abs()
        reach = 2 * LR * (1 + WD * ref) + BF16_ULP * (ref + 2 * LR)
        assert bool(((p.float().cpu() - wp[name]).abs() <= reach).all()), \
            name
        scale = float(fm[name].abs().max())
        mine = float((mo.cpu() - fm[name]).abs().max())
        theirs = float((wm[name] - fm[name]).abs().max())
        assert cfg.is_moe or mine <= max(MOMENT_REL * scale, 2 * theirs), \
            (name, mine, theirs, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_matches_jax(arch):
    _, _, jregistry, jsmoke, *_ = _jax()
    cfg, jcfg = smoke(registry()[arch]), jsmoke(jregistry()[arch])
    p, np_p = _weights(cfg)
    batch = _batch(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "embeds" in tb:
        tb["embeds"] = tb["embeds"].bfloat16()
    new, opt, m = make_train_step(cfg)(p, adamw.init(p), tb)
    _check_step(cfg, jcfg, np_p, batch, new, opt, m)


@pytest.mark.requires_cuda
def test_moe_ffn_bwd_bf16_kernel_matches_plain():
    dev = cuda_device()
    for R, d, ff, E in ((96, 64, 64, 4), (1000, 256, 192, 8)):
        a = _moe_inputs(R, d, ff, E, seed=R)
        args = [a[k].to(dev) for k in ARGS]
        dy = a["dy"].to(dev)
        guh = KM.moe_ffn_train(*args)[1:]
        got = KM.moe_ffn_backward(dy, *args, *guh)
        want = KM.moe_ffn_backward(dy.cpu(), *(t.cpu() for t in args),
                                   *(t.cpu() for t in guh))
        for x, w in zip(got, want):
            assert x.dtype == w.dtype
            err = float((x.cpu().float() - w.float()).abs().max())
            assert err <= BWD_REL * float(w.float().abs().max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b"])
def test_bf16_train_step_card_matches_cpu(arch):
    dev = cuda_device()
    cfg = smoke(registry()[arch])
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    runs = []
    for d in ("cpu", dev):
        p = tree.map_leaves(lambda t: t.to(d), _weights(cfg)[0])
        new, opt, m = make_train_step(cfg)(p, adamw.init(p), batch)
        runs.append((float(m["loss"]), [t.float().cpu()
                                        for t in tree.leaves(new)]))
    (lc, pc), (lg, pg) = runs
    assert abs(lc - lg) <= LOSS_REL * abs(lc)
    for a, b in zip(pc, pg):
        reach = 2 * LR * (1 + WD * a.abs()) + BF16_ULP * (a.abs() + 2 * LR)
        assert bool(((a - b).abs() <= reach).all())


# =============================================================================
# on the card: the bf16 moe_ffn_bwd kernels at their tile edges and the
# bit rules, at olmoe's and mixtral's widths
# =============================================================================

BF16_WIDTHS = [(2048, 1024), (4096, 14336)]     # olmoe's, mixtral's d, ff


def _card_bf16_inputs(dev, sizes, d, ff, seed):
    """Seeded bf16 rows and weights, float32 dy and gate weights on the
    card for groups of ``sizes`` rows."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e, R = len(sizes), sum(sizes)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=dev) * s
    xg, dy = rnd(R, d).bfloat16(), rnd(R, d)
    w = [rnd(e, d, ff, s=d ** -0.5).bfloat16(),
         rnd(e, d, ff, s=d ** -0.5).bfloat16(),
         rnd(e, ff, d, s=ff ** -0.5).bfloat16()]
    gate = torch.rand(R, generator=g, device=dev)
    offs = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32, device=dev)
    return dy, xg, offs, w, gate


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,ff,empty_experts", [
    (2048, 1024, 0), (2048, 1024, 64),
    (4096, 14336, 0), (4096, 14336, 2)])   # mixtral's: 73 experts' dW and
                                           # the plain one's overfill 80 GB
@pytest.mark.parametrize("sizes", [
    [0, 1, 63, 64, 65, 127, 128, 129, 300],   # the 64-deep stage and
                                              # 128-row tile edges
    [3, 70, 5, 130, 1, 0, 61],                # groups starting anywhere
    [1, 0, 0, 2]])                            # R 3
def test_bf16_backward_kernel_at_tile_edges(sizes, d, ff, empty_experts):
    """The bf16 kernels from the training forward's g, u and h against
    the plain version: every output finite, in the plain version's type
    and within ``BWD_REL`` of its largest magnitude, three launches, and
    an expert without rows has exactly zero weight gradients."""
    from repro_torch import kernels
    dev = cuda_device()
    sizes = sizes + [0] * empty_experts
    dy, xg, offs, w, gate = _card_bf16_inputs(dev, sizes, d, ff, 80)
    _, g, u, h = KM.moe_ffn_train(xg, offs, *w, gate)
    kernels.reset_launch_counts()
    got = KM.moe_ffn_backward(dy, xg, offs, *w, gate, g, u, h)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_ffn_bwd"] == KM.BWD_LAUNCHES
    want = KM.moe_ffn_backward_plain(dy, xg, offs, *w, gate, g, u, h)
    for name, x, ref in zip(("dx", "dWg", "dWu", "dWd", "dgate"), got,
                            want):
        assert x.dtype == ref.dtype, name
        assert bool(torch.isfinite(x).all()), name
        err = float((x.float() - ref.float()).abs().max())
        assert err <= BWD_REL * float(ref.float().abs().max()), (name, err)
    for e in np.flatnonzero(np.asarray(sizes) == 0):
        for dw in got[1:4]:
            assert int(torch.count_nonzero(dw[e])) == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,ff", BF16_WIDTHS)
def test_bf16_backward_row_bits_do_not_depend_on_the_group(d, ff):
    """A row's dx and dgate bits alone, in a 128-row group and in a
    2048-row group are the same; two calls give the same bits of every
    output; and dW depends only on its group's rows in order: the same
    rows as the second of two groups give the first group's dW bits."""
    dev = cuda_device()
    dy, xg, _, w, gate = _card_bf16_inputs(dev, [2048], d, ff, 81)

    def run(rows, split=None):
        rows = torch.as_tensor(rows, device=dev)
        n = rows.numel()
        offs = torch.tensor([0, n] if split is None else [0, split, n],
                            dtype=torch.int32, device=dev)
        ws = w if split is None else [torch.cat([t, t]) for t in w]
        x, c = xg[rows].contiguous(), gate[rows].contiguous()
        guh = KM.moe_ffn_train(x, offs, *ws, c)[1:]
        return KM.moe_ffn_backward(dy[rows].contiguous(), x, offs, *ws, c,
                                   *guh)
    full = run(list(range(2048)))
    again = run(list(range(2048)))
    for a, b in zip(full, again):
        assert torch.equal(a, b)
    for r in (0, 63, 64, 1000, 2047):
        for part in (run([r]), run([(r + i) % 2048 for i in range(128)])):
            assert torch.equal(part[0][0], full[0][r])
            assert torch.equal(part[4][0], full[4][r])
    # 300 rows alone, then behind 77 other rows in a second expert with the
    # same weights: expert 1's dW equals the lone group's bit for bit
    rows = list(range(300))
    alone = run(rows)
    behind = run(list(range(1000, 1077)) + rows, split=77)
    for a, b in zip(alone[1:4], behind[1:4]):
        assert torch.equal(a[0], b[1])
