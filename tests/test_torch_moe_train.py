"""MoE training in the port: ``moe_ffn``'s gradient, the load-balancing
loss, ``moe_sorted_local`` under autograd and the MoE training drivers.

On the CPU, with the same numpy inputs as the JAX package:
``moe_ffn_backward_plain`` against ``jax.vjp`` of ``_grouped_ffn(...) *
gate[:, None]`` and against autograd of ``moe_ffn_plain`` (rows sorted
by ``route`` in both softmax orders, T = 1, 7 and 64, with and without
empty experts; each output within 1e-4 of its largest magnitude),
``aux_load_balance_loss`` against JAX's (1e-5 relative), the gradients of
``moe_sorted_local`` (routing, gather, grouped FFN, gate weights and
combine) against ``jax.grad`` of JAX's, which grad-enabled calls take
the autograd path and how often a remat step calls the FFN and its
backward, the twin of ``test_loss_decreases_moe`` (60 steps), a short
crash and restart of ``launch.train_moe_tiered`` and ``launch.train``'s
default (olmoe) arch.

The ``requires_cuda`` cases hold ``moe_ffn_bwd``'s kernels against the
plain version on the card (every output within 1e-5 of its largest
magnitude, empty experts' weight gradients exactly zero) at the tiles'
edges, with empty experts, at olmoe's and mixtral's widths, check that
a row's input-gradient bits do not depend on its group and that two
calls give the same bits, and compare a smoke MoE training gradient on
the card with the CPU's; they skip here.  JAX is imported inside the
tests that use it, so the card cases collect on a machine that has only
torch.
"""
import re
import tempfile
from dataclasses import replace

import numpy as np
import pytest
import torch

from helpers.torch_parity import (assert_close, cap_threads, cuda_device,
                                  np_of)
from repro_torch import kernels, tree
from repro_torch.configs.base import get_arch, registry, smoke
from repro_torch.kernels import moe_ffn as KM
from repro_torch.models import moe
from repro_torch.models import transformer as T

cap_threads()

D, FF, E = 64, 128, 8
REL = 1e-4          # a gradient within 1e-4 of its largest magnitude
KERNEL_REL = 1e-5   # the kernel against the plain version on the card
ORDERS = [(True, 4), (False, 2)]    # olmoe-style and mixtral-style routing


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    return jax, jnp, jmoe


def _params(seed, d=D, ff=FF, e=E):
    rng = np.random.RandomState(seed)
    s = d ** -0.5
    return {"w_router": (rng.standard_normal((d, e)) * s).astype(np.float32),
            "w_gate": (rng.standard_normal((e, d, ff)) * s).astype(np.float32),
            "w_up": (rng.standard_normal((e, d, ff)) * s).astype(np.float32),
            "w_down": (rng.standard_normal((e, ff, d)) * s).astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _x(T_, seed, empty):
    """T_ tokens; with ``empty`` feature 0 is a constant 4 and the router
    column of experts 0-3 there is lowered by 3, so no token picks them."""
    x = np.random.RandomState(seed).standard_normal((T_, D)).astype(
        np.float32)
    if empty:
        x[:, 0] = 4.0
    return x


def _sorted_rows(T_, softmax_first, top_k, empty, seed):
    """Rows sorted by expert as ``moe_sorted_local`` makes them from
    ``route``: (params, xg, offs, group sizes, gate weights, dy)."""
    p = _params(seed)
    if empty:
        p["w_router"][0, :E // 2] -= 3.0
    x = _x(T_, seed + 1, empty)
    w, idx, _, counts = moe.route(_t(x), _t(p["w_router"]), top_k,
                                  softmax_before_topk=softmax_first)
    order = torch.argsort(idx.reshape(-1), stable=True)
    xg = _t(x)[order // top_k]
    sizes = counts.numpy()
    offs = _t(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    gate = w.reshape(-1)[order].contiguous()
    dy = np.random.RandomState(seed + 2).standard_normal(
        (T_ * top_k, D)).astype(np.float32)
    return p, xg, offs, sizes, gate, _t(dy)


def _rel_close(got, want, rel=REL, what=""):
    want = np_of(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np_of(got), want, atol=rel * scale, rtol=0,
                               err_msg=what)


NAMES = ("dxg", "dw_gate", "dw_up", "dw_down", "dgate")


@pytest.mark.parametrize("T_", [1, 7, 64])
@pytest.mark.parametrize("softmax_first,top_k", ORDERS)
@pytest.mark.parametrize("empty", [False, True])
def test_backward_plain_matches_jax_vjp_and_autograd(T_, softmax_first,
                                                     top_k, empty):
    jax, jnp, jmoe = _jax()
    p, xg, offs, sizes, gate, dy = _sorted_rows(T_, softmax_first, top_k,
                                                empty, 30 + T_)
    if empty:
        assert (sizes[:E // 2] == 0).all()
    ws = [_t(p[k]) for k in ("w_gate", "w_up", "w_down")]
    got = KM.moe_ffn_backward_plain(dy, xg, offs, *ws, gate)
    # from the training forward's g, u and h: the same bits, and y is
    # moe_ffn_plain's
    y, g, u, h = KM.moe_ffn_train_plain(xg, offs, *ws, gate)
    assert torch.equal(y, KM.moe_ffn_plain(xg, offs, *ws, gate))
    kept = KM.moe_ffn_backward_plain(dy, xg, offs, *ws, gate, g, u, h)
    for name, a, b in zip(NAMES, kept, got):
        assert torch.equal(a, b), name

    gs = jnp.asarray(sizes, jnp.int32)

    def f(xg_, wg, wu, wd, c):
        return jmoe._grouped_ffn(xg_, gs, wg, wu, wd) * c[:, None]
    _, vjp = jax.vjp(f, jnp.asarray(xg.numpy()),
                     *(jnp.asarray(p[k]) for k in ("w_gate", "w_up",
                                                   "w_down")),
                     jnp.asarray(gate.numpy()))
    want_jax = vjp(jnp.asarray(dy.numpy()))

    leaves = [t.clone().requires_grad_(True) for t in (xg, *ws, gate)]
    y = KM.moe_ffn_plain(leaves[0], offs, *leaves[1:4], leaves[4])
    want_ag = torch.autograd.grad(y, leaves, dy)

    for name, g, wj, wa in zip(NAMES, got, want_jax, want_ag):
        assert g.dtype == torch.float32 and g.shape == wa.shape
        _rel_close(g, wj, what=f"{name} vs jax.vjp")
        _rel_close(g, wa, what=f"{name} vs autograd")
    for e in np.flatnonzero(sizes == 0):
        for g in got[1:4]:
            assert torch.count_nonzero(g[e]) == 0


@pytest.mark.parametrize("T_", [1, 7, 64])
@pytest.mark.parametrize("softmax_first,top_k", ORDERS)
def test_aux_load_balance_loss_matches_jax(T_, softmax_first, top_k):
    _, jnp, jmoe = _jax()
    p = _params(40)
    x = _x(T_, 41 + T_, False)
    _, idx, probs, _ = moe.route(_t(x), _t(p["w_router"]), top_k,
                                 softmax_before_topk=softmax_first)
    _, jidx, jprobs, _ = jmoe.route(jnp.asarray(x),
                                    jnp.asarray(p["w_router"]), top_k,
                                    softmax_before_topk=softmax_first)
    got = moe.aux_load_balance_loss(probs, idx, E)
    want = jmoe.aux_load_balance_loss(jprobs, jidx, E)
    assert got.dtype == torch.float32 and got.shape == ()
    assert_close(got, np.asarray(want), atol=0, rtol=1e-5)


@pytest.mark.parametrize("T_", [1, 7, 64])
@pytest.mark.parametrize("softmax_first,top_k", ORDERS)
def test_moe_sorted_local_gradients_match_jax(T_, softmax_first, top_k):
    """The gradients of x and all four weight leaves through routing,
    the gather (each token's slots summed in slot order), the grouped FFN
    (``moe_ffn_backward``), the gate weights and the combine, for a
    seeded cotangent of the output, against ``jax.grad`` of JAX's
    ``moe_sorted_local``; within 1e-4 of each gradient's largest."""
    jax, jnp, jmoe = _jax()
    p = _params(50)
    x = _x(T_, 51 + T_, False)
    cot = np.random.RandomState(52).standard_normal((T_, D)).astype(
        np.float32)

    def jloss(x_, pp):
        out = jmoe.moe_sorted_local(x_, jmoe.MoEParams(**pp), top_k,
                                    softmax_before_topk=softmax_first)[0]
        return jnp.sum(out * cot)
    jgrads = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})

    tx = _t(x).requires_grad_(True)
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    out = moe.moe_sorted_local(tx, tp, top_k,
                               softmax_before_topk=softmax_first)[0]
    assert out.grad_fn is not None
    (out * _t(cot)).sum().backward()
    _rel_close(tx.grad, jgrads[0], what="x")
    for k in p:
        _rel_close(tp[k].grad, jgrads[1][k], what=k)


def test_backward_refuses_bfloat16():
    """bfloat16 rows and weights have a backward now (their gradients
    leave in bf16, dgate in float32); a type with no kernel entry,
    float16, is refused on every device."""
    p = _params(60)
    offs = _t(np.array([0, 3] + [3] * (E - 1), np.int32))
    for dt in (torch.bfloat16, torch.float16):
        ws = [_t(p[k]).to(dt) for k in ("w_gate", "w_up", "w_down")]
        xg = torch.zeros((3, D), dtype=dt)
        if dt == torch.float16:
            with pytest.raises(TypeError, match="float32 or bfloat16"):
                KM.moe_ffn_backward(torch.zeros((3, D)), xg, offs, *ws,
                                    torch.ones(3))
            continue
        out = KM.moe_ffn_backward(torch.zeros((3, D)), xg, offs, *ws,
                                  torch.ones(3))
        assert [t.dtype for t in out] == [dt] * 4 + [torch.float32]


def test_autograd_path_only_when_a_gradient_can_flow(monkeypatch):
    """Serving's calls (no input requiring a gradient, or grad off) run
    the plain gather and ``moe_ffn`` with no graph; a training call runs
    ``moe_ffn_backward`` once in its backward.  On the CPU nothing is
    counted as a launch."""
    calls = []
    real = moe.moe_ffn_backward
    monkeypatch.setattr(moe, "moe_ffn_backward",
                        lambda *a: calls.append(1) or real(*a))
    p = {k: _t(v) for k, v in _params(61).items()}
    x = _t(_x(9, 62, False))
    kernels.reset_launch_counts()
    assert moe.moe_sorted_local(x, p, 2)[0].grad_fn is None
    p["w_up"].requires_grad_(True)
    with torch.no_grad():
        assert moe.moe_sorted_local(x, p, 2)[0].grad_fn is None
    out = moe.moe_sorted_local(x, p, 2)[0]
    out.sum().backward()
    assert calls == [1]
    assert p["w_up"].grad.abs().sum() > 0
    counts = kernels.launch_counts()
    assert counts["moe_ffn"] == counts["moe_ffn_bwd"] == 0


@pytest.mark.parametrize("remat", [True, False])
def test_a_training_step_calls_the_ffn_as_the_card_counts(monkeypatch,
                                                          remat):
    """One microbatch's loss and backward of smoke olmoe: ``moe_ffn``
    once a layer in the forward and once more in remat's recompute,
    ``moe_ffn_backward`` once a layer — the card's launches are 2 and 3
    of each.  Under autograd the float32 forward is ``moe_ffn_train``
    (``moe_ffn``'s launches, g and u kept), counted with ``moe_ffn``.
    The metrics carry the aux loss and the counts (tokens x top_k x
    layers)."""
    fwd, bwd = [], []
    real_fwd, real_bwd = moe.moe_ffn, moe.moe_ffn_backward
    real_train = moe.moe_ffn_train
    monkeypatch.setattr(moe, "moe_ffn",
                        lambda *a: fwd.append(1) or real_fwd(*a))
    monkeypatch.setattr(moe, "moe_ffn_train",
                        lambda *a: fwd.append(1) or real_train(*a))
    monkeypatch.setattr(moe, "moe_ffn_backward",
                        lambda *a: bwd.append(1) or real_bwd(*a))
    cfg = replace(smoke(registry()["olmoe_1b_7b"]), remat=remat)
    params = T.init_params(cfg, seed=0, device="cpu")
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    total, metrics = T.loss_fn(params, cfg, {"tokens": tokens,
                                             "labels": tokens})
    total.backward()
    L = cfg.n_layers
    assert len(fwd) == (2 if remat else 1) * L and len(bwd) == L
    assert float(metrics["moe_aux"].detach()) > 0
    assert metrics["expert_counts"].dtype == torch.int32
    assert int(metrics["expert_counts"].sum()) == 16 * cfg.top_k * L


@pytest.mark.parametrize("remat", [True, False])
def test_grouped_ffn_hands_the_backward_the_forwards_g_u_h(monkeypatch,
                                                            remat):
    """Each layer's backward gets the g, u and h tensors that a forward
    of that layer made (under remat: the recompute's, the first
    forward's saved tensors being dropped), with the bits of the
    recompute form: the gradients equal those of
    ``moe_ffn_backward_plain`` computing g, u and h itself."""
    made, handed = [], []
    real_train, real_bwd = moe.moe_ffn_train, moe.moe_ffn_backward

    def train(*a):
        out = real_train(*a)
        made.append(out[1:])
        return out

    def bwd(*a):
        handed.append(a[7:])
        got = real_bwd(*a)
        for x, y in zip(got, KM.moe_ffn_backward_plain(*a[:7])):
            assert torch.equal(x, y)
        return got
    monkeypatch.setattr(moe, "moe_ffn_train", train)
    monkeypatch.setattr(moe, "moe_ffn_backward", bwd)
    cfg = replace(smoke(registry()["olmoe_1b_7b"]), remat=remat)
    params = T.init_params(cfg, seed=1, device="cpu")
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    total, _ = T.loss_fn(params, cfg, {"tokens": tokens, "labels": tokens})
    total.backward()
    L = cfg.n_layers
    assert len(made) == (2 if remat else 1) * L and len(handed) == L
    ptrs = {t.data_ptr(): (i, j) for i, guh in enumerate(made)
            for j, t in enumerate(guh)}
    for guh in handed:
        assert len(guh) == 3
        where = [ptrs.get(t.data_ptr()) for t in guh]
        assert None not in where
        i = where[0][0]
        assert where == [(i, 0), (i, 1), (i, 2)]
        assert i >= L if remat else i < L
        assert all(torch.equal(a, b) for a, b in zip(guh, made[i]))


def test_loss_decreases_moe():
    """Twin of ``tests/test_train_integration.py::test_loss_decreases_moe``:
    smoke olmoe, 60 steps of batch 8, seq 32."""
    from repro_torch.launch.train import train_loop
    cfg = smoke(get_arch("olmoe_1b_7b"))
    losses, _, _ = train_loop(cfg, steps=60, global_batch=8, seq_len=32,
                              n_micro=2, log_every=0, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.4


def test_train_moe_tiered_crashes_and_restarts(capsys):
    """``launch.train_moe_tiered.run`` at 8 steps with a checkpoint every
    2: the crash at step 4 restarts from its checkpoint and trains steps
    4-7, printing the JAX example's lines."""
    from repro_torch.launch import train_moe_tiered as tiered
    with tempfile.TemporaryDirectory() as d:
        losses, _, opt = tiered.run(tiered.config(), steps=8, device="cpu",
                                    ckpt_dir=d, ckpt_every=2)
    assert len(losses) == 4 and int(opt.step) == 8
    assert all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "=== training with a simulated crash at step 4 ===" in out
    assert "!! simulated crash at step 4 — restarting from the latest " \
           "checkpoint" in out
    assert re.search(r"recovered \+ finished: loss \d+\.\d{4} \.\.\. "
                     r"\d+\.\d{4}", out)


def test_tiered_twin_raises_without_a_card():
    from repro_torch.launch import train_moe_tiered as tiered
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiered.main([])


def test_launch_train_defaults_to_olmoe(capsys):
    """``python -m repro_torch.launch.train --smoke --steps 5 --device
    cpu`` trains its default arch, olmoe_1b_7b."""
    from repro_torch.launch.train import main
    assert main(["--smoke", "--steps", "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"step +0 +loss \d+\.\d{4} +gnorm", out)
    assert re.search(r"final loss \d+\.\d{4} \(from \d+\.\d{4}\)", out)


# =============================================================================
# on the card: moe_ffn_bwd's kernels against the plain version
# =============================================================================

def _card_inputs(dev, sizes, d, ff, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e = len(sizes)
    R = sum(sizes)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=dev) * s
    xg, dy = rnd(R, d), rnd(R, d)
    w = [rnd(e, d, ff, s=d ** -0.5), rnd(e, d, ff, s=d ** -0.5),
         rnd(e, ff, d, s=d ** -0.5)]
    gate = torch.rand(R, generator=g, device=dev)
    offs = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32, device=dev)
    return dy, xg, offs, w, gate


def _assert_bwd_vs_plain(sizes, d, ff, seed):
    """From the training forward's g, u and h, every output of the
    kernels within 1e-5 of the largest magnitude of the plain version's,
    three launches, and an expert without rows has exactly zero weight
    gradients."""
    dev = cuda_device()
    dy, xg, offs, w, gate = _card_inputs(dev, sizes, d, ff, seed)
    _, g, u, h = KM.moe_ffn_train(xg, offs, *w, gate)
    kernels.reset_launch_counts()
    got = KM.moe_ffn_backward(dy, xg, offs, *w, gate, g, u, h)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_ffn_bwd"] == KM.BWD_LAUNCHES
    want = KM.moe_ffn_backward_plain(dy, xg, offs, *w, gate)
    for name, g, wt in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        _rel_close(g, wt, rel=KERNEL_REL, what=name)
    for e in np.flatnonzero(np.asarray(sizes) == 0):
        for g in got[1:4]:
            assert torch.count_nonzero(g[e]) == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("sizes", [
    [0, 1, 31, 32, 33, 127, 128, 129, 300],   # the row tiles' edges
    [3, 70, 5, 130, 1, 0, 61],                # groups starting anywhere
    [0, 0, 300, 0],                           # every row in one expert
    [1, 0, 0, 2]])                            # R 3
@pytest.mark.parametrize("empty_experts", [0, 64])
def test_backward_kernel_at_tile_edges(sizes, empty_experts):
    """Group sizes at the 32-row stage and 128-row tile edges, d 256 and
    ff 192 (column tiles past the edge of both), with 64 empty experts
    more."""
    _assert_bwd_vs_plain(sizes + [0] * empty_experts, 256, 192, 70)


@pytest.mark.requires_cuda
def test_backward_kernel_at_olmoe_widths():
    """olmoe_1b_7b's widths (d 2048, ff 1024), 64 experts, some empty."""
    sizes = [0, 40, 3, 0, 129] * 12 + [1, 0, 64, 2]
    _assert_bwd_vs_plain(sizes, 2048, 1024, 71)


@pytest.mark.requires_cuda
def test_backward_kernel_at_mixtral_widths():
    """mixtral_8x7b's widths (d 4096, ff 14336): the dx reduction over
    2 x 14336, 112 column tiles of h."""
    _assert_bwd_vs_plain([2, 0, 33, 1, 0, 0, 0, 40], 4096, 14336, 72)


@pytest.mark.requires_cuda
def test_backward_row_bits_do_not_depend_on_the_group():
    """A row's dxg and dgate bits alone, in a 128-row group and in a
    2048-row group are the same, and two calls give the same bits of
    every output."""
    dev = cuda_device()
    dy, xg, _, w, gate = _card_inputs(dev, [2048], 512, 256, 73)

    def run(rows):
        rows = torch.as_tensor(rows, device=dev)
        offs = torch.tensor([0, rows.numel()], dtype=torch.int32, device=dev)
        x, c = xg[rows].contiguous(), gate[rows].contiguous()
        guh = KM.moe_ffn_train(x, offs, *w, c)[1:]
        return KM.moe_ffn_backward(dy[rows].contiguous(), x, offs, *w, c,
                                   *guh)
    full = run(list(range(2048)))
    again = run(list(range(2048)))
    for a, b in zip(full, again):
        assert torch.equal(a, b)
    for r in (0, 31, 128, 1000, 2047):
        for part in (run([r]), run([(r + i) % 2048 for i in range(128)])):
            assert torch.equal(part[0][0], full[0][r])
            assert torch.equal(part[4][0], full[4][r])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("sizes,d,ff", [
    ([0, 1, 31, 32, 33, 127, 128, 129, 300] + [0] * 64, 256, 192),
    ([0, 40, 3, 0, 129] * 12 + [1, 0, 64, 2], 2048, 1024),
    ([2, 0, 33, 1, 0, 0, 0, 40], 4096, 14336)])
def test_training_gate_up_keeps_the_serving_bits(sizes, d, ff):
    """``moe_ffn_train``'s y and h equal ``moe_ffn``'s bit for bit (the
    serving entry's h, read back through the down launch's y), its g
    and u are finite and within 1e-5 of the plain products, and it
    launches as ``moe_ffn`` does."""
    dev = cuda_device()
    _, xg, offs, w, gate = _card_inputs(dev, sizes, d, ff, 74)
    kernels.reset_launch_counts()
    y, g, u, h = KM.moe_ffn_train(xg, offs, *w, gate)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_ffn"] == 2
    assert torch.equal(y, KM.moe_ffn(xg, offs, *w, gate))
    yp, gp, up, hp = KM.moe_ffn_train_plain(xg, offs, *w, gate)
    for name, a, b in (("g", g, gp), ("u", u, up), ("h", h, hp),
                       ("y", y, yp)):
        assert torch.isfinite(a).all(), name
        _rel_close(a, b, rel=KERNEL_REL, what=name)
    # the serving entry's h: the gate/up launch alone, through ctypes
    from repro_torch.kernels import _build
    hs = torch.empty_like(h)
    fn = _build.function("moe_gate_up_f32", KM._ARGTYPES)
    E = len(sizes)
    _build.check(fn(xg.data_ptr(), offs.data_ptr(), w[0].data_ptr(),
                    w[1].data_ptr(), hs.data_ptr(), xg.shape[0], E, d, ff,
                    _build.current_stream(xg.device.index)),
                 "moe_gate_up_f32")
    torch.cuda.synchronize()
    assert torch.equal(h, hs)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x7b"])
def test_moe_training_gradients_card_vs_cpu(arch):
    """One microbatch of a smoke MoE arch: loss, expert counts and every
    gradient leaf on the card against the CPU (counts exact, gradients
    within 1e-4 of each leaf's largest), ``moe_ffn`` launched 4 times a
    layer (forward and remat's recompute) and ``moe_ffn_bwd`` 3 times."""
    dev = cuda_device()
    cfg = smoke(registry()[arch])
    cpu = T.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for where in ("cpu", dev):
        params = tree.map_leaves(lambda t: t.to(where).requires_grad_(True),
                                 cpu)
        b = {"tokens": tokens.to(where), "labels": tokens.to(where)}
        kernels.reset_launch_counts()
        total, metrics = T.loss_fn(params, cfg, b)
        grads = torch.autograd.grad(total, tree.leaves(params))
        out[str(where)] = (total, metrics, grads, kernels.launch_counts())
    (lc, mc, gc, _), (lg, mg, gg, n) = out["cpu"], out[str(dev)]
    assert n["moe_ffn"] == 4 * cfg.n_layers
    assert n["moe_ffn_bwd"] == KM.BWD_LAUNCHES * cfg.n_layers
    assert torch.equal(mg["expert_counts"].cpu(), mc["expert_counts"])
    assert_close(lg, lc)
    for a, b in zip(gg, gc):
        _rel_close(a, b)
