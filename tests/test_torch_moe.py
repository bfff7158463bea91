"""The MoE FFN of the port (``repro_torch.models.moe`` and kernel
``moe_ffn``) against the JAX package's ``repro.models.moe``.

On the CPU, with the same numpy inputs: ``route`` in both softmax orders
(olmoe: softmax then top-k; mixtral: top-k of the logits, then softmax),
``moe_sorted_local`` and the plain ``moe_ffn`` (the grouped SwiGLU of
``_grouped_ffn`` times the gate weights) at T = 1, 7 and 64 tokens, and
``transformer.ffn_block`` with a padding mask against JAX ``_ffn_block``.
Expert ids and counts must be exact, float outputs within ``atol=1e-5,
rtol=1e-4``.  The ``requires_cuda`` cases hold the kernel against its
plain version on the card (bf16 within 3e-3 of |plain|, float32 within
1e-5) and check that a row's bits are the same alone, in a 128-row group
and in a 2048-row group; they skip here.

JAX is imported inside the tests that use it, so the card cases collect
on a machine that has only torch.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import (assert_close, assert_same, cap_threads,
                                  cuda_device)
from repro_torch import kernels
from repro_torch.configs.base import registry, smoke
from repro_torch.kernels import moe_ffn as KM
from repro_torch.models import moe
from repro_torch.models import transformer as T

cap_threads()

D, FF, E = 64, 128, 8


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    return jax, jnp, jmoe


def _params(seed, d=D, ff=FF, e=E, dtype=np.float32):
    rng = np.random.RandomState(seed)
    s = d ** -0.5
    return {"w_router": (rng.standard_normal((d, e)) * s).astype(dtype),
            "w_gate": (rng.standard_normal((e, d, ff)) * s).astype(dtype),
            "w_up": (rng.standard_normal((e, d, ff)) * s).astype(dtype),
            "w_down": (rng.standard_normal((e, ff, d)) * s).astype(dtype)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("T_", [1, 7, 64])
@pytest.mark.parametrize("softmax_first,top_k", [(True, 2), (True, 4),
                                                 (False, 2)])
def test_route_matches_jax(T_, softmax_first, top_k):
    _, jnp, jmoe = _jax()
    p = _params(1)
    x = np.random.RandomState(T_).standard_normal((T_, D)).astype(np.float32)
    w, idx, probs, counts = moe.route(
        _t(x), _t(p["w_router"]), top_k, softmax_before_topk=softmax_first)
    jw, jidx, jprobs, jcounts = jmoe.route(
        jnp.asarray(x), jnp.asarray(p["w_router"]), top_k,
        softmax_before_topk=softmax_first)
    assert_same(idx, np.asarray(jidx))
    assert_same(counts, np.asarray(jcounts))
    assert counts.dtype == torch.int32 and int(counts.sum()) == T_ * top_k
    assert_close(w, jw)
    assert_close(probs, jprobs)
    assert_close(w.sum(-1), np.ones(T_))


@pytest.mark.parametrize("T_", [1, 7, 64])
@pytest.mark.parametrize("softmax_first,top_k", [(True, 4), (False, 2)])
def test_moe_sorted_local_matches_jax(T_, softmax_first, top_k):
    _, jnp, jmoe = _jax()
    p = _params(2)
    x = np.random.RandomState(10 + T_).standard_normal((T_, D)).astype(
        np.float32)
    out, probs, idx, counts = moe.moe_sorted_local(
        _t(x), {k: _t(v) for k, v in p.items()}, top_k,
        softmax_before_topk=softmax_first)
    jout, jprobs, jidx, jcounts = jmoe.moe_sorted_local(
        jnp.asarray(x), jmoe.MoEParams(**{k: jnp.asarray(v)
                                          for k, v in p.items()}), top_k,
        softmax_before_topk=softmax_first)
    assert out.shape == (T_, D) and out.dtype == torch.float32
    assert_same(idx, np.asarray(jidx))
    assert_same(counts, np.asarray(jcounts))
    assert_close(out, jout)
    assert_close(probs, jprobs)


@pytest.mark.parametrize("sizes", [[0, 3, 1, 0, 5, 0, 0, 2],
                                   [16, 0, 0, 0, 0, 0, 0, 0],
                                   [1] * E])
def test_moe_ffn_plain_matches_grouped_ffn(sizes):
    """The plain ``moe_ffn`` against JAX ``_grouped_ffn`` (three
    ``ragged_dot``s) times the gate weights, empty groups included."""
    _, jnp, jmoe = _jax()
    p = _params(3)
    R = sum(sizes)
    rng = np.random.RandomState(4)
    xg = rng.standard_normal((R, D)).astype(np.float32)
    gate = rng.rand(R).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    y = KM.moe_ffn(_t(xg), _t(offs), _t(p["w_gate"]), _t(p["w_up"]),
                   _t(p["w_down"]), _t(gate))
    jy = jmoe._grouped_ffn(jnp.asarray(xg), jnp.asarray(sizes, jnp.int32),
                           jnp.asarray(p["w_gate"]), jnp.asarray(p["w_up"]),
                           jnp.asarray(p["w_down"])) * gate[:, None]
    assert y.dtype == torch.float32
    assert_close(y, jy)


def test_moe_ffn_launches_nothing_on_the_cpu():
    """CPU tensors take the plain version: no kernel launch is counted."""
    p = _params(5)
    kernels.reset_launch_counts()
    KM.moe_ffn(torch.zeros((4, D)), torch.tensor([0, 4] + [4] * (E - 1),
                                                 dtype=torch.int32),
               *(_t(p[k]) for k in ("w_gate", "w_up", "w_down")),
               torch.ones(4))
    assert kernels.launch_counts()["moe_ffn"] == 0


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x7b"])
def test_ffn_block_counts_only_valid_rows(arch):
    """``ffn_block`` of a smoke MoE layer on carried weights against JAX
    ``_ffn_block`` with a padding mask: the outputs of every row (padding
    too) within tolerance, the counts of the valid rows exact."""
    jax, jnp, _ = _jax()
    from repro.configs import registry as jregistry
    from repro.configs import smoke as jsmoke
    from repro.models import transformer as JT
    from repro_torch.convert import params_from_jax
    cfg = smoke(registry()[arch])
    jcfg = jsmoke(jregistry()[arch])
    jp = JT.init_params(jcfg, jax.random.PRNGKey(7))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert_same(tp["layers"][1]["moe"]["w_down"],
                np.asarray(jp["layers"]["moe"]["w_down"][1]))
    rng = np.random.RandomState(8)
    h = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    valid = rng.rand(2, 9) < 0.6
    lp = tp["layers"][1]
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    out, counts = T.ffn_block(lp, cfg, _t(h), valid=_t(valid))
    jout, jcounts, _ = JT._ffn_block(jlp, jcfg, jnp.asarray(h), None,
                                     valid=jnp.asarray(valid))
    assert_close(out, jout)
    assert_same(counts, np.asarray(jcounts))
    assert int(counts.sum()) == int(valid.sum()) * cfg.top_k
    _, all_counts = T.ffn_block(lp, cfg, _t(h))
    assert int(all_counts.sum()) == 18 * cfg.top_k


def test_init_params_draws_moe_leaves():
    """``init_params`` of an MoE arch: ``lp["moe"]`` with JAX's shapes and
    d**-0.5 scales on all four leaves (w_down too), in the target type."""
    cfg = smoke(registry()["olmoe_1b_7b"])
    tp = T.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    lp = tp["layers"][0]
    assert "mlp" not in lp
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    shapes = {"w_router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff),
              "w_down": (e, ff, d)}
    for k, shape in shapes.items():
        w = lp["moe"][k]
        assert w.shape == shape and w.dtype == torch.bfloat16
        assert abs(float(w.float().std()) - d ** -0.5) < 0.1 * d ** -0.5


# =============================================================================
# on the card: the kernel against its plain version, and its bit rule
# =============================================================================

def _card_inputs(dev, dtype, sizes, d, ff, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e = len(sizes)
    R = sum(sizes)

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dtype)
    xg = rnd(R, d)
    w = [rnd(e, d, ff, s=d ** -0.5), rnd(e, d, ff, s=d ** -0.5),
         rnd(e, ff, d, s=d ** -0.5)]
    gate = torch.rand(R, generator=g, device=dev)
    offs = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32, device=dev)
    return xg, offs, w, gate


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-3),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("sizes,d,ff", [
    ([1, 0, 2, 0, 0, 1, 3, 1], 128, 64),
    ([40, 0, 7, 33, 0, 1, 64, 31], 256, 192),
    ([5] * 64, 2048, 1024)])
def test_moe_ffn_kernel_vs_plain(dtype, tol, sizes, d, ff):
    dev = cuda_device()
    xg, offs, w, gate = _card_inputs(dev, dtype, sizes, d, ff, 11)
    kernels.reset_launch_counts()
    y = KM.moe_ffn(xg, offs, *w, gate)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_ffn"] == 2
    want = KM.moe_ffn_plain(xg, offs, *w, gate)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                               atol=tol * float(want.abs().max()), rtol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_ffn_row_bits_do_not_depend_on_the_group(dtype):
    """A row's output bits alone, in a 128-row group and in a 2048-row
    group (at several places in it) are the same."""
    dev = cuda_device()
    d, ff = 256, 128
    xg, _, w, gate = _card_inputs(dev, dtype, [2048], d, ff, 12)
    w = [t[:1] for t in w]

    def run(rows):
        offs = torch.tensor([0, len(rows)], dtype=torch.int32, device=dev)
        return KM.moe_ffn(xg[rows].contiguous(), offs, *w,
                          gate[rows].contiguous())
    full = run(torch.arange(2048, device=dev))
    for r in (0, 77, 1500, 2047):
        assert torch.equal(run(torch.tensor([r], device=dev))[0], full[r])
        rows = torch.arange(r, r + 128, device=dev) % 2048
        assert torch.equal(run(rows)[0], full[r])


@pytest.mark.requires_cuda
def test_moe_ffn_kernel_refuses_unaligned_widths():
    dev = cuda_device()
    xg, offs, w, gate = _card_inputs(dev, torch.float32, [2, 1], 96, 64, 13)
    with pytest.raises(ValueError, match="multiples of 64"):
        KM.moe_ffn(xg, offs, *w, gate)


def _assert_vs_plain(dtype, sizes, d, ff, seed):
    """The kernel against its plain version on the same inputs: bf16
    within 3e-3 of max|plain| (+ 3e-3 |plain|), float32 within 1e-5."""
    tol = 3e-3 if dtype == torch.bfloat16 else 1e-5
    dev = cuda_device()
    xg, offs, w, gate = _card_inputs(dev, dtype, sizes, d, ff, seed)
    kernels.reset_launch_counts()
    y = KM.moe_ffn(xg, offs, *w, gate)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_ffn"] == 2
    want = KM.moe_ffn_plain(xg, offs, *w, gate)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                               atol=tol * float(want.abs().max()), rtol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sizes", [
    [0, 1, 63, 64, 65, 127, 128, 129, 1040],     # the row tiles' edges
    [3, 70, 5, 130, 1, 0, 61],                   # starts off a 64 boundary
    [0, 0, 300, 0],                              # every row in one expert
    [1, 0, 0, 2]])                               # R 3: boxes past R
@pytest.mark.parametrize("empty_experts", [0, 64])
def test_moe_ffn_kernel_at_tile_edges(dtype, sizes, empty_experts):
    """Group sizes at the kernels' 16/32/64/128-row tile edges, groups
    that start anywhere, R not a multiple of 64 (the TMA boxes and
    cp.async rows past R read zeros) and one expert holding every row;
    with 64 empty experts more, R <= 32 E, the float32 entry's narrow
    tiling (32-row units) takes the same groups."""
    _assert_vs_plain(dtype, sizes + [0] * empty_experts, 256, 192, 21)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_ffn_kernel_at_mixtral_widths(dtype):
    """A few rows at mixtral_8x7b's widths (d 4096, ff 14336): 112 gate/up
    column tiles and the down reduction over 14336."""
    _assert_vs_plain(dtype, [2, 0, 1], 4096, 14336, 22)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_ffn_graph_replay_matches_eager(dtype):
    """The two launches captured in a CUDA graph (offsets read on the
    device, no host sync, no API call after the first launch) replay the
    eager call's bits, also after the routing changes in place."""
    dev = cuda_device()
    sizes = [5, 0, 70, 1, 0, 130, 2, 48]
    xg, offs, w, gate = _card_inputs(dev, dtype, sizes, 256, 192, 23)
    KM.moe_ffn(xg, offs, *w, gate)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = KM.moe_ffn(xg, offs, *w, gate)
    for new in (sizes, [256, 0, 0, 0, 0, 0, 0, 0], [0] * 7 + [256]):
        offs.copy_(torch.tensor(np.concatenate([[0], np.cumsum(new)]),
                                dtype=torch.int32, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, KM.moe_ffn(xg, offs, *w, gate))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_ffn_row_bits_at_olmoe_widths(dtype):
    """At olmoe_1b_7b's widths (d 2048, ff 1024), a row's bits alone, in a
    128-row group and in a 2048-row group are the same."""
    dev = cuda_device()
    xg, _, w, gate = _card_inputs(dev, dtype, [2048], 2048, 1024, 24)

    def run(rows):
        rows = torch.as_tensor(rows, device=dev)
        offs = torch.tensor([0, rows.numel()], dtype=torch.int32, device=dev)
        return KM.moe_ffn(xg[rows].contiguous(), offs, *w,
                          gate[rows].contiguous())
    full = run(list(range(2048)))
    for r in (0, 63, 64, 1000, 2047):
        assert torch.equal(run([r])[0], full[r])
        assert torch.equal(run([(r + i) % 2048 for i in range(128)])[0],
                           full[r])
