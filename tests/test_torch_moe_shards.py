"""The expert- and tensor-parallel shard bodies of the port's MoE
(``ep_shard_partial``, ``tp_shard_partial``) run one shard after
another on one device, as ``chip_smoke.py``'s ``moe_shards`` phase runs
them.

On the CPU (plain versions): with a capacity that keeps every slot the
EP partials summed in shard order equal ``moe_sorted_local``, and so do
their gradients; at capacity 1.25 the dropped slots add exact zeros; a
local expert with no rows and the zeroed rows in the last group change
nothing; the TP partials over d_ff slices sum to the whole.  On a card
(``requires_cuda``, no JAX): ``moe_ffn`` and, under autograd,
``moe_ffn_bwd`` at the shard layouts (local E 16 and 2, empty local
groups, the invalid tail in the last group) against their plain
versions."""
import pytest
import torch

from helpers.torch_parity import cap_threads, cuda_device
from repro_torch.kernels import moe_ffn as KM
from repro_torch.models import moe

cap_threads()


def _inputs(T, d, E, ff, seed, dtype=torch.float32, device="cpu",
            favour=None):
    """x [T, d] and MoE weights with the init scales; ``favour`` scales
    the router columns of those experts by 4 (a shard that overflows)."""
    g = torch.Generator().manual_seed(seed)
    s = d ** -0.5
    x = torch.randn(T, d, generator=g)
    p = {"w_router": torch.randn(d, E, generator=g) * s,
         "w_gate": torch.randn(E, d, ff, generator=g) * s,
         "w_up": torch.randn(E, d, ff, generator=g) * s,
         "w_down": torch.randn(E, ff, d, generator=g) * s}
    if favour is not None:
        p["w_router"][:, favour] *= 4.0
    return (x.to(device, dtype),
            {k: v.to(device, dtype) for k, v in p.items()})


def _shard(p, m, n):
    E = p["w_router"].shape[1] // n
    return dict(p, **{k: p[k][m * E:(m + 1) * E]
                      for k in ("w_gate", "w_up", "w_down")})


def _ep_sum(x, p, k, n, cap):
    parts = [moe.ep_shard_partial(x, _shard(p, m, n), k, m, n, cap)
             for m in range(n)]
    out = parts[0].out
    for part in parts[1:]:
        out = out + part.out
    return out, parts


@pytest.mark.parametrize("n_ep", [2, 4, 8])
def test_ep_partials_sum_to_the_unsharded_layer(n_ep):
    x, p = _inputs(48, 64, 8, 32, seed=1)
    cap = moe.ep_capacity(48, 2, n_ep, 8.0)
    assert cap == 96                    # every slot: nothing is dropped
    out, parts = _ep_sum(x, p, 2, n_ep, cap)
    want, _, idx, counts = moe.moe_sorted_local(x, p, 2)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
    e_local = 8 // n_ep
    for m, part in enumerate(parts):
        assert torch.equal(part.idx, idx) and torch.equal(part.counts,
                                                          counts)
        mine = int(((idx // e_local) == m).sum())
        assert int(part.valid.sum()) == mine
        # this shard's slots first, by local expert; the tail rides last
        sizes = part.offs.diff()
        mine_sizes = counts[m * e_local:(m + 1) * e_local]
        assert torch.equal(sizes[:-1], mine_sizes[:-1])
        assert int(sizes[-1]) == int(mine_sizes[-1]) + cap - mine
        assert int(part.offs[0]) == 0 and int(part.offs[-1]) == cap


def test_dropped_slots_add_exact_zeros():
    """At capacity 1.25 an overflowing shard drops its last slots: each
    token's sum is the unsharded layer's over the slots kept, and the
    rows that are not the shard's are zero before the FFN."""
    x, p = _inputs(32, 64, 8, 32, seed=2, favour=[0, 1])
    cap = moe.ep_capacity(32, 2, 4, 1.25)
    out, parts = _ep_sum(x, p, 2, 4, cap)
    kept = torch.zeros(32 * 2, dtype=torch.bool)
    for part in parts:
        kept[part.order[part.valid]] = True
    assert not bool(kept.all())          # shard 0 overflows
    w, idx, _, _ = moe.route(x, p["w_router"], 2)
    want = torch.zeros_like(out)
    for t in range(32):
        for j in range(2):
            if kept[t * 2 + j]:
                e = int(idx[t, j])
                h = torch.nn.functional.silu(x[t] @ p["w_gate"][e]) * (
                    x[t] @ p["w_up"][e])
                want[t] += w[t, j] * (h @ p["w_down"][e])
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)


def test_an_empty_local_group_changes_nothing():
    """Experts with no rows inside a shard (here most of them) and an
    invalid tail in the last group: the partials still sum to the
    unsharded layer."""
    x, p = _inputs(16, 64, 32, 32, seed=3, favour=[0, 5])
    out, parts = _ep_sum(x, p, 2, 2, moe.ep_capacity(16, 2, 2, 8.0))
    assert any(bool((part.offs.diff() == 0).any()) for part in parts)
    want = moe.moe_sorted_local(x, p, 2)[0]
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)


def test_ep_gradients_sum_to_the_unsharded_layer():
    x, p = _inputs(24, 64, 8, 32, seed=4)
    dy = torch.randn(24, 64, generator=torch.Generator().manual_seed(5))

    def grads(fn):
        xs = x.clone().requires_grad_(True)
        ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        (fn(xs, ps) * dy).sum().backward()
        return [xs.grad] + [ps[k].grad for k in sorted(ps)]

    got = grads(lambda xs, ps: _ep_sum(xs, ps, 2, 4,
                                       moe.ep_capacity(24, 2, 4, 8.0))[0])
    want = grads(lambda xs, ps: moe.moe_sorted_local(xs, ps, 2)[0])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5 * float(w.abs().max()),
                                   rtol=1e-4)


def test_tp_partials_sum_to_the_whole():
    x, p = _inputs(40, 64, 2, 64, seed=6)
    parts = [moe.tp_shard_partial(x, dict(
        p, w_gate=p["w_gate"][..., m * 16:(m + 1) * 16],
        w_up=p["w_up"][..., m * 16:(m + 1) * 16],
        w_down=p["w_down"][:, m * 16:(m + 1) * 16]), 2) for m in range(4)]
    out = sum(part.out for part in parts[1:]) + parts[0].out
    torch.testing.assert_close(out, moe.moe_sorted_local(x, p, 2)[0],
                               atol=1e-5, rtol=1e-4)
    assert all(bool(part.valid.all()) for part in parts)


def _card_vs_plain(x, p, k, n, cap, tol):
    """Every shard's grouped rows through ``moe_ffn`` on the card against
    ``moe_ffn_plain`` on the same tensors."""
    for m in range(n):
        ps = _shard(p, m, n)
        part = moe.ep_shard_partial(x, ps, k, m, n, cap)
        tok = part.order // k
        xg = x[tok] * part.valid[:, None].to(x.dtype)
        w, _, _, _ = moe.route(x, p["w_router"], k)
        gate = (w.reshape(-1)[part.order] * part.valid).contiguous()
        ws = (ps["w_gate"], ps["w_up"], ps["w_down"])
        got = KM.moe_ffn(xg, part.offs, *ws, gate)
        want = KM.moe_ffn_plain(xg, part.offs, *ws, gate)
        assert float((got - want).abs().max()) <= \
            tol * float(want.abs().max()), m


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-3),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("n_ep", [4, 32])
def test_moe_ffn_at_shard_layouts(dtype, tol, n_ep):
    """olmoe's widths, 64 experts over 4 shards (16 local) or 32 (2
    local, most groups empty), capacity 1.25: the kernel equals plain."""
    dev = cuda_device()
    x, p = _inputs(512, 2048, 64, 1024, seed=7, dtype=dtype, device=dev,
                   favour=[0, 1])
    _card_vs_plain(x, p, 8, n_ep, moe.ep_capacity(512, 8, n_ep, 1.25), tol)


@pytest.mark.requires_cuda
def test_moe_ffn_bwd_under_autograd_at_shard_layouts():
    """The EP partials under autograd on the card (``moe_ffn_train`` and
    ``moe_ffn_bwd``) against the same on the CPU (the plain versions),
    float32, 4 shards with an overflowing one: every gradient within
    1e-5 of its largest."""
    dev = cuda_device()
    x, p = _inputs(256, 512, 64, 256, seed=8, favour=[0, 1])
    dy = torch.randn(256, 512, generator=torch.Generator().manual_seed(9))
    cap = moe.ep_capacity(256, 8, 4, 1.25)

    def grads(device):
        xs = x.to(device).requires_grad_(True)
        ps = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
        (_ep_sum(xs, ps, 8, 4, cap)[0] * dy.to(device)).sum().backward()
        return [xs.grad.cpu()] + [ps[k].grad.cpu() for k in sorted(ps)]

    from repro_torch import kernels
    before = kernels.launch_counts()["moe_ffn_bwd"]
    got = grads(dev)
    assert kernels.launch_counts()["moe_ffn_bwd"] == before + 3 * 4
    for g, w in zip(got, grads("cpu")):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
