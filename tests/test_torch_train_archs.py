"""Per-arch training twins of ``tests/test_archs_smoke.py`` for the port's
8 non-MoE archs at smoke width on the CPU: one forward and gradient
(shapes, finite values, a non-zero gradient), and the dense-cache
``prefill`` + ``decode_step`` against the teacher-forced
``forward_hidden`` logits (within 2e-4, the JAX test's tolerance); the
MoE archs refuse training.

The ``requires_cuda`` cases run on a card (this file imports no JAX):
two backward passes of ``loss_fn`` on one batch give equal bits, and one
``make_train_step`` step on the card agrees with the CPU's (loss and
grad norm within 1e-4 relative; m and v within 1e-4 of each leaf's
largest magnitude; params within 2e-5 where |g| >= 1e-6, see
``test_torch_train_parity.py``).
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, cap_threads, cuda_device, np_of
from repro_torch import kernels, tree
from repro_torch.configs.base import ARCH_IDS, registry, smoke
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import make_train_step, micro_batches
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

cap_threads()

REG = registry()
DENSE = [a for a in ARCH_IDS if not REG[a].is_moe]
MOE = [a for a in ARCH_IDS if REG[a].is_moe]


def _inputs(cfg, B, S, seed=1):
    """(full inputs of S tokens, their labels) made with numpy: token ids,
    or embeddings for an embeds arch."""
    rng = np.random.RandomState(seed)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab, (B, S))
                              .astype(np.int32))
    if cfg.input_mode == "embeds":
        return {"embeds": torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
        }, labels
    return {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab, (B, S)).astype(np.int32))}, labels


def _grads(cfg, params, batch):
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = T.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss, metrics, grads


@pytest.mark.parametrize("arch_id", DENSE)
def test_forward_and_train_step(arch_id):
    sc = smoke(REG[arch_id])
    params = T.init_params(sc, seed=0, device="cpu")
    B, S = 2, 16
    batch, _ = _inputs(sc, B, S)
    before = dict(kernels.launch_counts())
    loss, metrics, grads = _grads(
        sc, params, dict(batch, labels=torch.zeros((B, S), dtype=torch.int32)))
    assert loss.shape == () and bool(torch.isfinite(loss)), arch_id
    assert torch.equal(metrics["ce_loss"], loss)

    h, _ = T.forward_hidden(params, sc, batch)
    assert h.shape == (B, S, sc.d_model)
    logits = T.logits_out(params, sc, h)
    assert logits.shape[-1] >= sc.vocab
    assert bool(torch.all(torch.isfinite(logits)))

    names = tree.flatten_with_names(params)[0]
    for name, g in zip(names, grads):
        assert bool(torch.all(torch.isfinite(g))), (arch_id, name)
    gn = sum(float(torch.sum(g.double() ** 2)) for g in grads) ** 0.5
    assert gn > 0, f"{arch_id}: zero gradient"
    assert kernels.launch_counts() == before      # no kernel in training


@pytest.mark.parametrize("arch_id", DENSE)
def test_prefill_decode_matches_forward(arch_id):
    """Prefill + step-by-step decode reproduce the teacher-forced logits
    of the training forward."""
    sc = smoke(REG[arch_id])
    params = T.init_params(sc, seed=0, device="cpu")
    B, S, extra = 2, 16, 3
    full, _ = _inputs(sc, B, S + extra)
    key = "embeds" if sc.input_mode == "embeds" else "tokens"
    h, _ = T.forward_hidden(params, sc, full)
    flogits = T.logits_out(params, sc, h)

    def part(lo, hi):
        x = full[key][:, lo:hi]
        return (None, {"embeds": x}) if key == "embeds" else (x, {})

    toks, kw = part(0, S)
    with torch.no_grad():
        lg, state = T.prefill(params, sc, toks, S + extra + 1, **kw)
        assert_close(lg[:, 0], flogits[:, S - 1], atol=2e-4, rtol=2e-4)
        for t in range(extra):
            toks, kw = part(S + t, S + t + 1)
            lg, state = T.decode_step(params, sc, state, toks, **kw)
            assert_close(lg[:, 0], flogits[:, S + t], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch_id", MOE)
def test_moe_training_refused(arch_id):
    sc = smoke(REG[arch_id])
    params = T.init_params(sc, seed=0, device="cpu")
    batch, labels = _inputs(sc, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        T.loss_fn(params, sc, dict(batch, labels=labels))
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        make_train_step(sc)


def test_remat_is_one_checkpoint_per_layer(monkeypatch):
    """remat wraps each layer: one ``torch.utils.checkpoint`` per layer
    with ``cfg.remat``, none without."""
    sc = smoke(REG["zamba2_7b"])
    params = T.init_params(sc, seed=0, device="cpu")
    batch, labels = _inputs(sc, 2, 16)
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn.__name__)
        return orig(fn, *a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    _grads(sc, params, dict(batch, labels=labels))
    _grads(replace(sc, remat=False), params, dict(batch, labels=labels))
    assert calls == ["_train_mamba_layer"] * sc.n_layers


# --- on a card ---------------------------------------------------------------

CARD_ARCHS = ["qwen3_4b", "gemma3_4b", "mamba2_1_3b", "zamba2_7b"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch_id", CARD_ARCHS)
def test_backward_bits_repeat_on_card(arch_id):
    dev = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = smoke(REG[arch_id])
    params = T.init_params(sc, seed=0, device=dev)
    src = SyntheticLM(sc.vocab, 64, 4, seed=2, input_mode=sc.input_mode,
                      d_model=sc.d_model)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in src.batch(0).items()}
    before = dict(kernels.launch_counts())
    first = _grads(sc, params, batch)
    second = _grads(sc, params, batch)
    assert kernels.launch_counts() == before
    assert torch.equal(first[0], second[0])
    for a, b in zip(first[2], second[2]):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch_id", CARD_ARCHS)
def test_train_step_card_matches_cpu(arch_id):
    dev = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = smoke(REG[arch_id])
    src = SyntheticLM(sc.vocab, 32, 4, seed=4, input_mode=sc.input_mode,
                      d_model=sc.d_model)
    mb = micro_batches(src.batch(0), 2)
    out = {}
    for d in ("cpu", dev):
        params = T.init_params(sc, seed=0, device="cpu")
        params = tree.map_leaves(lambda t: t.to(d), params)
        opt = adamw.init(params)
        out[str(d)] = make_train_step(sc, lr_fn=lambda s: 1e-3)(
            params, opt, mb)
    (cp, co, cm), (gp, go, gm) = out["cpu"], out[str(dev)]
    assert_close(gm["loss"], cm["loss"], atol=0, rtol=1e-4)
    assert_close(gm["grad_norm"], cm["grad_norm"], atol=0, rtol=1e-4)
    for a, b in zip(tree.leaves((go.m, go.v)), tree.leaves((co.m, co.v))):
        scale = float(b.abs().max()) or 1.0
        assert_close(a, b, atol=1e-4 * scale, rtol=0)
    for p_gpu, p_cpu, m_cpu in zip(tree.leaves(gp), tree.leaves(cp),
                                   tree.leaves(co.m)):
        d = np.abs(np_of(p_gpu) - np_of(p_cpu))
        g = np.abs(np_of(m_cpu)) / 0.1
        assert d[g >= 1e-6].max(initial=0) <= 2e-5
        assert d.max() <= 2e-3
