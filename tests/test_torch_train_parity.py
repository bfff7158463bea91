"""The port's training math against the JAX package at smoke width in
float32, for every non-MoE arch: ``forward_hidden``, the loss and every
gradient leaf against ``jax.value_and_grad(loss_fn)``, one
``make_train_step`` step (params, m, v) against JAX's, a 5-step loss
trajectory (qwen3, mamba2), and the pieces (cross-entropy with a mask,
``cosine_with_warmup``, ``SyntheticLM``'s bytes); within the port, remat
on and off give equal gradient bits.

Weights travel with ``params_from_jax``, the JAX gradient tree the same
way.  Tolerances (XLA and torch sum in other orders): hidden states,
loss, cross-entropy and the schedule within ``ATOL``/``RTOL`` (1e-5 /
1e-4); a gradient leaf within 1e-4 of its largest magnitude (a leaf's
entries are sums over every token, so the absolute error scales with the
leaf); m and v after a step as their gradients (m = 0.1 g, v = 0.05
g**2, the latter within 1e-4 of its largest); the params after a step at
lr 1e-3 within 2e-5 where JAX's clipped gradient is at least 1e-6 in
magnitude, and within 2 lr elsewhere: AdamW's first update is
lr * g / (|g| + 1e-8), whose slope 1e-8 / (|g| + 1e-8)**2 turns a
rounding difference in a gradient near 1e-8 into a difference of order
lr, while at |g| >= 1e-6 the gradient tolerance moves it by under 1e-6.
``adamw.update`` alone, given JAX's gradients, matches JAX's update
within 1e-6 everywhere.  Each JAX computation is built once per arch.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, assert_same, cap_threads, np_of
from repro.configs import registry as jregistry
from repro.configs import smoke as jsmoke
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import train as JTrain
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim import cosine_with_warmup as jcosine
from repro_torch import tree
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.data import ShardInfo, SyntheticLM
from repro_torch.launch.train import make_train_step, micro_batches
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, cosine_with_warmup

cap_threads()

ARCHS = ["qwen2_vl_72b", "qwen2_5_14b", "phi3_mini_3_8b", "qwen3_4b",
         "gemma3_4b", "zamba2_7b", "mamba2_1_3b", "musicgen_medium"]
B, S, N_MICRO, LR = 4, 16, 2, 1e-3
GRAD_REL = 1e-4
PARAM_ATOL = 2e-5


def _port(jtree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), cfg,
                           device="cpu")


def _batch(cfg, step=0, seed=5):
    src = SyntheticLM(cfg.vocab, S, B, seed=seed, input_mode=cfg.input_mode,
                      d_model=cfg.d_model)
    return src.batch(step)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _weights(cfg, seed=0):
    """Seeded weights in the JAX layout (numpy leaves, the per-layer
    trees stacked on a leading layer axis): the port's ``init_params`` on
    the CPU, whose scales are the JAX ``init_params``'s."""
    p = T.init_params(cfg, seed=seed, device="cpu")
    out = {k: tree.map_leaves(lambda t: t.numpy(), v)
           for k, v in p.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *[
        tree.map_leaves(lambda t: t.numpy(), lp) for lp in p["layers"]])
    return out


def _lr(step, cosine):
    """The schedule both packages run here: warmup 0, so step 0 is at the
    peak 1e-3, decaying over 5 steps."""
    return cosine(step, peak_lr=LR, warmup=0, total=5)


class Case:
    """One arch's JAX computations, each compiled once: the hidden
    states, loss and gradients of one batch, and the jitted train step."""

    def __init__(self, name):
        self.cfg = smoke(registry()[name])
        self.jcfg = jsmoke(jregistry()[name])
        self.np_params = _weights(self.cfg)
        self.jp = jax.tree.map(jnp.asarray, self.np_params)
        self.batch = _batch(self.cfg)
        jb = {k: jnp.asarray(v) for k, v in self.batch.items()}
        fwd_in = {k: v for k, v in jb.items() if k != "labels"}

        def fwd_loss_grad(p):
            h = JT.forward_hidden(p, self.jcfg, fwd_in)[0]
            (loss, _), g = jax.value_and_grad(
                lambda q: JT.loss_fn(q, self.jcfg, jb), has_aux=True)(p)
            return h, loss, g

        h, loss, g = jax.jit(fwd_loss_grad)(self.jp)
        self.jh, self.jloss = np.asarray(h), np.asarray(loss)
        self.jgrads = jax.tree.map(np.asarray, g)
        self.jstep_fn = jax.jit(JTrain.make_train_step(
            self.jcfg, None, lr_fn=lambda s: _lr(s, jcosine)))
        jnew, jopt, jm = self.jstep_fn(self.jp, jadamw.init(self.jp),
                                       micro_batches(self.batch, N_MICRO))
        self.jstep = (jax.tree.map(np.asarray, jnew),
                      jax.tree.map(np.asarray, jopt.m),
                      jax.tree.map(np.asarray, jopt.v), float(jm["loss"]),
                      float(jm["grad_norm"]))

    def params(self):
        return params_from_jax(self.np_params, self.cfg, device="cpu")

    def step_fn(self):
        return make_train_step(self.cfg,
                               lr_fn=lambda s: _lr(s, cosine_with_warmup))


_CASES = {}


def _case(name):
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _case(request.param)


def _grads(cfg, params, batch):
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = T.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss, metrics, tree.unflatten(params, grads)


def _assert_leaves(got_tree, want_np_tree, cfg, check):
    """``check`` every leaf of a port tree against the same leaf of a JAX
    tree (numpy leaves, carried over by ``params_from_jax``)."""
    names, got = tree.flatten_with_names(got_tree)
    want = dict(zip(*tree.flatten_with_names(_port(want_np_tree, cfg))))
    assert sorted(names) == sorted(want)
    for name, g in zip(names, got):
        try:
            check(np_of(g), np_of(want[name]))
        except AssertionError as e:
            raise AssertionError(f"{cfg.name} {name}: {e}") from None


def _rel_close(rel):
    def check(g, w):
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0)
    return check


def test_forward_hidden_matches_jax(case):
    h, metrics = T.forward_hidden(
        case.params(), case.cfg,
        {k: v for k, v in _tensors(case.batch).items() if k != "labels"})
    assert h.shape == (B, S, case.cfg.d_model)
    assert float(metrics["moe_aux"]) == 0.0
    assert_close(h, case.jh)


def test_loss_and_gradients_match_jax(case):
    loss, metrics, grads = _grads(case.cfg, case.params(),
                                  _tensors(case.batch))
    assert_close(loss, np.asarray(case.jloss))
    assert_close(metrics["ce_loss"], np.asarray(case.jloss))
    _assert_leaves(grads, case.jgrads, case.cfg, _rel_close(GRAD_REL))


def test_train_step_matches_jax(case):
    params = case.params()
    opt = adamw.init(params)
    params, opt, m = case.step_fn()(params, opt,
                                    micro_batches(case.batch, N_MICRO))
    jparams, jm, jv, jloss, jgnorm = case.jstep
    assert int(opt.step) == 1
    assert_close(m["lr"], np.float32(LR))
    assert_close(m["loss"], np.float32(jloss))
    assert_close(m["grad_norm"], np.float32(jgnorm))
    _assert_leaves(opt.m, jm, case.cfg, _rel_close(GRAD_REL))
    _assert_leaves(opt.v, jv, case.cfg, _rel_close(GRAD_REL))

    g_jax = dict(zip(*tree.flatten_with_names(_port(jm, case.cfg))))
    want = dict(zip(*tree.flatten_with_names(_port(jparams, case.cfg))))
    for name, p in zip(*tree.flatten_with_names(params)):
        g = np.abs(np_of(g_jax[name])) / 0.1      # m = 0.1 g at step one
        d = np.abs(np_of(p) - np_of(want[name]))
        assert d[g >= 1e-6].max(initial=0) <= PARAM_ATOL, (case.cfg.name,
                                                           name)
        assert d.max() <= 2 * LR, (case.cfg.name, name)


@pytest.mark.parametrize("name", ["qwen3_4b", "mamba2_1_3b"])
def test_adamw_update_matches_jax(name):
    """Two updates from JAX's gradients, the clip active (clip_norm 1e-3),
    against ``repro.optim.adamw.update``: params, m and v within 1e-6."""
    case = _case(name)
    jupdate = jax.jit(lambda g, o, p, lr: jadamw.update(g, o, p, lr=lr,
                                                        clip_norm=1e-3))
    jp, jopt = case.jp, jadamw.init(case.jp)
    params = case.params()
    opt = adamw.init(params)
    for lr in (LR, 5e-4):
        jp, jopt, jm = jupdate(case.jgrads, jopt, jp, jnp.float32(lr))
        grads = _port(case.jgrads, case.cfg)
        params, opt, m = adamw.update(grads, opt, params, lr=lr,
                                      clip_norm=1e-3)
        assert_close(m["grad_norm"], np.asarray(jm["grad_norm"]))
    assert int(opt.step) == int(jopt.step) == 2

    def check(g, w):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    for got, want in ((params, jp), (opt.m, jopt.m), (opt.v, jopt.v)):
        _assert_leaves(got, jax.tree.map(np.asarray, want), case.cfg, check)


@pytest.mark.parametrize("name", ["qwen3_4b", "mamba2_1_3b"])
def test_five_step_loss_trajectory_matches_jax(name):
    """Five steps on the batches of steps 0-4, the schedule decaying from
    1e-3: every loss within ATOL/RTOL of JAX's, and the last below the
    first."""
    c = _case(name)
    jp, params = c.jp, c.params()
    jopt, opt = jadamw.init(jp), adamw.init(params)
    step = c.step_fn()
    got, want = [], []
    for s in range(5):
        mb = micro_batches(_batch(c.cfg, s), N_MICRO)
        jp, jopt, jm = c.jstep_fn(jp, jopt, mb)
        params, opt, m = step(params, opt, mb)
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("name", ["qwen3_4b", "zamba2_7b"])
def test_remat_gives_equal_gradient_bits(name):
    cfg = smoke(registry()[name])
    params = T.init_params(cfg, seed=3, device="cpu")
    batch = _tensors(_batch(cfg))
    _, _, on = _grads(replace(cfg, remat=True), params, batch)
    _, _, off = _grads(replace(cfg, remat=False), params, batch)
    for a, b in zip(tree.leaves(on), tree.leaves(off)):
        assert_same(a, b)


def test_padded_vocab_columns_get_zero_gradient():
    """``logits_out`` masks the padded columns in place; autograd gives
    them a zero gradient, as JAX's ``where`` does."""
    cfg = replace(smoke(registry()["qwen3_4b"]), vocab=200)
    params = T.init_params(cfg, seed=0, device="cpu")
    assert params["lm_head"].shape[1] == 256
    src = SyntheticLM(cfg.vocab, S, B, seed=2)
    _, _, grads = _grads(cfg, params, _tensors(src.batch(0)))
    assert torch.count_nonzero(grads["lm_head"][:, 200:]) == 0
    assert torch.count_nonzero(grads["lm_head"][:, :200]) > 0


@pytest.mark.parametrize("with_valid", [False, True])
def test_softmax_cross_entropy_matches_jax(with_valid):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 5, 40) * 4).astype(np.float32)
    labels = rng.randint(0, 40, size=(3, 5)).astype(np.int32)
    valid = rng.rand(3, 5) < 0.6 if with_valid else None
    want = JL.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        valid=None if valid is None else jnp.asarray(valid))
    got = layers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        valid=None if valid is None else torch.from_numpy(valid))
    assert_close(got, np.asarray(want))


def test_cosine_with_warmup_matches_jax():
    for s in range(0, 130, 3):
        want = jcosine(jnp.int32(s), peak_lr=3e-4, warmup=10, total=120)
        got = cosine_with_warmup(torch.tensor(s, dtype=torch.int32),
                                 peak_lr=3e-4, warmup=10, total=120)
        assert got.dtype == torch.float32
        assert_close(got, np.asarray(want), atol=1e-12, rtol=1e-6)


@pytest.mark.parametrize("mode,shard", [("tokens", ShardInfo()),
                                        ("tokens", ShardInfo(1, 2)),
                                        ("embeds", ShardInfo())])
def test_synthetic_lm_batches_equal_jax_bytes(mode, shard):
    from repro.data import ShardInfo as JShardInfo
    kw = dict(seed=7, input_mode=mode, d_model=24)
    src = SyntheticLM(300, 12, 8, shard=shard, **kw)
    jsrc = JSyntheticLM(300, 12, 8, shard=JShardInfo(shard.shard,
                                                     shard.n_shards), **kw)
    for step in (0, 3, 11):
        got, want = src.batch(step), jsrc.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
