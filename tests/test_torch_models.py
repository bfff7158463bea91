"""The port's model functions against the JAX package's, in float32 at
smoke size, on the same numpy inputs and (via ``params_from_jax``) the
same weights: floats within ``atol=1e-5, rtol=1e-4`` (XLA and torch sum
in different orders), shapes, names and masks exactly."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, assert_same, cap_threads
from repro.configs import registry as jregistry
from repro.configs import smoke as jsmoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.parallel.sharding import pad_vocab as jpad_vocab
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import attention, layers
from repro_torch.models import transformer as T

cap_threads()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfgs(name, **kw):
    return (replace(smoke(registry()[name]), **kw),
            replace(jsmoke(jregistry()[name]), **kw))


@pytest.mark.parametrize("gemma", [False, True])
def test_rms_norm(gemma):
    rng = np.random.RandomState(0)
    x, s = _rand(rng, 3, 5, 64), _rand(rng, 64)
    assert_close(layers.rms_norm(_t(x), _t(s), eps=1e-5, gemma_style=gemma),
                 jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), eps=1e-5,
                                  gemma_style=gemma))


@pytest.mark.parametrize("theta,head_shaped", [(1e6, False), (1e4, True)])
def test_rope(theta, head_shaped):
    """Angles in float32 at large positions, and both cos/sin layouts."""
    rng = np.random.RandomState(1)
    pos = rng.randint(0, 40000, size=(2, 7)).astype(np.int32)
    x = _rand(rng, 2, 7, 4, 32)
    c, s = layers.rope_angles(_t(pos), 32, theta)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 32, theta)
    assert c.dtype == torch.float32
    assert_close(c, jc)
    assert_close(s, js)
    if head_shaped:
        c, s = c[:, :, None, :].expand(2, 7, 4, 16), \
            s[:, :, None, :].expand(2, 7, 4, 16)
        jc, js = jc[:, :, None, :].repeat(4, 2), js[:, :, None, :].repeat(4, 2)
    assert_close(layers.apply_rope(_t(x), c, s),
                 jlayers.apply_rope(jnp.asarray(x), jc, js))


def test_swiglu_and_embeddings():
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 3, 16)
    wg, wu, wd = _rand(rng, 16, 40), _rand(rng, 16, 40), _rand(rng, 40, 16)
    assert_close(layers.swiglu_mlp(_t(x), _t(wg), _t(wu), _t(wd)),
                 jlayers.swiglu_mlp(*map(jnp.asarray, (x, wg, wu, wd))))
    table = _rand(rng, 50, 16)
    tok = rng.randint(0, 50, size=(2, 3)).astype(np.int32)
    assert_same(layers.embed(_t(tok).long(), _t(table)),
                jlayers.embed(jnp.asarray(tok), jnp.asarray(table)))
    for tied, w in ((True, table), (False, table.T.copy())):
        assert_close(layers.unembed(_t(x), _t(w), tied=tied),
                     jlayers.unembed(jnp.asarray(x), jnp.asarray(w),
                                     tied=tied))


@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen2_5_14b", "phi3_mini_3_8b"])
def test_project_qkv(arch):
    """qk_norm (qwen3), QKV bias (qwen2.5) and neither (phi3), with
    non-trivial norm scales and biases so each term shows."""
    cfg, _ = _cfgs(arch)
    rng = np.random.RandomState(3)
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _rand(rng, d, hq, dh), "wk": _rand(rng, d, hkv, dh),
         "wv": _rand(rng, d, hkv, dh), "wo": _rand(rng, hq, dh, d)}
    if cfg.qkv_bias:
        p.update(bq=_rand(rng, hq, dh), bk=_rand(rng, hkv, dh),
                 bv=_rand(rng, hkv, dh))
    if cfg.qk_norm:
        p.update(q_norm=1 + _rand(rng, dh) / 4, k_norm=1 + _rand(rng, dh) / 4)
    x = _rand(rng, 2, 3, d)
    pos = np.array([[0, 5, 9], [1, 2, 3]], np.int32)
    c, s = layers.rope_angles(_t(pos), dh, cfg.rope_theta)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), dh, cfg.rope_theta)
    got = attention.project_qkv({k: _t(v) for k, v in p.items()}, _t(x), c, s)
    want = jattn.project_qkv(
        JT._attn_from_dict({k: jnp.asarray(v) for k, v in p.items()}),
        jnp.asarray(x), jc, js)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_close(g, w)


@pytest.mark.parametrize("vocab", [250, 256, 1000])
def test_pad_vocab(vocab):
    assert T.pad_vocab(vocab) == jpad_vocab(vocab)
    assert T.pad_vocab(151936) == 152064


@pytest.mark.parametrize("arch", ["qwen3_4b", "gemma3_4b"])
def test_init_params_layout_and_scales(arch):
    """The port draws its own weights: same leaf names, shapes and dtypes
    as the JAX tree (layers split into a list), norms at their init
    value, and the JAX init standard deviations."""
    cfg, jcfg = _cfgs(arch, vocab=1000, d_model=256, d_ff=512)
    tp = T.init_params(cfg, seed=0, device="cpu")
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    assert len(tp["layers"]) == cfg.n_layers
    assert set(tp) == set(jp)
    for k in tp:
        if k == "layers":
            continue
        assert tuple(tp[k].shape) == jp[k].shape, k
    flat_t = jax.tree_util.tree_flatten_with_path(tp["layers"][0])[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp["layers"])[0])
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        assert (cfg.n_layers, *leaf.shape) == flat_j[path].shape, path
        assert leaf.dtype == torch.float32
    d = cfg.d_model
    a, m = tp["layers"][1]["attn"], tp["layers"][1]["mlp"]
    for w, std in ((a["wq"], d ** -0.5), (a["wo"], d ** -0.5),
                   (m["w_up"], d ** -0.5), (m["w_down"], cfg.d_ff ** -0.5),
                   (tp["embed"], d ** -0.5)):
        assert abs(float(w.std()) / std - 1) < 0.05
        assert abs(float(w.mean())) < 0.05 * std
    norm = 0.0 if cfg.gemma_norm else 1.0
    assert (tp["final_norm"] == norm).all()
    if cfg.qk_norm:
        assert (a["q_norm"] == 1).all() and (a["k_norm"] == 1).all()
    again = T.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"][1]["mlp"]["w_up"], m["w_up"])
    other = T.init_params(cfg, seed=1, device="cpu")
    assert not torch.equal(other["embed"], tp["embed"])


def test_params_from_jax_bit_exact_in_bfloat16():
    cfg, jcfg = _cfgs("qwen3_4b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    np_params = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_params, cfg, device="cpu")
    got = tp["layers"][1]["attn"]["wk"]
    assert got.dtype == torch.bfloat16
    want = np_params["layers"]["attn"]["wk"][1]
    assert_same(got.view(torch.int16).numpy(), want.view(np.int16))
    f32 = params_from_jax(np_params, cfg, device="cpu", dtype=torch.float32)
    assert_same(f32["embed"], np_params["embed"].astype(np.float32))


@pytest.mark.parametrize("arch,vocab", [("qwen3_4b", 250), ("qwen3_4b", 256),
                                        ("gemma3_4b", 250)])
def test_embed_logits_and_ffn_block(arch, vocab):
    """embed_in, the FFN block and logits_out on carried weights; padded
    vocabulary columns come out as exactly -1e9 (tied gemma has none)."""
    cfg, jcfg = _cfgs(arch, vocab=vocab)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tok = np.random.RandomState(6).randint(0, vocab, size=(2, 3)
                                           ).astype(np.int32)
    h = T.embed_in(tp, cfg, _t(tok).long())
    jh = JT.embed_in(jp, jcfg, {"tokens": jnp.asarray(tok)}, None)
    assert_close(h, jh)
    lp = tp["layers"][1]
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    h2 = T.ffn_block(lp, cfg, h)
    jh2, _, _ = JT._ffn_block(jlp, jcfg, jh, None)
    assert_close(h2, jh2)
    logits = T.logits_out(tp, cfg, h2)
    jlogits = JT.logits_out(jp, jcfg, jh2)
    assert logits.shape == jlogits.shape
    assert_close(logits, jlogits)
    width = logits.shape[-1]
    if not cfg.tie_embeddings:
        assert width == T.pad_vocab(vocab)
    assert (logits[..., vocab:] == -1e9).all()
    assert (logits[..., :vocab] > -1e8).all()
