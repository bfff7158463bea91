"""The last inference architectures of the port against the JAX package
at smoke width in float32, weights carried over with ``params_from_jax``:
musicgen_medium (GELU FFN, ``input_mode="embeds"``), qwen2_vl_72b
(M-RoPE, QKV bias, embeds) and gemma3_4b at its published head dim of
256 (K8's plain version at D 256 in the prefill).

``gelu_mlp`` and ``mrope_angles`` (with position streams that differ)
against ``repro.models.layers``; ``init_params``' tree (leaf names and
shapes) against JAX's; ``prefill`` + teacher-forced ``decode_step``
against JAX ``prefill``/``decode_step`` on the same numpy embeddings or
tokens, logits and caches within ``atol=1e-5, rtol=1e-4``, positions
exact; ``launch.longctx_decode.generate`` on an embeds arch; and what
``embed_in`` refuses.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, assert_same, cap_threads
from repro.configs import registry as jregistry
from repro.configs import smoke as jsmoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch import longctx_decode
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

cap_threads()

# (arch, changes to the smoke config, prompt length, cache_len, steps)
CASES = {
    "musicgen": ("musicgen_medium", {}, 13, 24, 5),
    "qwen2_vl": ("qwen2_vl_72b", {}, 13, 24, 5),
    "qwen2_vl_gqa4": ("qwen2_vl_72b", {"n_heads": 8, "n_kv_heads": 2,
                                       "n_layers": 3}, 9, 16, 4),
    "musicgen_ring": ("musicgen_medium", {}, 12, 14, 6),
    "gemma3_d256": ("gemma3_4b", {"n_layers": 6, "d_head": 256}, 20, 40, 6),
}


def _models(arch, changes, seed=0):
    cfg = replace(smoke(registry()[arch]), **changes)
    jcfg = replace(jsmoke(jregistry()[arch]), **changes)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, tp, jcfg, jp


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("shape,d_ff", [((2, 7, 16), 48), ((5, 128), 256)])
def test_gelu_mlp_matches_jax(shape, d_ff):
    """tanh-approximate GELU FFN, as ``jax.nn.gelu`` defaults to."""
    rng = np.random.RandomState(0)
    d = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    wu = (rng.standard_normal((d, d_ff)) * d ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((d_ff, d)) * d_ff ** -0.5).astype(np.float32)
    got = L.gelu_mlp(*(torch.from_numpy(a) for a in (x, wu, wd)))
    assert_close(got, JL.gelu_mlp(jnp.asarray(x), jnp.asarray(wu),
                                  jnp.asarray(wd)))
    # the exact (erf) GELU is another function: it must miss the tolerance
    exact = torch.nn.functional.gelu(torch.from_numpy(x @ wu)) @ \
        torch.from_numpy(wd)
    assert not np.allclose(exact.numpy(), got.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("head_dim,sections,theta",
                         [(32, (4, 6, 6), 1e6), (128, (16, 24, 24), 1e6),
                          (16, (2, 2, 4), 1e4)])
def test_mrope_angles_match_jax_with_distinct_streams(head_dim, sections,
                                                      theta):
    """Three position streams that differ (temporal, height, width of a
    vision patch grid), batched [B, S, 3]: each frequency slot takes its
    section's stream."""
    rng = np.random.RandomState(1)
    pos = rng.randint(0, 5000, size=(2, 9, len(sections))).astype(np.int32)
    c, s = L.mrope_angles(torch.from_numpy(pos), head_dim, theta, sections)
    jc, js = JL.mrope_angles(jnp.asarray(pos), head_dim, theta, sections)
    assert c.shape == (2, 9, head_dim // 2)
    assert_close(c, jc)
    assert_close(s, js)
    # equal streams are plain RoPE
    flat = np.repeat(pos[..., :1], len(sections), axis=-1)
    c1, s1 = L.mrope_angles(torch.from_numpy(flat), head_dim, theta,
                            sections)
    c0, s0 = L.rope_angles(torch.from_numpy(pos[..., 0]), head_dim, theta)
    assert torch.equal(c1, c0) and torch.equal(s1, s0)
    with pytest.raises(ValueError, match="sum"):
        L.mrope_angles(torch.from_numpy(pos), head_dim + 2, theta, sections)


@pytest.mark.parametrize("arch,changes", [("musicgen_medium", {}),
                                          ("qwen2_vl_72b", {}),
                                          ("gemma3_4b", {"d_head": 256})])
def test_init_params_tree_matches_jax(arch, changes):
    """The port's own draw has JAX's leaves and shapes, layer by layer:
    the two-matrix GELU MLP, QKV biases, embed and lm_head in embeds mode
    too; and ``params_from_jax`` gives the same tree."""
    cfg = replace(smoke(registry()[arch]), **changes)
    jcfg = replace(jsmoke(jregistry()[arch]), **changes)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = T.init_params(cfg, seed=0, device="cpu")
    want = {}
    for k, v in jp.items():
        if k != "layers":
            want.update(_leaves(v, f"/{k}"))
    jl = _leaves(jp["layers"])
    for i, lp in enumerate(tp["layers"]):
        got = _leaves(lp)
        assert got == {k: s[1:] for k, s in jl.items()}, i
    assert {k: v for k, v in _leaves(tp).items()
            if not k.startswith("/layers")} == want
    conv = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert _leaves(conv) == _leaves(tp)
    if cfg.mlp_kind == "gelu":
        assert set(tp["layers"][0]["mlp"]) == {"w_up", "w_down"}


def _inputs(cfg, B, n, seed=1):
    rng = np.random.RandomState(seed)
    if cfg.input_mode == "embeds":
        return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return rng.randint(0, cfg.vocab, size=(B, n)).astype(np.int32)


def _port_kw(cfg, x):
    if cfg.input_mode == "embeds":
        return (None,), {"embeds": torch.from_numpy(x)}
    return (torch.from_numpy(x),), {}


def _jax_batch(cfg, x):
    return {("embeds" if cfg.input_mode == "embeds" else "tokens"):
            jnp.asarray(x)}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    """Prefill over the prompt, then teacher-forced decode steps (the next
    embedding or token of the same numpy sequence): logits, K/V caches and
    positions against JAX at every step.  ``musicgen_ring`` decodes past
    its cache of 14 slots, so the full-attention caches wrap as rings, as
    JAX's do."""
    arch, changes, S, cache_len, steps = CASES[case]
    cfg, tp, jcfg, jp = _models(arch, changes)
    x = _inputs(cfg, 2, S + steps)
    a, kw = _port_kw(cfg, x[:, :S])
    lg, st = T.prefill(tp, cfg, *a, cache_len, **kw)
    jlg, jst = JT.prefill(jp, jcfg, _jax_batch(cfg, x[:, :S]), cache_len)
    assert lg.shape == jlg.shape
    assert_close(lg, jlg)

    def caches():
        assert_same(st["positions"], np.asarray(jst["positions"]))
        for c, jc in zip(st["attn"], jst["attn"], strict=True):
            assert_same(c["pos"], np.asarray(jc["pos"]))
            assert_close(c["k"], jc["k"])
            assert_close(c["v"], jc["v"])
    caches()
    for t in range(steps):
        a, kw = _port_kw(cfg, x[:, S + t:S + t + 1])
        lg, st = T.decode_step(tp, cfg, st, *a, **kw)
        jlg, jst = JT.decode_step(jp, jcfg, jst,
                                  _jax_batch(cfg, x[:, S + t:S + t + 1]))
        assert_close(lg, jlg)
        caches()


def test_gemma3_d256_prefill_runs_k8_at_head_dim_256(monkeypatch):
    """gemma3's dense-cache prefill at D 256 reaches K8 once per layer
    (its plain version on CPU tensors), window 16 on the local layers and
    none on the global one."""
    from repro_torch.kernels import flash_attention as K8
    cfg, tp, _, _ = _models("gemma3_4b", {"n_layers": 6, "d_head": 256})
    seen = []
    orig = K8.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], kw.get("window")))
        return orig(q, k, v, **kw)
    monkeypatch.setattr(K8, "flash_attention", spy)
    T.prefill(tp, cfg, torch.from_numpy(_inputs(cfg, 1, 20)), 24)
    assert seen == [(256, 16)] * 5 + [(256, 0)]


def test_embeds_generate_matches_teacher_forced_decode():
    """``generate`` on an embeds arch: the prompt embeddings prefill, step
    i decodes ``step_embeds[:, i]``, and the recorded codes are the
    argmax of each step's logits (the JAX decode's, too)."""
    cfg, tp, jcfg, jp = _models("qwen2_vl_72b", {})
    S, n = 11, 4
    x = _inputs(cfg, 2, S + n, seed=5)
    res = longctx_decode.generate(tp, cfg, x[:, :S], n, S + n,
                                  step_embeds=x[:, S:])
    jlg, jst = JT.prefill(jp, jcfg, {"embeds": jnp.asarray(x[:, :S])},
                          S + n)
    want = []
    for t in range(n):
        want.append(np.asarray(jnp.argmax(jlg[:, 0, :cfg.vocab], -1)))
        jlg, jst = JT.decode_step(
            jp, jcfg, jst, {"embeds": jnp.asarray(x[:, S + t:S + t + 1])})
    assert res["tokens"] == np.stack(want, 1).tolist()
    assert_close(res["logits"], jlg)
    assert res["kv_cache_bytes"] > 0 and res["ssm_state_bytes"] == 0
    with pytest.raises(ValueError, match="step_embeds"):
        longctx_decode.generate(tp, cfg, x[:, :S], n, S + n)


def test_embed_in_takes_what_the_input_mode_says():
    """An embeds arch takes [B, S, d] embeddings and no tokens; a tokens
    arch the reverse; wrong widths are refused."""
    cfg = smoke(registry()["musicgen_medium"])
    tp = T.init_params(cfg, seed=0, device="cpu")
    e = torch.randn(1, 3, cfg.d_model)
    assert torch.equal(T.embed_in(tp, cfg, None, embeds=e), e)
    with pytest.raises(ValueError, match="embeds"):
        T.embed_in(tp, cfg, torch.zeros(1, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="want"):
        T.embed_in(tp, cfg, None, embeds=torch.randn(1, 3, 7))
    tcfg = smoke(registry()["qwen3_4b"])
    tq = T.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        T.embed_in(tq, tcfg, None, embeds=e)
