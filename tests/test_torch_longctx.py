"""The port's dense-cache generation path (``prefill`` + ``decode_step``
of the ``mamba`` and ``hybrid`` layouts, ``launch.longctx_decode``)
against the JAX package at smoke size in float32.

Weights travel with ``params_from_jax``; prompts are made with numpy.
Logits and float state within ``ATOL``/``RTOL`` of
``helpers.torch_parity`` (XLA and torch sum in other orders), positions
and greedy tokens exactly.  The smoke prompts are 13 tokens, ragged
against the smoke chunk of 8, so K9's last chunk is partial.
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
from repro.models import transformer as JT
from repro_torch import kernels
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch import longctx_decode
from repro_torch.models import transformer as T

cap_threads()

ARCHS = ["mamba2_1_3b", "zamba2_7b"]


def _cfgs(name, **kw):
    return (replace(smoke(registry()[name]), **kw),
            replace(jsmoke(jregistry()[name]), **kw))


def _weights(name, seed=0, **kw):
    cfg, jcfg = _cfgs(name, **kw)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, jp, tp


def _prompts(B, S, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S)
                                               ).astype(np.int32)


def _leaves(tree, prefix=""):
    """{path: shape} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_tree_matches_jax(name):
    """The port's own init has the JAX tree's leaf names and shapes (its
    per-layer list against JAX's stacked leaves), the shared block of a
    hybrid un-stacked."""
    cfg, jcfg = _cfgs(name)
    tp = T.init_params(cfg, seed=0, device="cpu")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jl = jax.tree.map(np.asarray, jp)
    per_layer = {k: v for k, v in _leaves(
        jax.tree.map(lambda a: a[0], jl["layers"])).items()}
    assert len(tp["layers"]) == jcfg.n_layers
    for lp in tp["layers"]:
        assert _leaves(lp) == per_layer
    rest = {k: v for k, v in jl.items() if k != "layers"}
    assert _leaves({k: v for k, v in tp.items() if k != "layers"}) == \
        _leaves(rest)
    assert ("shared" in tp) == (cfg.layout == "hybrid")
    for lp in tp["layers"]:
        for k in ("dt_bias", "A_log", "D", "norm", "conv_b"):
            assert_same(lp["mamba"][k], np.asarray(jp["layers"]["mamba"][k][0]))


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_jax_carries_the_hybrid_tree(name):
    """Stacked ``layers[*]["mamba"]`` split per layer, ``shared`` carried
    as it is, every leaf bit-exact (float32 and bfloat16)."""
    cfg, jcfg = _cfgs(name)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    npp = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(npp, cfg, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    for l in range(cfg.n_layers):
        for k, v in npp["layers"]["mamba"].items():
            assert_same(tp["layers"][l]["mamba"][k].float(),
                        np.asarray(v[l], np.float32))
        assert_same(tp["layers"][l]["ln"].float(),
                    np.asarray(npp["layers"]["ln"][l], np.float32))
    if cfg.layout == "hybrid":
        for path, shape in _leaves(npp["shared"]).items():
            keys = path.strip("/").split("/")
            got, want = tp["shared"], npp["shared"]
            for k in keys:
                got, want = got[k], want[k]
            assert tuple(got.shape) == shape
            assert_same(got.float(), np.asarray(want, np.float32))


def _compare_state(ts, js):
    assert_same(ts["positions"], js["positions"])
    assert len(ts["mamba"]) == len(js["mamba"])
    for a, b in zip(ts["mamba"], js["mamba"]):
        assert_close(a["h"], b["h"])
        assert_close(a["conv"], b["conv"])
    assert len(ts["attn"]) == len(js["attn"])
    for a, b in zip(ts["attn"], js["attn"]):
        assert_close(a["k"], b["k"])
        assert_close(a["v"], b["v"])
        assert_same(a["pos"], b["pos"])


@pytest.mark.parametrize("name,cache_len", [("mamba2_1_3b", 20),
                                            ("zamba2_7b", 20),
                                            ("zamba2_7b", 9)])
def test_prefill_and_decode_match_jax(name, cache_len):
    """``prefill`` over two 13-token prompts, then 5 greedy
    ``decode_step``s: logits, h, conv, k/v/pos caches and tokens against
    JAX ``T.prefill``/``T.decode_step``.  ``cache_len`` 9 < 18 tokens of
    context wraps the hybrid's attention cache as a ring."""
    cfg, jcfg, jp, tp = _weights(name)
    toks = _prompts(2, 13, cfg.vocab, seed=2)
    lg, st = T.prefill(tp, cfg, torch.from_numpy(toks), cache_len)
    jlg, jst = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          cache_len=cache_len)
    assert lg.shape == (2, 1, T.pad_vocab(cfg.vocab))
    assert_close(lg, jlg)
    _compare_state(st, jst)
    for _ in range(5):
        g = lg[:, 0, :cfg.vocab].argmax(dim=-1)
        jg = jnp.argmax(jlg[:, 0, :jcfg.vocab], axis=-1)
        assert_same(g, jg)
        lg, st = T.decode_step(tp, cfg, st, g[:, None].int())
        jlg, jst = JT.decode_step(jp, jcfg, jst,
                                  {"tokens": jg[:, None].astype(jnp.int32)})
        assert_close(lg, jlg)
        _compare_state(st, jst)
    if cfg.layout == "hybrid":
        assert len(st["attn"]) == 1 and st["attn"][0]["k"].shape[1] \
            == cache_len
        if cache_len < 18:
            assert int(st["attn"][0]["pos"].min()) == 18 - cache_len


@pytest.mark.parametrize("name,S", [("mamba2_1_3b", 1), ("mamba2_1_3b", 2),
                                    ("zamba2_7b", 2)])
def test_short_prompt_decodes_like_teacher_forcing(name, S):
    """ROADMAP C7: after a prompt shorter than d_conv - 1 = 3 tokens the
    JAX decode fails (its prefill keeps only the prompt's conv rows); the
    port zero-pads the conv context, so its prefill + decode logits equal
    JAX's teacher-forced ``forward_hidden`` + ``logits_out`` over the
    prompt and the tokens fed, within 2e-4: the limit
    ``tests/test_archs_smoke.py`` holds between the JAX package's own
    prefill/decode and its forward pass (the chunked scan against the
    recurrence)."""
    cfg, jcfg, jp, tp = _weights(name, seed=3)
    extra = 4
    full = _prompts(2, S + extra, cfg.vocab, seed=4)
    h, _ = JT.forward_hidden(jp, jcfg, {"tokens": jnp.asarray(full)})
    want = np.asarray(JT.logits_out(jp, jcfg, h))
    lg, st = T.prefill(tp, cfg, torch.from_numpy(full[:, :S]), S + extra)
    assert st["mamba"][0]["conv"].shape[1] == 3
    assert_close(lg[:, 0], want[:, S - 1], atol=2e-4, rtol=2e-4)
    for t in range(extra):
        lg, st = T.decode_step(tp, cfg, st,
                               torch.from_numpy(full[:, S + t:S + t + 1]))
        assert_close(lg[:, 0], want[:, S + t], atol=2e-4, rtol=2e-4)
    _, jst = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(full[:, :S])},
                        cache_len=S + extra)
    with pytest.raises(ValueError):
        JT.decode_step(jp, jcfg, jst,
                       {"tokens": jnp.asarray(full[:, S:S + 1])})


def test_generate_is_prefill_then_greedy_decode():
    """``generate`` emits the greedy tokens of a hand-driven loop, with
    its timings and the state's bytes; no kernel launches on the CPU."""
    cfg, _, _, tp = _weights("zamba2_7b", seed=5)
    prompts = _prompts(2, 13, cfg.vocab, seed=6)
    kernels.reset_launch_counts()
    res = longctx_decode.generate(tp, cfg, prompts.tolist(), 6, 19)
    assert sum(kernels.launch_counts().values()) == 0
    lg, st = T.prefill(tp, cfg, torch.from_numpy(prompts), 19)
    want = []
    for _ in range(6):
        g = lg[:, 0, :cfg.vocab].argmax(dim=-1)
        want.append(g)
        lg, st = T.decode_step(tp, cfg, st, g[:, None].int())
    assert res["tokens"] == torch.stack(want, 1).tolist()
    assert_close(res["logits"], lg, atol=0, rtol=0)
    assert res["prefill_s"] > 0 and res["decode_tokens_per_s"] > 0
    spec = T.mamba_spec_of(cfg)
    assert res["ssm_state_bytes"] == cfg.n_layers * 2 * spec.n_heads * \
        spec.d_state * spec.headdim * 4
    assert res["kv_cache_bytes"] == 2 * 19 * 4 + 2 * (
        2 * 19 * cfg.n_kv_heads * cfg.head_dim * 4)


def test_longctx_main_runs_on_cpu(capsys):
    assert longctx_decode.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mamba2_1_3b" in out and "decoded 40 tokens" in out


def test_longctx_main_prints_both_halves(capsys):
    """``main`` runs both halves of ``examples/longctx_decode.py``:
    mamba2 with O(1) SSM state and no K/V, then mixtral with the K/V of
    a 16-slot ring per layer (float32), though its prompt and horizon
    run past the window, then gemma3, musicgen and qwen2_vl (the last two
    on embeddings) with caches that hold their whole context, and the
    example's closing line."""
    assert longctx_decode.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    mx = smoke(registry()["mixtral_8x7b"])
    mb = smoke(registry()["mamba2_1_3b"])
    spec = T.mamba_spec_of(mb)
    ring = mx.n_layers * 2 * 16 * mx.n_kv_heads * mx.head_dim * 4
    ssm = mb.n_layers * spec.n_heads * spec.d_state * spec.headdim * 4
    assert mx.sliding_window == 16
    assert lines[0].startswith("mamba2_1_3b      decoded 40 tokens past a "
                               "24-token prompt on cpu; state: kv=0B "
                               f"ssm={ssm}B")
    assert lines[3].startswith("mixtral_8x7b     decoded 40 tokens past a "
                               "24-token prompt on cpu; state: "
                               f"kv={ring}B ssm=0B")
    assert lines[4].startswith("  first 10: [")
    # then gemma3 (tokens), musicgen and qwen2_vl (embeds), whole-context
    # caches: three lines each
    assert lines[6].startswith("gemma3_4b        decoded 40 tokens past a "
                               "24-token prompt on cpu; state: kv=")
    assert lines[9].startswith("musicgen_medium  decoded 40 steps past a "
                               "24-frame embeds prompt on cpu; state: kv=")
    assert lines[9].endswith("(gelu FFN, embeds in)")
    assert lines[12].startswith("qwen2_vl_72b     decoded 40 steps past a "
                                "24-frame embeds prompt on cpu")
    assert lines[-1] == "ring-buffer / O(1)-state long-context decode ✓"
    assert len(lines) == 16


def test_dense_cache_entry_points_refuse_what_is_not_ported():
    """The dense cache serves every arch now (the GELU and embeds archs in
    ``tests/test_torch_embeds_archs.py``); the paged engine still refuses
    the Mamba and hybrid layouts and the embeds archs (musicgen, qwen2_vl),
    as the JAX engine, which embeds token ids only, does; without a card
    the default device raises."""
    from repro_torch.serving.engine import PagedServingEngine, ServeConfig
    for name, what in (("qwen2_vl_72b", "input_mode='embeds'"),
                       ("musicgen_medium", "input_mode='embeds'"),
                       *((a, "attention archs") for a in ARCHS)):
        cfg = smoke(registry()[name])
        params = T.init_params(cfg, device="cpu")
        T.init_decode_state(cfg, 1, 8, device="cpu")
        with pytest.raises(NotImplementedError, match="paged engine"):
            PagedServingEngine(cfg, params, ServeConfig(), device="cpu")
        with pytest.raises(NotImplementedError, match=what):
            PagedServingEngine(cfg, params, ServeConfig(), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                T.init_decode_state(cfg, 1, 8)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                T.init_params(cfg)