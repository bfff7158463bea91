"""The ``attn`` layout's dense cache in the port (``transformer.prefill``
and ``decode_step``) against the JAX package's, at smoke width in
float32 with carried weights (``params_from_jax``) and the same prompts.

Cases: qwen3 (full-length caches, qk-norm), mixtral (MoE, sliding-window
ring buffers of 16 slots that wrap in the prompt and in the decode, as
JAX's ``test_sliding_window_cache_is_ring_buffer``), gemma3 at 6 layers
(5 local ring layers and 1 global one with its own RoPE theta, gemma
norms, scaled and tied embeddings) and ``kv_cache_quant`` int8 caches
(qwen3 and mixtral).  Logits within ``atol=1e-5, rtol=1e-4``; ``pos``
tables exact; float caches within the same tolerance; int8 values
within 1 of JAX's and their scales within ``rtol=1e-6`` in the first
layer (``1e-5`` deeper, where the K/V carry the float error of the
layers below).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import (assert_close, assert_same, cap_threads,
                                  np_of)
from repro.configs import registry as jregistry
from repro.configs import smoke as jsmoke
from repro.models import transformer as JT
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as T

cap_threads()

# (arch, changes to the smoke config, prompt length, cache_len, steps)
CASES = {
    "qwen3": ("qwen3_4b", {}, 11, 24, 5),
    "mixtral_ring": ("mixtral_8x7b", {}, 24, 64, 12),
    "gemma3_local_global": ("gemma3_4b", {"n_layers": 6}, 20, 40, 6),
    "qwen3_int8": ("qwen3_4b", {"kv_cache_quant": True}, 11, 24, 5),
    "mixtral_int8": ("mixtral_8x7b", {"kv_cache_quant": True}, 20, 32, 6),
}


def _models(arch, changes, seed=0):
    cfg = replace(smoke(registry()[arch]), **changes)
    jcfg = replace(jsmoke(jregistry()[arch]), **changes)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, tp, jcfg, jp


def _assert_caches(state, jstate, quant):
    assert len(state["attn"]) == len(jstate["attn"])
    assert_same(state["positions"], np.asarray(jstate["positions"]))
    for l, (c, jc) in enumerate(zip(state["attn"], jstate["attn"])):
        assert set(c) == set(jc)
        assert_same(c["pos"], np.asarray(jc["pos"]))
        for name in ("k", "v"):
            if quant:
                assert c[name].dtype == torch.int8
                diff = np.abs(np_of(c[name]).astype(np.int32)
                              - np.asarray(jc[name]).astype(np.int32))
                assert diff.max() <= 1
                # layer 0's K/V come from the embedding through one
                # product; deeper layers' carry the float error of the
                # layers below (up to 1.2e-6 relative after one MoE layer)
                np.testing.assert_allclose(
                    np_of(c[name + "_scale"]),
                    np.asarray(jc[name + "_scale"]),
                    rtol=1e-6 if l == 0 else 1e-5, atol=0)
            else:
                assert_close(c[name], jc[name])


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    arch, changes, S, cache_len, steps = CASES[case]
    cfg, tp, jcfg, jp = _models(arch, changes)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, size=(2, S + steps)).astype(np.int32)
    lg, st = T.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), cache_len)
    jlg, jst = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                          cache_len)
    assert lg.shape == jlg.shape
    assert_close(lg, jlg)
    _assert_caches(st, jst, cfg.kv_cache_quant)
    for t in range(steps):
        tok = toks[:, S + t:S + t + 1]
        lg, st = T.decode_step(tp, cfg, st, torch.from_numpy(tok))
        jlg, jst = JT.decode_step(jp, jcfg, jst, {"tokens": jnp.asarray(tok)})
        assert_close(lg, jlg)
        _assert_caches(st, jst, cfg.kv_cache_quant)


def test_cache_shapes_follow_the_window_pattern():
    """Ring buffers of min(window, cache_len) slots on windowed layers,
    ``cache_len`` on global ones; int8 caches carry per-head scales."""
    cfg = replace(smoke(registry()["gemma3_4b"]), n_layers=6)
    st = T.init_decode_state(cfg, 2, 40, device="cpu")
    assert [c["k"].shape[1] for c in st["attn"]] == [16] * 5 + [40]
    assert st["mamba"] == []
    q = replace(smoke(registry()["mixtral_8x7b"]), kv_cache_quant=True)
    st = T.init_decode_state(q, 1, 8, device="cpu")
    c = st["attn"][0]
    assert c["k"].shape == (1, 8, q.n_kv_heads, q.head_dim)
    assert c["k"].dtype == torch.int8
    assert c["k_scale"].shape == (1, 8, q.n_kv_heads)
    assert (c["pos"] == -1).all()


def test_ring_buffer_decode_equals_a_fresh_prefill():
    """mixtral's 16-slot ring past its window: each decode step's logits
    equal the last logits of a fresh prefill over the same tokens (the
    port against itself, the JAX test's property)."""
    cfg, tp, _, _ = _models("mixtral_8x7b", {})
    assert cfg.sliding_window == 16
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, size=(1, 28)).astype(np.int32))
    S = 24
    lg, st = T.prefill(tp, cfg, toks[:, :S], 64)
    assert st["attn"][0]["k"].shape[1] == 16
    for t in range(4):
        lg, st = T.decode_step(tp, cfg, st, toks[:, S + t:S + t + 1])
        want, _ = T.prefill(tp, cfg, toks[:, :S + t + 1], 64)
        assert_close(lg, want, atol=2e-4, rtol=2e-4)
    # the ring's slots hold the 16 most recent positions
    assert sorted(st["attn"][0]["pos"][0].tolist()) == list(range(12, 28))


def test_int8_cache_quantizes_on_write_and_reads_dequantized():
    """The int8 decode's K/V land at their ring slot as round(u / s)
    with s = max|u| / 127 per head, and the returned scales are the
    cache's own tensors updated in place."""
    cfg, tp, _, _ = _models("qwen3_4b", {"kv_cache_quant": True})
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, size=(1, 6)).astype(np.int32))
    _, st = T.prefill(tp, cfg, toks[:, :5], 8)
    k_scale = st["attn"][0]["k_scale"]
    _, st2 = T.decode_step(tp, cfg, st, toks[:, 5:])
    c = st2["attn"][0]
    assert c["k_scale"] is k_scale
    assert (c["pos"][0, :6] == torch.arange(6)).all()
    assert c["k"][0, 5].abs().max() == 127
    assert (c["k_scale"][0, :6] > 0).all() and (c["k_scale"][0, 6:] == 0).all()
