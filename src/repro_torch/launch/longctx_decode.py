"""Long-context generation on the dense-cache path (torch twin of
``examples/longctx_decode.py``): a Mamba-2 model prefills a prompt, then
decodes greedily far past it with O(1) state per layer, and a
sliding-window MoE model (mixtral) decodes with a ring-buffer KV cache
that never grows.

``generate`` runs ``prefill`` over a batch of equal-length prompts (K9 in
every Mamba layer, K8 at every shared-attention site of a hybrid and in
every layer of an attention model, ``moe_ffn`` in every MoE layer), then
``decode_step`` once per new token, and returns the tokens with their
timings.  An ``input_mode="embeds"`` arch (musicgen, qwen2_vl: the
frontend is stubbed, as in the JAX package) takes prompt embeddings and
one given embedding per new step (teacher-forced) and records the greedy
codes of each step's logits.  ``main`` runs the example's smoke-size
mamba2_1_3b and mixtral_8x7b (a 16-slot ring), then smoke-size gemma3_4b
(16-slot rings on its local layers), musicgen_medium (GELU FFN, embeds)
and qwen2_vl_72b (M-RoPE, embeds) with caches that hold the whole
context:

    PYTHONPATH=src python -m repro_torch.launch.longctx_decode               # the card
    PYTHONPATH=src python -m repro_torch.launch.longctx_decode --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import ArchConfig, registry, smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def state_bytes(state: dict) -> dict[str, int]:
    """Bytes of the decode state: the SSM states, the conv contexts and
    the K/V caches (with their position tables, and an int8 cache's
    scales)."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    return {"ssm_state_bytes": nbytes(m["h"] for m in state["mamba"]),
            "conv_state_bytes": nbytes(m["conv"] for m in state["mamba"]),
            "kv_cache_bytes": nbytes(t for c in state["attn"]
                                     for t in c.values())}


def _embeds(x, device, dtype) -> torch.Tensor:
    """Embeddings (a tensor or an array) on ``device`` in ``dtype``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
    return x.to(device=device, dtype=dtype)


def generate(params: dict, cfg: ArchConfig, prompts, max_new: int,
             cache_len: int, *, step_embeds=None) -> dict:
    """Prefill ``prompts`` (equal lengths, [B][S] token ids), then take
    ``max_new`` greedy tokens, one ``decode_step`` each.  An embeds arch
    takes ``prompts`` as embeddings [B, S, d] and ``step_embeds`` [B, >=
    max_new, d], step i's input (the stubbed frontend's next frames; the
    greedy codes are recorded, not fed back).  Embeddings are cast to the
    weights' type.  Returns the tokens [B][max_new], ``prefill_s``,
    ``decode_s``, ``decode_tokens_per_s`` (B * max_new over
    ``decode_s``), the kernel launches of each half
    (``prefill_launches``, ``decode_launches``), the first logits, the
    final logits and state, and the state's bytes."""
    device = params["embed"].device
    if cfg.input_mode == "embeds":
        dtype = params["embed"].dtype
        prompt = _embeds(prompts, device, dtype)
        if max_new and (step_embeds is None
                        or len(step_embeds[0]) < max_new):
            raise ValueError(f"{cfg.name}: an embeds arch needs "
                             f"step_embeds for each of {max_new} steps")
        steps = (_embeds(step_embeds, device, dtype) if max_new else None)

        def pre():
            return T.prefill(params, cfg, None, cache_len, embeds=prompt)

        def step(state, i, g):
            return T.decode_step(params, cfg, state, None,
                                 embeds=steps[:, i:i + 1])
    else:
        prompt = torch.as_tensor(np.asarray(prompts, dtype=np.int32),
                                 device=device)

        def pre():
            return T.prefill(params, cfg, prompt, cache_len)

        def step(state, i, g):
            return T.decode_step(params, cfg, state,
                                 g[:, None].to(torch.int32))
    B = prompt.shape[0]
    n0 = kernels.launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    logits, state = pre()
    _sync(device)
    t1 = time.perf_counter()
    n1 = kernels.launch_counts()
    first_logits = logits
    gen = []
    for i in range(max_new):
        g = logits[:, 0, :cfg.vocab].argmax(dim=-1)
        gen.append(g)
        logits, state = step(state, i, g)
    _sync(device)
    t2 = time.perf_counter()
    n2 = kernels.launch_counts()
    out = torch.stack(gen, dim=1).cpu().tolist() if gen else \
        [[] for _ in range(B)]
    decode_s = t2 - t1
    return {"tokens": out, "prefill_s": t1 - t0, "decode_s": decode_s,
            "decode_tokens_per_s": (B * max_new / decode_s
                                    if max_new else 0.0),
            "prefill_launches": {k: n1[k] - n0[k] for k in n0},
            "decode_launches": {k: n2[k] - n1[k] for k in n0},
            "first_logits": first_logits, "logits": logits, "state": state,
            **state_bytes(state)}


def _kv_bytes(res: dict) -> int:
    """The example's K/V bytes: the K and V slots, not the position
    tables."""
    return sum(c[n].numel() * c[n].element_size()
               for c in res["state"]["attn"] for n in ("k", "v"))


def _report(res: dict) -> None:
    print(f"  first 10: {res['tokens'][0][:10]}")
    print(f"  prefill {res['prefill_s']:.3f} s, decode "
          f"{res['decode_tokens_per_s']:.1f} tokens/s")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    S, horizon = 24, 40
    for arch in ("mamba2_1_3b", "mixtral_8x7b"):
        cfg = smoke(registry()[arch])
        params = T.init_params(cfg, seed=0, device=device)
        prompt = np.random.RandomState(0).randint(0, cfg.vocab, size=S)
        res = generate(params, cfg, [prompt.tolist()], horizon,
                       cache_len=32)    # a cache far smaller than the context
        print(f"{arch:16s} decoded {horizon} tokens past a "
              f"{len(prompt)}-token prompt on {device}; state: "
              f"kv={_kv_bytes(res)}B ssm={res['ssm_state_bytes']}B "
              f"(context-length-independent)")
        _report(res)
    for arch in ("gemma3_4b", "musicgen_medium", "qwen2_vl_72b"):
        cfg = smoke(registry()[arch])
        params = T.init_params(cfg, seed=0, device=device)
        rng = np.random.RandomState(0)
        if cfg.input_mode == "embeds":
            e = rng.standard_normal((1, S + horizon, cfg.d_model))
            res = generate(params, cfg, e[:, :S], horizon, S + horizon,
                           step_embeds=e[:, S:])
            what = f"{horizon} steps past a {S}-frame embeds prompt"
        else:
            prompt = rng.randint(0, cfg.vocab, size=S)
            res = generate(params, cfg, [prompt.tolist()], horizon,
                           S + horizon)
            what = f"{horizon} tokens past a {S}-token prompt"
        print(f"{arch:16s} decoded {what} on {device}; state: "
              f"kv={_kv_bytes(res)}B ({cfg.mlp_kind} FFN, "
              f"{cfg.input_mode} in)")
        _report(res)
    print("ring-buffer / O(1)-state long-context decode ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
