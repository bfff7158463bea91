"""Kernel K8 (``flash_attention``) at ``chip_smoke.py``'s shapes, alone.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/flash_lines.py [LABEL] [--prefill N]

It imports the ``chip_smoke.py`` beside it in the working directory and
prints one JSON line: LABEL, the card, and for each shape the kernel's
device ms per call over a CUDA graph of 10 calls, its largest error
against the plain version, SDPA's device ms on the same inputs (KV
expanded to the q heads outside the timing) and a SHA-256 of the
kernel's output, so two trees' bits compare by digest.  The shapes:
zamba2's prefill (B 4, S 2000, 32/32 heads, D 112, causal; bf16 with and
without a 512-token window, float32), the GQA shape (B 1, S 2048, 32/8,
D 128; bf16 and float32), the float32 long-context probe's (B 1, S 500),
gemma3_4b's (B 4, S 2000, 8/4, D 256; causal and its 1024-token window,
bf16 and float32) and musicgen_medium's (B 4, S 2000, 24/24, D 64,
bf16).  A tree whose wrapper refuses a shape reports the refusal.
With ``--prefill N`` it then runs gemma3_4b's bf16 long-context
generation at chip_smoke's sizes (whole model, seeded weights, 4 x 2000
prompt tokens, two new tokens) N times in this one process and adds each
run's prefill seconds; compare the later runs (the first pays the
process's one-time costs).  Inputs are seeded random values; two trees
are compared by running it in each, interleaved, in one call on one card
(copy this file into a tree that lacks it).
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

SHAPES = (
    # name, B, S, Hq, Hkv, D, window, dtype
    ("zamba2_bf16", 4, 2000, 32, 32, 112, 0, "bfloat16"),
    ("zamba2_window_bf16", 4, 2000, 32, 32, 112, 512, "bfloat16"),
    ("gqa_bf16", 1, 2048, 32, 8, 128, 0, "bfloat16"),
    ("gqa_f32", 1, 2048, 32, 8, 128, 0, "float32"),
    ("probe_f32", 1, 500, 32, 32, 112, 0, "float32"),
    ("zamba2_f32", 4, 2000, 32, 32, 112, 0, "float32"),
    ("gemma3_global_bf16", 4, 2000, 8, 4, 256, 0, "bfloat16"),
    ("gemma3_window_bf16", 4, 2000, 8, 4, 256, 1024, "bfloat16"),
    ("gemma3_global_f32", 4, 2000, 8, 4, 256, 0, "float32"),
    ("gemma3_window_f32", 4, 2000, 8, 4, 256, 1024, "float32"),
    ("musicgen_bf16", 4, 2000, 24, 24, 64, 0, "bfloat16"),
)


def _digest(t) -> str:
    return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()


def _line(cs, B, S, Hq, Hkv, D, window, dtype) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 31)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev).to(dt)
               for h in (Hq, Hkv, Hkv))
    try:
        got = K8.flash_attention(q, k, v, window=window)
    except ValueError as e:
        return {"refused": str(e)}
    err = float((got.float() - K8.flash_attention_plain(
        q, k, v, window=window).float()).abs().max())
    G = Hq // Hkv
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1)
              for t in (k, v))
    if window:
        i = torch.arange(S, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask)
    else:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
    out = {"device_ms": cs._graph_ms(
               lambda: K8.flash_attention(q, k, v, window=window),
               calls=10, replays=10),
           "max_abs_err": err,
           "sdpa_device_ms": cs._graph_ms(lib, calls=10, replays=10),
           "sha256": _digest(got)}
    del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()
    return out


def _gemma3_prefills(cs, repeats: int) -> list[float]:
    """gemma3_4b's bf16 prefill seconds, ``repeats`` runs of one
    generation at chip_smoke's batch, prompt and cache (two new tokens),
    written here so one code runs in both trees of a comparison."""
    import torch
    from repro_torch.configs.base import registry
    from repro_torch.launch.longctx_decode import generate
    from repro_torch.models.transformer import init_params
    cfg = registry()["gemma3_4b"]
    params = init_params(cfg, seed=cs.SEED, dtype=torch.bfloat16,
                         device="cuda")
    prompts = cs._prompts(cs.LONGCTX_BATCH, cs.LONGCTX_PROMPT, cfg.vocab,
                          cs.SEED + 11)
    out = [generate(params, cfg, prompts, 2, cs.LONGCTX_CACHE)["prefill_s"]
           for _ in range(repeats)]
    del params
    torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_lines: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    if not (root / "chip_smoke.py").is_file():
        print(f"flash_lines: no chip_smoke.py in {root}", file=sys.stderr)
        return 1
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    repeats = 0
    if "--prefill" in argv:
        i = argv.index("--prefill")
        repeats = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    line = {"label": argv[0] if argv else str(root), "card": cs._card_line()}
    for name, *shape in SHAPES:
        line[name] = _line(cs, *shape)
    if repeats:
        line["gemma3_bf16_prefill_s"] = _gemma3_prefills(cs, repeats)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
