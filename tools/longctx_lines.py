"""Kernel K9 and the long-context prefills of ``chip_smoke.py``, alone.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/longctx_lines.py [LABEL] [--repeats N] [--f32-only]

It imports the ``chip_smoke.py`` beside it in the working directory and
prints one JSON line: LABEL, the card, and for each of K9's shapes in
that script (zamba2's and mamba2's bf16 prefill, the float32 probe's,
then zamba2's and mamba2's prefill shapes in float32) the device ms per
call over a CUDA graph of 10 calls, each of its four kernels' device ms
(``torch.profiler``) and a SHA-256 of the call's y and
h_final on seeded inputs with an initial state, so two trees' bits
compare by digest.  With ``--repeats N`` (default 0) it then runs the
long-context generation of zamba2_7b and mamba2_1_3b in bf16 and of
mamba2_1_3b in float32 (``--f32-only``: that one alone) N times each in
this one process, at chip_smoke's sizes, and adds each run's prefill
seconds and decode tokens/s: the first run of a model pays the process's
one-time costs.  Two trees are compared by running it in each,
interleaved, in one call on one card (copy this file into a tree that
lacks it).
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path


def _k9_lines(cs) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan as K9
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 17)
    bf = torch.bfloat16
    out = {}
    for name, B, L, H, P, N, dtype in (
            ("zamba2", cs.LONGCTX_BATCH, cs.LONGCTX_PROMPT, 112, 64, 64, bf),
            ("mamba2", cs.LONGCTX_BATCH, cs.LONGCTX_PROMPT, 64, 64, 128, bf),
            ("float32", 1, cs.LONGCTX_PROBE_PROMPT, 112, 64, 64,
             torch.float32),
            ("zamba2_f32", cs.LONGCTX_BATCH, cs.LONGCTX_PROMPT, 112, 64, 64,
             torch.float32),
            ("mamba2_f32", cs.LONGCTX_BATCH, cs.LONGCTX_PROMPT, 64, 64, 128,
             torch.float32)):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = randn(B, L, H, P).to(dtype)
        dt = F.softplus(randn(B, L, H))
        A = -torch.exp(0.5 * randn(H))
        Bm, Cm = randn(B, L, N).to(dtype), randn(B, L, N).to(dtype)
        h0 = randn(B, H, N, P)
        y, h = K9.ssd_scan(x, dt, A, Bm, Cm, 128, h0=h0)
        digest = hashlib.sha256(y.cpu().numpy().tobytes()
                                + h.cpu().numpy().tobytes()).hexdigest()
        ms = cs._graph_ms(lambda: K9.ssd_scan(x, dt, A, Bm, Cm, 128, h0=h0),
                          calls=10, replays=10)
        out[name] = {"device_ms": ms, "sha256": digest,
                     "pass_ms": cs._kernel_ms(
                         lambda: K9.ssd_scan(x, dt, A, Bm, Cm, 128, h0=h0),
                         K9.PASSES, calls=10)}
        del x, dt, Bm, Cm, h0, y, h
        torch.cuda.empty_cache()
    return out


def _longctx(cs, arch: str, dtype) -> dict:
    """One long-context generation at chip_smoke's sizes: random weights
    from its seed in ``dtype``, its prompts, prefill then greedy decode.
    Written here, not taken from chip_smoke's ``run_longctx``, so one code
    runs in both trees of a comparison whatever their chip_smoke takes."""
    import torch
    from repro_torch.configs.base import registry
    from repro_torch.launch.longctx_decode import generate
    from repro_torch.models.transformer import init_params
    cfg = registry()[arch]
    params = init_params(cfg, seed=cs.SEED, dtype=dtype, device="cuda")
    prompts = cs._prompts(cs.LONGCTX_BATCH, cs.LONGCTX_PROMPT, cfg.vocab,
                          cs.SEED + 11)
    res = generate(params, cfg, prompts, cs.LONGCTX_NEW, cs.LONGCTX_CACHE)
    del params
    torch.cuda.empty_cache()
    return {"prefill_s": res["prefill_s"],
            "decode_tokens_per_s": res["decode_tokens_per_s"],
            "ssd_scan_prefill_launches": res["prefill_launches"]["ssd_scan"],
            "first_tokens": [t[:8] for t in res["tokens"]]}


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("longctx_lines: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    if not (root / "chip_smoke.py").is_file():
        print(f"longctx_lines: no chip_smoke.py in {root}", file=sys.stderr)
        return 1
    repeats = 0
    f32_only = "--f32-only" in argv
    argv = [a for a in argv if a != "--f32-only"]
    if "--repeats" in argv:
        i = argv.index("--repeats")
        repeats = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    out = {"label": argv[0] if argv else str(root), "card": cs._card_line(),
           "ssd_scan": _k9_lines(cs)}
    runs = [("mamba2_1_3b_f32", "mamba2_1_3b", torch.float32)]
    if not f32_only:
        runs[:0] = [(a, a, torch.bfloat16) for a in ("zamba2_7b",
                                                      "mamba2_1_3b")]
    for key, arch, dtype in runs:
        if repeats:
            out[key] = [_longctx(cs, arch, dtype) for _ in range(repeats)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
