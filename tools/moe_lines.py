"""Kernel ``moe_ffn`` at ``chip_smoke.py``'s shapes, alone.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/moe_lines.py [LABEL] [--only NAME[,NAME...]]

It imports the ``chip_smoke.py`` beside it in the working directory and
prints one JSON line: LABEL, the card, and for each ``moe_ffn`` shape
(olmoe's decode and 256-row prefill bucket, mixtral's prefill and
decode in bf16; olmoe's decode and the mixtral probe's prefill in
float32; inputs from chip_smoke's ``_moe_inputs`` and its seeds) the
device ms per call over a CUDA graph, each kernel's device ms
(``torch.profiler``), ``torch._grouped_mm``'s device ms where it
applies, the bound, and a SHA-256 of the output, so two trees' bits
compare by digest.  It adds a SHA-256 of K8's output (bf16 and float32
at chip_smoke's GQA shape), so a change to the kernels' shared helpers
shows in K8's bits.  Two trees are compared by running it in each,
interleaved, in one call on one card (copy this file into a tree that
lacks it).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

# name: (d, ff, experts, tokens, top_k, dtype name, seed offset); the
# first five rows are chip_smoke's bench_moe_kernels rows
SHAPES = {
    "bf16_olmoe_decode": (2048, 1024, 64, 8, 8, "bfloat16", 30),
    "bf16_olmoe_prefill": (2048, 1024, 64, 256, 8, "bfloat16", 31),
    "bf16_mixtral_prefill": (4096, 14336, 8, 4160, 2, "bfloat16", 32),
    "f32_olmoe_decode": (2048, 1024, 64, 8, 8, "float32", 33),
    "f32_mixtral_probe": (4096, 14336, 8, 4092, 2, "float32", 34),
    "bf16_mixtral_decode": (4096, 14336, 8, 1, 2, "bfloat16", 36),
}


def _digest(*ts) -> str:
    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _kernel_device_ms(fn, calls: int) -> dict:
    """Mean device ms of each kernel ``fn`` launches, by name, over a
    ``torch.profiler`` trace of ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans: dict[str, list[float]] = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "moe" in e.name):
            spans.setdefault(e.name[:80], []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return {n: sum(v) / len(v) for n, v in spans.items()}


def _moe_line(cs, name: str) -> dict:
    import torch
    from repro_torch.kernels import moe_ffn as KM
    d, ff, n_exp, tokens, top_k, dt, seed = SHAPES[name]
    dtype = getattr(torch, dt)
    xg, offs, w, gate, sizes = cs._moe_inputs(d, ff, n_exp, tokens, top_k,
                                              dtype, cs.SEED + seed)

    def call():
        return KM.moe_ffn(xg, offs, *w, gate)
    y = call()
    torch.cuda.synchronize()
    one = cs._time_ms(call, iters=1, warmup=1)
    calls = max(1, min(50, int(100 / max(one, 1e-3))))
    replays = max(2, min(20, int(600 / max(one * calls, 1e-3))))
    R = tokens * top_k
    el = xg.element_size()
    touched = int((sizes > 0).sum())
    nbytes = (touched * 3 * d * ff * el + R * d * el + R * d * 4 + R * 4
              + (n_exp + 1) * 4)
    flops = 6.0 * R * d * ff
    if dtype == torch.float32:
        bound = cs._f32_bounds(nbytes, flops)
    else:
        b, by = cs._bound_ms(nbytes, flops)
        bound = {"bound_ms": b, "bound_by": by}
    out = {"shape": {"d": d, "ff": ff, "experts": n_exp, "rows": R,
                     "touched_experts": touched, "dtype": dt},
           "device_ms": cs._graph_ms(call, calls=calls, replays=replays),
           "kernels_ms": _kernel_device_ms(call, min(calls, 10)),
           "sha256": _digest(y), **bound,
           "timing_calls": {"graph": calls, "replays": replays}}
    lib, note = cs._grouped_mm_library(xg, offs, w, gate)
    out["library_call"] = note
    out["library_device_ms"] = (cs._graph_ms(lib, calls=calls,
                                             replays=replays)
                                if lib is not None else None)
    del xg, w, y
    torch.cuda.empty_cache()
    return out


def _k8_digests(cs) -> dict:
    """K8 at chip_smoke's GQA shape, bf16 and float32, on seeded inputs."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    B, S, Hq, Hkv, D = cs.FLASH_GQA_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 40)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, S, Hq, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
        out[str(dtype).removeprefix("torch.")] = _digest(
            flash_attention(q, k, v, causal=True),
            flash_attention(q, k, v, causal=True, window=512))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("label", nargs="?", default="")
    ap.add_argument("--only", default="",
                    help="comma-separated names of SHAPES to run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("moe_lines: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_ffn as KM
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    names = [n for n in args.only.split(",") if n] or list(SHAPES)
    line = {"label": args.label, "card": cs._card_line(),
            "k8_sha256": _k8_digests(cs)}
    if hasattr(KM, "launch_info"):
        line["launch_info"] = {
            name: KM.launch_info(getattr(torch, s[5]), s[3] * s[4], s[2])
            for name, s in SHAPES.items()}
    for name in names:
        line[name] = _moe_line(cs, name)
        print(json.dumps({name: line[name]}), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
