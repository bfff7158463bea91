"""``moe_ffn_bwd`` and ``moe_ffn`` at their training shapes, for comparing
two trees on one card.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/moe_bwd_lines.py [LABEL] [--only NAME[,NAME...]]

It imports the ``chip_smoke.py`` beside it in the working directory for
its seeded inputs and timers, and prints one JSON line a shape: LABEL,
the card, and

- float32 (``f32_olmoe_train``, ``f32_tiered_micro``): olmoe's training
  shape (2048 tokens x top 8 = 16384 rows over 64 experts, d 2048, ff
  1024) and ``train_moe_tiered``'s microbatch (smoke olmoe: 256 tokens x
  top 2 = 512 rows over 8 experts, d 128, ff 64);
- bfloat16 (``bf16_olmoe_train``, ``bf16_mixtral_train``): olmoe's
  training shape and mixtral's (4096 tokens x top 2 = 8192 rows over 8
  experts, d 4096, ff 14336: the dry run's mixtral ``train_4k`` expert
  shape), rows and weights in bf16, dy float32;

each with the backward's device ms (a CUDA graph of 10 calls, replayed 3
times; the forward's g, u and h made before it where the tree's backward
takes them), each backward kernel's device ms (``torch.profiler``, the
mean of its traced instances, by kernel name in the order they ran:
down dgrad, x dgrad, weight gradients), the serving forward's and,
where the tree has it, the training forward's device ms, and a SHA-256
of the backward's five outputs.  A tree whose ``moe_ffn_backward`` takes
no g, u, h (a design that recomputes them) is timed as it is, so the
same command compares a change with its parent: run it from both
unpacked trees as parent / change / change / parent in one call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

# name: (d, ff, experts, tokens, top_k, dtype name, seed offset)
SHAPES = {
    "f32_olmoe_train": (2048, 1024, 64, 2048, 8, "float32", 40),
    "f32_tiered_micro": (128, 64, 8, 256, 2, "float32", 41),
    "bf16_olmoe_train": (2048, 1024, 64, 2048, 8, "bfloat16", 51),
    "bf16_mixtral_train": (4096, 14336, 8, 4096, 2, "bfloat16", 52),
}


def _kernel(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameters: ``b16::moe_bwd16_kernel<0>``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0]


def _launch_ms(prof) -> dict:
    """Each backward kernel's mean device ms over its traced instances (a
    trace can drop some), by kernel name, in the order the kernels first
    ran (down dgrad, x dgrad, weight gradients)."""
    sums: dict[str, list] = {}
    for e in sorted((e for e in prof.events()
                     if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start):
        t = sums.setdefault(_kernel(e.name), [0.0, 0])
        t[0] += e.time_range.end - e.time_range.start
        t[1] += 1
    return {k: t / n / 1e3 for k, (t, n) in sums.items()}


def shape_line(cs, KM, name) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    d, ff, E, tokens, top_k, dt, seed = SHAPES[name]
    dtype = getattr(torch, dt)
    xg, offs, w, gate, _ = cs._moe_inputs(d, ff, E, tokens, top_k, dtype,
                                          cs.SEED + seed)
    R = tokens * top_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + seed + 1)
    dy = torch.randn((R, d), generator=gen, device="cuda")
    train = getattr(KM, "moe_ffn_train", None)
    guh = train(xg, offs, *w, gate)[1:] if train else ()

    def bwd():
        return KM.moe_ffn_backward(dy, xg, offs, *w, gate, *guh)
    out = bwd()
    torch.cuda.synchronize()
    dig = hashlib.sha256()
    for t in out:
        dig.update(t.view(torch.uint8).cpu().numpy().tobytes())
    del out
    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            bwd()
        torch.cuda.synchronize()
    line = {"shape": name, "dtype": dt, "rows": R, "experts": E, "d": d,
            "ff": ff, "bwd_launches_per_call": KM.BWD_LAUNCHES,
            "bwd_kernel_ms": _launch_ms(prof),
            "bwd_device_ms": cs._graph_ms(bwd, calls=10, replays=3),
            "bwd_sha256": dig.hexdigest()[:16],
            "fwd_serving_device_ms": cs._graph_ms(
                lambda: KM.moe_ffn(xg, offs, *w, gate), calls=10,
                replays=3)}
    if train:
        line["fwd_training_device_ms"] = cs._graph_ms(
            lambda: train(xg, offs, *w, gate), calls=10, replays=3)
    return line


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("label", nargs="?", default="tree")
    ap.add_argument("--only", default="",
                    help="comma-separated names of SHAPES to run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("moe_bwd_lines: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels import moe_ffn as KM
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    for name in [n for n in args.only.split(",") if n] or list(SHAPES):
        line = {"label": args.label, "card": card,
                **shape_line(cs, KM, name)}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
