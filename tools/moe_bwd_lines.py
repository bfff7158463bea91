"""``moe_ffn_bwd`` and the float32 ``moe_ffn`` at their training shapes,
for comparing two trees on one card.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/moe_bwd_lines.py [LABEL]

It imports the ``chip_smoke.py`` beside it in the working directory for
its seeded inputs and timers, and prints one JSON line a shape: LABEL,
the card, and for olmoe's training shape (2048 tokens x top 8 = 16384
rows over 64 experts, d 2048, ff 1024) and ``train_moe_tiered``'s
microbatch (smoke olmoe: 256 tokens x top 2 = 512 rows over 8 experts,
d 128, ff 64) the backward's device ms (a CUDA graph of 10 calls,
replayed 3 times; the forward's g, u and h made before it where the
tree's backward takes them), each backward kernel's device ms
(``torch.profiler``, the mean of its traced instances, by kernel name), the serving forward's and, where
the tree has it, the training forward's device ms, and a SHA-256 of the
backward's outputs.  A tree whose ``moe_ffn_backward`` takes no g, u, h
(the parent design, which recomputes them) is timed as it is, so the
same command compares a change with its parent: run it from both
unpacked trees as parent / change / change / parent in one call.
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path


def shape_line(cs, KM, name, d, ff, E, tokens, top_k, seed) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    xg, offs, w, gate, _ = cs._moe_inputs(d, ff, E, tokens, top_k,
                                          torch.float32, seed)
    R = tokens * top_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    dy = torch.randn((R, d), generator=gen, device="cuda")
    train = getattr(KM, "moe_ffn_train", None)
    guh = train(xg, offs, *w, gate)[1:] if train else ()

    def bwd():
        return KM.moe_ffn_backward(dy, xg, offs, *w, gate, *guh)
    out = bwd()
    torch.cuda.synchronize()
    dig = hashlib.sha256()
    for t in out:
        dig.update(t.cpu().numpy().tobytes())
    del out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            bwd()
        torch.cuda.synchronize()
    us: dict[str, list] = {}
    for e in prof.events():
        if "moe_bwd_kernel" in e.name:
            key = e.name[e.name.index("moe_bwd_kernel"):][:18]
            t = us.setdefault(key, [0.0, 0])
            t[0] += e.time_range.end - e.time_range.start
            t[1] += 1
    # the mean of each kernel's traced instances (a trace can drop some)
    by = {k: t / n / 1e3 for k, (t, n) in us.items()}
    line = {"shape": name, "rows": R, "experts": E, "d": d, "ff": ff,
            "bwd_launches_per_call": KM.BWD_LAUNCHES,
            "bwd_device_ms": cs._graph_ms(bwd, calls=10, replays=3),
            "bwd_kernel_ms": by, "bwd_sha256": dig.hexdigest()[:16],
            "fwd_serving_device_ms": cs._graph_ms(
                lambda: KM.moe_ffn(xg, offs, *w, gate), calls=10,
                replays=3)}
    if train:
        line["fwd_training_device_ms"] = cs._graph_ms(
            lambda: train(xg, offs, *w, gate), calls=10, replays=3)
    return line


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("moe_bwd_lines: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels import moe_ffn as KM
    torch.backends.cuda.matmul.allow_tf32 = False
    label, card = argv[0] if argv else "tree", cs._card_line()
    for args in (("olmoe_train", 2048, 1024, 64, 2048, 8, cs.SEED + 40),
                 ("tiered_micro", 128, 64, 8, 256, 2, cs.SEED + 41)):
        line = {"label": label, "card": card, **shape_line(cs, KM, *args)}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
