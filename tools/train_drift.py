"""Where a smoke training run on the card drifts from the same run on the
CPU, for ``chip_smoke.py``'s ``train_card_vs_cpu`` (seq 64, batch 8 in 2
microbatches, lr 1e-3 decaying over 5 steps, its seed).

Run on a card from the root of a checkout:

    python3 tools/train_drift.py [ARCH ...]      # default: olmoe_1b_7b

For each arch (smoke width) it prints one JSON line: for each of the five
steps, the worst gradient leaves of the card against the CPU (one
microbatch, each leaf's largest difference over its largest CPU
magnitude) when each device steps from its own state and when the card
takes the CPU's state, and after step 1 the entries whose parameters
moved furthest apart, with the gradient each device gave them (m / 0.1
after one step) and their leaf's largest gradient.  AdamW's first update
is lr g / (|g| + 1e-8), so an entry whose gradient lies near 1e-8 moves
up to lr apart on the two devices for a last-bit difference.
"""
from __future__ import annotations

import json
import sys
from functools import partial
from pathlib import Path

STEPS, TOP = 5, 4


def _grads(T, tree, torch, params, cfg, mb, dev):
    b = {k: torch.from_numpy(v[0]).to(dev) for k, v in mb.items()}
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = T.loss_fn(params, cfg, b)
    g = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return [x.detach().cpu() for x in g]


def _worst(got, want, names):
    rows = []
    for n, a, b in zip(names, got, want):
        scale = float(b.abs().max()) or 1.0
        rows.append([float((a - b).abs().max()) / scale, n])
    return sorted(rows, reverse=True)[:TOP]


def drift(name: str) -> dict:
    import torch
    from chip_smoke import SEED, TRAIN_LR
    from repro_torch import tree
    from repro_torch.configs.base import registry, smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_train_step, micro_batches
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, cosine_with_warmup
    cfg = smoke(registry()[name])
    src = SyntheticLM(cfg.vocab, 64, 8, seed=SEED + 36,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)
    lr_fn = partial(cosine_with_warmup, peak_lr=TRAIN_LR, warmup=0,
                    total=STEPS)
    pc = T.init_params(cfg, seed=SEED, device="cpu")
    pg = tree.map_leaves(lambda t: t.cuda(), pc)
    names = tree.flatten_with_names(pc)[0]
    oc, og = adamw.init(pc), adamw.init(pg)
    step_c, step_g = (make_train_step(cfg, lr_fn=lr_fn) for _ in range(2))
    steps = []
    for step in range(STEPS):
        mb = micro_batches(src.batch(step), 2)
        gc = _grads(T, tree, torch, pc, cfg, mb, "cpu")
        own = _grads(T, tree, torch, pg, cfg, mb, "cuda")
        shared = _grads(T, tree, torch,
                        tree.map_leaves(lambda t: t.cuda(), pc), cfg, mb,
                        "cuda")
        steps.append({"step": step, "own_state": _worst(own, gc, names),
                      "shared_state": _worst(shared, gc, names)})
        pc, oc, _ = step_c(pc, oc, mb)
        pg, og, _ = step_g(pg, og, mb)
        if step == 0:
            moved = []
            for n, a, b, ma, mc in zip(names, tree.leaves(pg),
                                       tree.leaves(pc), tree.leaves(og.m),
                                       tree.leaves(oc.m)):
                d = (a.cpu() - b).abs().flatten()
                top = torch.topk(d, min(TOP, d.numel()))
                for v, j in zip(top.values.tolist(), top.indices.tolist()):
                    moved.append({
                        "param_diff": v, "leaf": n, "index": j,
                        "grad_card": float(ma.cpu().flatten()[j]) / 0.1,
                        "grad_cpu": float(mc.flatten()[j]) / 0.1,
                        "leaf_max_grad": float(mc.abs().max()) / 0.1})
            moved.sort(key=lambda r: -r["param_diff"])
    return {"arch": name, "steps": steps,
            "moved_after_step_1": moved[:TOP]}


def main() -> int:
    root = Path.cwd()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("train_drift: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    for name in sys.argv[1:] or ["olmoe_1b_7b"]:
        print(json.dumps({"card": card, **drift(name)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
