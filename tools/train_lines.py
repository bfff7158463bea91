"""Where a training step's time goes, for ``chip_smoke.py``'s full-width
training runs.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/train_lines.py [LABEL] [--only PHASE]

It imports the ``chip_smoke.py`` beside it in the working directory and,
for each of its ``TRAIN_RUNS`` (qwen3_4b cut to 24 layers, mamba2_1_3b
whole, zamba2_7b cut to 14 layers, olmoe_1b_7b cut to 8; float32, seq
512, batch 8 in 2 microbatches) and for its ``bf16_train`` (olmoe_1b_7b
cut to 2 layers, bf16 parameters, the phase's learning rate; twelve
steps, the last eleven reported), draws the seeded weights, takes five
steps (the wall ms of the last four reported as ``unprofiled_step_ms``) and
then one step under ``torch.profiler`` (device activity only).  It
prints one JSON line a run: LABEL, the card, the step's wall ms, the device's busy ms and share (the union of the kernel
and copy intervals it traced), the device operations of the step, the ms
of the GEMM kernels (names holding ``gemm``), of the MoE FFN's forward
kernels (``moe_ffn``'s, names holding ``moe_tf32_kernel`` or
``moe_wgmma_kernel``) and of its backward's (``moe_ffn_bwd``'s,
``moe_bwd_kernel`` or the bf16 entry's ``b16::``), and the eight
kernels that took the most device time, and the step's peak device
memory.  ``--only PHASE`` (``train_olmoe`` or ``bf16_train``, say)
profiles that run alone.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import replace
from pathlib import Path


def profile_step(cfg, steps_before: int = 5, dtype=None,
                 lr: float = 1e-4) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SEED, TRAIN_BATCH, TRAIN_MICRO, TRAIN_SEQ
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_train_step, micro_batches
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    params = init_params(cfg, seed=SEED, dtype=dtype or torch.float32,
                         device="cuda")
    opt = adamw.init(params)
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)
    step_fn = make_train_step(cfg, lr_fn=lambda s: lr)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for s in range(steps_before + 1):
        batch = micro_batches(src.batch(s), TRAIN_MICRO)
        torch.cuda.synchronize()
        if s < steps_before:
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for e in events:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + dur

    def ms_of(key):
        return sum(t for n, t in by_name.items() if key in n) / 1e3
    gemm_us = sum(t for n, t in by_name.items() if "gemm" in n.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    del params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return {"wall_ms": wall * 1e3, "unprofiled_step_ms": step_ms[1:],
            "peak_memory_gb": peak_gb,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / (wall * 1e3),
            "device_ops": len(events), "gemm_ms": gemm_us / 1e3,
            "moe_ffn_ms": ms_of("moe_tf32_kernel") + ms_of("moe_wgmma_kernel"),
            "moe_ffn_bwd_ms": ms_of("moe_bwd_kernel") + ms_of("b16::"),
            "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]}


def main() -> int:
    args = sys.argv[1:]
    only = None
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1]
        del args[i:i + 2]
    label = args[0] if args else "tree"
    root = Path.cwd()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import registry
    if not torch.cuda.is_available():
        print("train_lines: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    for phase, name, layers, _ in cs.TRAIN_RUNS:
        if only and phase != only:
            continue
        cfg = registry()[name]
        if layers is not None:
            cfg = replace(cfg, n_layers=layers)
        line = {"label": label, "card": card, "phase": phase,
                "layers": cfg.n_layers, **profile_step(cfg)}
        print(json.dumps(line), flush=True)
    if only in (None, "bf16_train"):
        cfg = replace(registry()["olmoe_1b_7b"],
                      n_layers=cs.BF16_TRAIN_LAYERS)
        line = {"label": label, "card": card, "phase": "bf16_train",
                "layers": cfg.n_layers, "dtype": "bfloat16",
                **profile_step(cfg, steps_before=12, dtype=torch.bfloat16,
                               lr=cs.BF16_TRAIN_LR)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
