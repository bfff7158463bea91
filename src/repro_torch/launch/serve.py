"""Serving driver: batched requests through the paged tiering engine
(torch twin of ``repro.launch.serve``, with the same flags and printed
lines, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \
        --requests 8 --max-new 16                  # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke  # full width

The model is the arch's smoke size (its published size with
``--no-smoke``) in float32 with random weights from seed 0.  An MoE arch
(``--arch olmoe_1b_7b``) adds the JAX driver's expert-hotness line.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import get_arch, smoke
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import PagedServingEngine, ServeConfig


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--fast-slots", type=int, default=24)
    ap.add_argument("--tiers", type=int, choices=(2, 3), default=2,
                    help="2 = HBM->NVM; 3 = HBM->DRAM-sim->NVM demo")
    ap.add_argument("--dram-slots", type=int, default=16,
                    help="middle-tier capacity for --tiers 3")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--no-memos", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    if cfg.layout != "attn":
        raise SystemExit(f"{args.arch}: paged serving engine supports "
                         "attention-layout archs (dense/MoE)")
    params = T.init_params(cfg, seed=0, device=device)
    hier = None
    if args.tiers == 3:
        hier = MemoryHierarchy.three_tier(args.fast_slots, args.dram_slots,
                                          1024)
    eng = PagedServingEngine(cfg, params, ServeConfig(
        page_size=args.page_size, max_batch=args.max_batch,
        fast_slots=args.fast_slots, slow_slots=1024, hierarchy=hier,
        memos_enabled=not args.no_memos), device=device)

    rng = np.random.RandomState(0)
    reqs = [eng.submit(rng.randint(0, cfg.vocab,
                                   size=rng.randint(3, 14)).tolist(),
                       max_new=args.max_new)
            for _ in range(args.requests)]
    eng.run(max_steps=5000)
    eng.close()

    print(f"served {len(reqs)} requests in {eng.step_count} steps; "
          f"{eng.tokens_out} tokens generated")
    lats = [(r.finish_step or 0) - r.arrival for r in reqs]
    print(f"latency steps: mean {np.mean(lats):.1f} max {max(lats)}")
    st = eng.kv.store
    print(f"tier traffic: ->host {st.traffic[(0, 1)]}B  ->HBM "
          f"{st.traffic[(1, 0)]}B  migrations "
          f"{sum(r.migrations.migrated for r in eng.memos.reports)}")
    if eng.expert_counts is not None:
        c = eng.expert_counts
        print(f"expert hotness: top {np.argsort(-c)[:4].tolist()} "
              f"(counts {np.sort(c)[::-1][:4].tolist()}), "
              f"cold experts: {int((c == 0).sum())}/{len(c)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
