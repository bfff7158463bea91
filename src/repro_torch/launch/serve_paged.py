"""Serve a small model with batched requests through the paged engine
(torch twin of ``examples/serve_paged.py``, with the same printed lines):
continuous batching, memos HBM<->host KV-page tiering, preemption under
HBM pressure, and exact greedy decoding.

The model is smoke-size qwen3_4b in float32 with random weights from
seed 0:

    PYTHONPATH=src python -m repro_torch.launch.serve_paged               # the card
    PYTHONPATH=src python -m repro_torch.launch.serve_paged --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import registry, smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import PagedServingEngine, ServeConfig


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke(registry()["qwen3_4b"])
    params = T.init_params(cfg, seed=0, device=device)

    engine = PagedServingEngine(cfg, params, ServeConfig(
        page_size=8, max_batch=3, fast_slots=16, slow_slots=256,
        memos_interval=6), device=device)

    rng = np.random.RandomState(0)
    reqs = [engine.submit(rng.randint(0, cfg.vocab, size=n).tolist(),
                          max_new=8)
            for n in (5, 9, 3, 12, 7, 4)]

    engine.run(max_steps=400)
    engine.close()

    print(f"served {len(reqs)} requests in {engine.step_count} steps "
          f"({engine.tokens_out} new tokens)")
    for r in reqs:
        lat = (r.finish_step or 0) - r.arrival
        print(f"  req {r.rid}: prompt={len(r.prompt):>2} -> {r.generated} "
              f"(latency {lat} steps)")

    st = engine.kv.store
    print(f"\nKV traffic: HBM->host {st.traffic[(0, 1)]}B, "
          f"host->HBM {st.traffic[(1, 0)]}B")
    print(f"memos passes: {len(engine.memos.reports)}, migrations: "
          f"{sum(r.migrations.migrated for r in engine.memos.reports)}")
    occ = engine.kv.occupancy()
    print(f"final pool occupancy: {occ}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
