"""End-to-end MoE training driver (torch twin of
``examples/train_moe_tiered.py``, with its flags and printed lines, plus
``--device``): train an OLMoE-family MoE for a few hundred steps with
checkpoint/restart and a simulated mid-run crash and recovery; the
router's expert counts are the MoE half of memos' hotness signal.

    PYTHONPATH=src python -m repro_torch.launch.train_moe_tiered          # the card
    PYTHONPATH=src python -m repro_torch.launch.train_moe_tiered --device cpu

The default is smoke olmoe_1b_7b, 200 steps, crashing at step 100 and
resuming from its checkpoint there; ``--big`` takes the example's ~100M
parameter variant.  The run fails unless the last loss is below 5.0.
"""
from __future__ import annotations

import argparse
import tempfile
from dataclasses import replace

import torch

from repro_torch.configs.base import ArchConfig, get_arch, smoke
from repro_torch.device import resolve_device
from repro_torch.launch.train import train_loop

TARGET_LOSS = 5.0


def config(big: bool = False) -> ArchConfig:
    """Smoke olmoe_1b_7b, or with ``big`` the example's ~100M parameter
    variant (d_model 512, 8 layers, 16 experts of 512, top 4)."""
    cfg = smoke(get_arch("olmoe_1b_7b"))
    if big:
        cfg = replace(cfg, d_model=512, n_layers=8, n_experts=16, top_k=4,
                      expert_d_ff=512, d_ff=512, vocab=8192, d_head=64,
                      n_heads=8, n_kv_heads=8)
    return cfg


def run(cfg: ArchConfig, *, steps: int, device: torch.device,
        ckpt_dir: str, ckpt_every: int = 25):
    """Train ``cfg`` for ``steps`` steps (global batch 8, seq 64) with a
    simulated crash at ``steps // 2``, then restart from the newest
    checkpoint in ``ckpt_dir`` and finish.  Returns the restarted run's
    (losses, params, opt state)."""
    crash_at = steps // 2
    print(f"=== training with a simulated crash at step {crash_at} ===")
    try:
        train_loop(cfg, steps=steps, global_batch=8, seq_len=64,
                   ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                   crash_at=crash_at, device=device)
    except RuntimeError as e:
        print(f"!! {e} — restarting from the latest checkpoint")
    losses, params, opt = train_loop(cfg, steps=steps, global_batch=8,
                                     seq_len=64, ckpt_dir=ckpt_dir,
                                     ckpt_every=ckpt_every, device=device)
    print(f"\nrecovered + finished: loss {losses[0 if losses else 0]:.4f} "
          f"... {losses[-1]:.4f}")
    return losses, params, opt


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true",
                    help="~100M params (slower); default is the smoke config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        losses, _, _ = run(config(args.big), steps=args.steps, device=device,
                           ckpt_dir=ckpt_dir)
    if not losses[-1] < TARGET_LOSS:
        raise SystemExit("training failed to learn the synthetic task")
    print("loss decreased on the synthetic Markov task ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
