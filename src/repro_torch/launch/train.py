"""Training on one device (torch twin of ``repro.launch.train``, with the
same flags and printed lines, plus ``--device``): gradient accumulation
over microbatches in float32, AdamW with global-norm clipping, and the
runnable training loop with checkpoint, restart and a simulated crash.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \
        --smoke --steps 40                          # the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \
        --smoke --steps 40 --device cpu

Every arch of the registry trains, MoE ones too (the default,
``olmoe_1b_7b``, as in the JAX launcher).  The step runs the plain
attention and SSD scan under autograd; the only kernels that launch
inside it are an MoE layer's: ``moe_ffn`` in the forward and its
recompute, and ``moe_ffn_bwd``, its hand-written float32 gradient, in
the backward.
"""
from __future__ import annotations

import argparse
from functools import partial

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ArchConfig, get_arch, smoke
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, cosine_with_warmup


def make_train_step(cfg: ArchConfig, *, lr_fn=None, clip_norm: float = 1.0,
                    weight_decay: float = 0.1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``.

    ``batch`` leaves (numpy arrays or tensors) have a leading
    ``[n_micro, micro_batch, ...]``.  Each microbatch's gradient is added
    into float32 sums that start at zero, as the JAX step's scan does;
    the sums are divided by ``n_micro`` and go to ``adamw.update`` at
    ``lr_fn(opt_state.step)``, read before the step count is incremented.
    Parameters and moments are updated in place (float32 parameters
    only) and returned.  The step's products are full float32: TF32 is
    off inside it, whatever the caller set.  Metrics: ``loss`` (the mean
    of the microbatches' cross-entropies), ``lr``, ``grad_norm`` (before
    clipping), as JAX's step returns them, and for an MoE arch
    ``moe_aux`` (the mean of the microbatches' load-balancing losses) and
    ``expert_counts`` (int32 [n_micro, E], each microbatch's histogram
    summed over the layers)."""
    T._check_supported(cfg)
    if lr_fn is None:
        lr_fn = lambda step: 3e-4

    def train_step(params, opt_state, batch):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return _step(params, opt_state, batch)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _step(params, opt_state, batch):
        leaves = tree.leaves(params)
        bad = [p.dtype for p in leaves if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"train_step trains float32 parameters, got "
                             f"{sorted(set(map(str, bad)))}")
        dev = leaves[0].device
        n_micro = next(iter(batch.values())).shape[0]
        was = [p.requires_grad for p in leaves]
        for p in leaves:
            p.grad = torch.zeros_like(p)
            p.requires_grad_(True)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        counts = []
        try:
            for i in range(n_micro):
                mb = {k: torch.as_tensor(v[i]).to(dev)
                      for k, v in batch.items()}
                total, metrics = T.loss_fn(params, cfg, mb)
                total.backward()
                loss_sum = loss_sum + metrics["ce_loss"].detach()
                if cfg.is_moe:
                    aux_sum = aux_sum + metrics["moe_aux"].detach()
                    counts.append(metrics["expert_counts"])
        finally:
            for p, w in zip(leaves, was):
                p.requires_grad_(w)
        grads = [p.grad for p in leaves]
        for p, g in zip(leaves, grads):
            p.grad = None
            g.div_(n_micro)
        lr = lr_fn(opt_state.step)
        params, opt_state, om = adamw.update(
            tree.unflatten(params, grads), opt_state, params, lr=lr,
            clip_norm=clip_norm, weight_decay=weight_decay)
        out = {"loss": loss_sum / n_micro, "lr": lr, **om}
        if cfg.is_moe:
            out["moe_aux"] = aux_sum / n_micro
            out["expert_counts"] = torch.stack(counts)
        return params, opt_state, out

    return train_step


def micro_batches(raw: dict, n_micro: int) -> dict:
    """A global batch's arrays [B, ...] as [n_micro, B / n_micro, ...]."""
    return {k: np.reshape(v, (n_micro, v.shape[0] // n_micro, *v.shape[1:]))
            for k, v in raw.items()}


def train_loop(cfg: ArchConfig, *, steps: int = 100, global_batch: int = 8,
               seq_len: int = 64, n_micro: int = 2, lr: float = 1e-3,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               seed: int = 0, log_every: int = 10, resume: bool = True,
               crash_at: int | None = None,
               device: str | torch.device | None = "cuda"):
    """Train ``cfg`` from seeded random weights on ``SyntheticLM`` data
    with a cosine schedule (warmup 10, peak ``lr``), checkpointing every
    ``ckpt_every`` steps into ``ckpt_dir`` and resuming from its newest
    checkpoint; ``crash_at`` raises ``RuntimeError`` after that step (once
    its checkpoint is written).  Returns (losses of the steps run, params,
    opt state)."""
    dev = resolve_device(device)
    source = SyntheticLM(cfg.vocab, seq_len, global_batch, seed=seed,
                         input_mode=cfg.input_mode, d_model=cfg.d_model)
    step_fn = make_train_step(cfg, lr_fn=partial(
        cosine_with_warmup, peak_lr=lr, warmup=10, total=steps))
    params = T.init_params(cfg, seed=seed, device=dev)
    opt = adamw.init(params)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        (params, opt), start, _ = ckpt.restore((params, opt))
        start = int(start)

    losses = []
    for step in range(start, steps):
        batch = micro_batches(source.batch(step), n_micro)
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if log_every and step % log_every == 0:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}")
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, (params, opt))
        if crash_at is not None and step + 1 == crash_at:
            if ckpt:
                ckpt.wait()
            raise RuntimeError(f"simulated crash at step {step + 1}")
    if ckpt:
        ckpt.save(steps, (params, opt), block=True)
    return losses, params, opt


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe_1b_7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    losses, _, _ = train_loop(cfg, steps=args.steps,
                              global_batch=args.batch, seq_len=args.seq,
                              ckpt_dir=args.ckpt, device=device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
