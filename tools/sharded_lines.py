"""The port's sharded train step, and its sharded ``prefill`` +
``decode_step``, on a mesh of several processes, each on its own card
(NCCL), or on the CPU (gloo) to rehearse.

Run from the root of a checkout (or of an unpacked archive of one):

    python3 tools/sharded_lines.py [LABEL] [--mesh 2x2] [--device cpu]
                                   [--only train|serve|context]

It spawns data x model processes that form a ``("data", "model")``
DeviceMesh (rendezvous by a file under the system's temporary
directory), rank r on card r.  Each case draws seeded weights, lays them
out by ``param_specs`` and takes one step of ``make_train_step(cfg, mi)``
(timed after one warm-up step on another copy of the weights); rank 0
takes the unsharded step on the same weights and batch on its own card
and compares.  The cases: the seven of ``tests/helpers/sharded_gate.py``
at smoke width, then (on cards) olmoe_1b_7b and qwen3_4b at full width
cut to 2 layers (batch 4, seq 512, 2 microbatches).  One JSON line a
case: LABEL, the card and its power limit, the mesh, the loss and its
distance from the unsharded step's, the largest parameter distance where
the unsharded step's |g| >= 1e-6, whether the expert counts are equal,
the timed step's ms (rank 0's wall clock), the peak device GB of each
rank, and the collectives ``CommDebugMode`` counted in the timed step.
Exit 1 when a case misses C2's gates (loss 1e-5, parameters 2e-5).

The serving cases (``SERVE_SMOKE``: the eight of
``tests/test_torch_sharded_serve.py`` at smoke width; on cards
``SERVE_FULL``, full width in float32 cut to a few layers): seeded
weights laid out by ``param_specs``, ``prefill`` of seeded prompts into
a cache whose slots are split over ``model``, then forced decode tokens,
every step's logits gathered; rank 0 runs the unsharded path on the same
weights and tokens on its own card.  One JSON line a case: the largest
logit distance over the steps relative to the largest unsharded logit
(held within 1e-4), whether every step's argmax agrees, the sharded
prefill's and decode's ms (rank 0's wall clock, after a warm-up run) and
the unsharded ones'.

``--only context`` runs the context-mode cases alone (``CONTEXT_FULL``:
qwen2.5 and gemma3, whose 40 and 8 heads do not divide 3, at full width
in float32 cut to 2 layers, on a (1, 3) mesh of three cards; on the CPU
their smoke widths): each arch's train step (``CONTEXT_TRAIN_SHAPE``)
and its prefill + decode (``CONTEXT_SERVE_SHAPE``) against the unsharded
path on rank 0's card, under the gates above.  Each line then also has
the unsharded run's ms and peak GB, and the serving lines the peak GB of
each rank.  Run from the root of another tree (``cd parent; python3
../tools/sharded_lines.py``), it measures that tree's code.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path.cwd()
SMOKE_CASES = [
    ("qwen3_4b", {}), ("qwen3_4b", {"n_heads": 6, "n_kv_heads": 3,
                                    "d_model": 192}),
    ("olmoe_1b_7b", {"moe_capacity_factor": 8.0}),
    ("mixtral_8x7b", {"n_experts": 2}), ("mamba2_1_3b", {}),
    ("zamba2_7b", {}), ("gemma3_4b", {})]
FULL_CASES = [("olmoe_1b_7b", 2), ("qwen3_4b", 2)]
SMOKE_SHAPE, FULL_SHAPE = (4, 16, 2), (4, 512, 2)   # batch, seq, micro
SERVE_SMOKE = [
    ("qwen3_4b", {}), ("gemma3_4b", {}),
    ("olmoe_1b_7b", {"moe_capacity_factor": 8.0}),
    ("mixtral_8x7b", {"n_experts": 2}), ("mamba2_1_3b", {}),
    ("zamba2_7b", {}), ("qwen3_4b", {"kv_cache_quant": True}),
    ("qwen3_4b", {"attn_q_chunk": 8})]
# full width cut to a few layers; olmoe at capacity 8.0, where no
# expert-parallel slot is dropped (at its 1.25 the prompt's busiest shard
# drops rows, which the unsharded path never does: GShard's semantics)
SERVE_FULL = [("qwen3_4b", 4, {}), ("gemma3_4b", 6, {}),
              ("olmoe_1b_7b", 4, {"moe_capacity_factor": 8.0}),
              ("zamba2_7b", 6, {})]
# batch, prompt, forced decode tokens, cache slots
SERVE_SMOKE_SHAPE, SERVE_FULL_SHAPE = (4, 24, 5, 40), (2, 512, 16, 544)
SERVE_REL = 1e-4
# context mode: heads that do not divide the model axis of a (1, 3) mesh
CONTEXT_FULL = [("qwen2_5_14b", 2), ("gemma3_4b", 2)]
CONTEXT_TRAIN_SHAPE = (2, 3072, 2)            # batch, seq, micro
CONTEXT_SERVE_SHAPE = (1, 3072, 4, 3076)      # batch, prompt, new, cache


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError):
        return "no card"


def _case(cfg, shape, mi, dev, rank) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_train_step, micro_batches
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    B, S, n_micro = shape
    params = init_params(cfg, seed=0, device=dev)
    batch = micro_batches(SyntheticLM(cfg.vocab, S, B, seed=5, input_mode=
                                      cfg.input_mode, d_model=cfg.d_model)
                          .batch(0), n_micro)
    step = make_train_step(cfg, mi)
    warm = sh.distribute(params, mi, sh.param_specs(cfg, mi))
    step(warm, adamw.init(warm), batch)
    del warm
    ps = sh.distribute(params, mi, sh.param_specs(cfg, mi))
    opt = adamw.init(ps)
    _reset_peak(dev)
    dist.barrier()
    comm = CommDebugMode()
    t0 = time.perf_counter()
    with comm:
        ps, opt, m = step(ps, opt, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, _peak_gb(dev))
    got = [sh.full(p) for p in tree.leaves(ps)]
    if rank != 0:
        return {}
    del ps, opt
    ref_step = make_train_step(cfg)
    warm = tree.map_leaves(torch.clone, params)
    ref_step(warm, adamw.init(warm), batch)                  # warm-up
    del warm
    ref_opt = adamw.init(params)
    _reset_peak(dev)
    t0 = time.perf_counter()
    rp, ro, rm = ref_step(params, ref_opt, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    ref_peak = _peak_gb(dev)
    worst = 0.0
    for a, b, mo in zip(got, tree.leaves(rp), tree.leaves(ro.m)):
        big = (mo.abs() / 0.1) >= 1e-6                 # m = 0.1 g
        if bool(big.any()):
            worst = max(worst, float((a - b).abs()[big].max()))
    return {"loss": float(m["loss"]),
            "loss_abs_diff": abs(float(m["loss"]) - float(rm["loss"])),
            "param_max_abs_diff_where_g_ge_1e-6": worst,
            "expert_counts_equal": (torch.equal(m["expert_counts"],
                                                rm["expert_counts"])
                                    if cfg.is_moe else None),
            "step_ms": ms, "peak_gb_per_rank": peaks,
            "unsharded_step_ms": ref_ms, "unsharded_peak_gb": ref_peak,
            "collectives": {str(k): v for k, v in
                            comm.get_comm_counts().items()}}


def _reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(dev):
    import torch
    return (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else None)


def _serve(cfg, params, prompts, forced, cache, mi=None):
    """Prefill, then one decode step per forced token: every step's whole
    logits, the prefill's and the decode's wall ms."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as sh
    sync = (torch.cuda.synchronize if prompts.device.type == "cuda"
            else lambda: None)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        lg, st = T.prefill(params, cfg, prompts, cache, mi=mi)
        logits = [sh.full(lg)]
        sync()
        t1 = time.perf_counter()
        for tok in forced:
            lg, st = T.decode_step(params, cfg, st, tok, mi=mi)
            logits.append(sh.full(lg))
        sync()
        t2 = time.perf_counter()
    return logits, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _serve_case(cfg, shape, mi, dev, rank) -> dict:
    import numpy as np
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import sharding as sh
    B, S, new, cache = shape
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(11)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(dev)
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (new, B, 1)).astype(
        np.int32)).to(dev)
    import torch.distributed as dist
    ps = sh.distribute(params, mi, sh.param_specs(cfg, mi))
    _serve(cfg, ps, prompts, forced[:1], cache, mi)          # warm-up
    _reset_peak(dev)
    got, pre_ms, dec_ms = _serve(cfg, ps, prompts, forced, cache, mi)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, _peak_gb(dev))
    if rank != 0:
        return {}
    del ps
    _serve(cfg, params, prompts, forced[:1], cache)
    _reset_peak(dev)
    want, ref_pre, ref_dec = _serve(cfg, params, prompts, forced, cache)
    V = cfg.vocab
    rel = max(float((a - b)[..., :V].abs().max() / b[..., :V].abs().max())
              for a, b in zip(got, want))
    agree = all(bool(torch.equal(a[..., :V].argmax(-1),
                                 b[..., :V].argmax(-1)))
                for a, b in zip(got, want))
    return {"kind": "serve", "batch": B, "prompt": S, "decode_steps": new,
            "cache": cache, "logit_max_rel": rel, "argmax_equal": agree,
            "prefill_ms": pre_ms, "decode_ms": dec_ms,
            "unsharded_prefill_ms": ref_pre, "unsharded_decode_ms": ref_dec,
            "peak_gb_per_rank": peaks, "unsharded_peak_gb": _peak_gb(dev)}


def _ranks(rank: int, world: int, init: str, mesh: tuple[int, int],
           device: str, label: str, out: str, only: str = "") -> None:
    sys.path[:0] = [str(ROOT / "src")]
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_arch, smoke
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_info
    from repro_torch.parallel.sharding import attn_mode
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world)
    lines = []
    try:
        mi = make_mesh_info(make_debug_mesh(*mesh, device_type=device))
        name = lambda a, t: f"{a}{''.join(f'-{k}{v}' for k, v in t.items())}"
        cases = []
        if only == "context":
            for a, n in CONTEXT_FULL:
                cfg = (replace(get_arch(a), n_layers=n) if device == "cuda"
                       else replace(smoke(get_arch(a)), n_layers=n))
                cases += [(f"context-{a}-{n}layers", cfg,
                           CONTEXT_TRAIN_SHAPE if device == "cuda"
                           else SMOKE_SHAPE, _case),
                          (f"context-serve-{a}-{n}layers", cfg,
                           CONTEXT_SERVE_SHAPE if device == "cuda"
                           else SERVE_SMOKE_SHAPE, _serve_case)]
        elif only != "serve":
            cases += [(name(a, t), replace(smoke(get_arch(a)), **t),
                       SMOKE_SHAPE, _case) for a, t in SMOKE_CASES]
            if device == "cuda":
                cases += [(f"{a}-full-{n}layers",
                           replace(get_arch(a), n_layers=n), FULL_SHAPE,
                           _case) for a, n in FULL_CASES]
        if only not in ("train", "context"):
            cases += [(f"serve-{name(a, t)}", replace(smoke(get_arch(a)),
                                                      **t),
                       SERVE_SMOKE_SHAPE, _serve_case)
                      for a, t in SERVE_SMOKE]
            if device == "cuda":
                cases += [(f"serve-{name(a, t)}-full-{n}layers",
                           replace(get_arch(a), n_layers=n, **t),
                           SERVE_FULL_SHAPE, _serve_case)
                          for a, n, t in SERVE_FULL]
        card = _card() if rank == 0 else None
        for name, cfg, shape, run in cases:
            line = run(cfg, shape, mi, dev, rank)
            if rank == 0:
                line = {"label": label, "case": name, "card": card,
                        "mesh": list(mesh), "device": device,
                        "attn_mode": attn_mode(cfg, mi), **line}
                print(json.dumps(line), flush=True)
                lines.append(line)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(out).write_text("".join(json.dumps(x) + "\n" for x in lines))


def main(argv: list[str]) -> int:
    import argparse

    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser()
    ap.add_argument("label", nargs="?", default="run")
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--only", default="",
                    choices=("", "train", "serve", "context"))
    args = ap.parse_args(argv)
    mesh = tuple(int(x) for x in args.mesh.split("x"))
    world = mesh[0] * mesh[1]
    if args.device == "cuda":        # one build, before the ranks load it
        sys.path[:0] = [str(ROOT / "src")]
        from repro_torch.kernels import _build
        _build.library()
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "lines.jsonl"
        mp.spawn(_ranks, args=(world, f"file://{d}/rdv", mesh, args.device,
                               args.label, str(out), args.only),
                 nprocs=world)
        lines = [json.loads(x) for x in out.read_text().splitlines()]
    ok = all((x["logit_max_rel"] <= SERVE_REL and x["argmax_equal"])
             if x.get("kind") == "serve" else
             (x["loss_abs_diff"] <= 1e-5
              and x["param_max_abs_diff_where_g_ge_1e-6"] <= 2e-5
              and x["expert_counts_equal"] is not False) for x in lines)
    print(json.dumps({"label": args.label, "cases": len(lines), "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
