"""The port's sharded train step on a mesh of several processes, each on
its own card (NCCL), or on the CPU (gloo) to rehearse.

Run from the root of a checkout (or of an unpacked archive of one):

    python3 tools/sharded_lines.py [LABEL] [--mesh 2x2] [--device cpu]

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
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    comm = CommDebugMode()
    t0 = time.perf_counter()
    with comm:
        ps, opt, m = step(ps, opt, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    got = [sh.full(p) for p in tree.leaves(ps)]
    if rank != 0:
        return {}
    rp, ro, rm = make_train_step(cfg)(params, adamw.init(params), batch)
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
            "collectives": {str(k): v for k, v in
                            comm.get_comm_counts().items()}}


def _ranks(rank: int, world: int, init: str, mesh: tuple[int, int],
           device: str, label: str, out: str) -> None:
    sys.path[:0] = [str(ROOT / "src")]
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_arch, smoke
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_info
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
        cases = [(f"{a}{''.join(f'-{k}{v}' for k, v in t.items())}",
                  replace(smoke(get_arch(a)), **t), SMOKE_SHAPE)
                 for a, t in SMOKE_CASES]
        if device == "cuda":
            cases += [(f"{a}-full-{n}layers",
                       replace(get_arch(a), n_layers=n), FULL_SHAPE)
                      for a, n in FULL_CASES]
        card = _card() if rank == 0 else None
        for name, cfg, shape in cases:
            line = _case(cfg, shape, mi, dev, rank)
            if rank == 0:
                line = {"label": label, "case": name, "card": card,
                        "mesh": list(mesh), "device": device, **line}
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
                               args.label, str(out)), nprocs=world)
        lines = [json.loads(x) for x in out.read_text().splitlines()]
    ok = all(x["loss_abs_diff"] <= 1e-5
             and x["param_max_abs_diff_where_g_ge_1e-6"] <= 2e-5
             and x["expert_counts_equal"] is not False for x in lines)
    print(json.dumps({"label": args.label, "cases": len(lines), "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
