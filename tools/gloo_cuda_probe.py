"""Which collectives gloo carries for CUDA tensors on one card.

    python3 tools/gloo_cuda_probe.py

Each case runs in a fresh process that spawns 4 ranks on card 0 over a
gloo process group (rendezvous by a file under the system's temporary
directory) and makes one call: the c10d collectives (``dist.all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``broadcast``),
the functional collectives that DTensor issues (``_functional_collectives
.all_reduce``, ``all_gather_tensor``, ``reduce_scatter_tensor``), and
DTensor's own ``distribute_tensor``, a Shard -> Replicate gather and two
Partial reductions on a (2, 2) mesh.  One JSON line a case: its name, the
process's exit code, whether rank 0 finished and whether a rank died
of SIGSEGV; then
the card and its power limit.  This decides ``chip_smoke.py``'s
``SHARDED_BACKEND``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

CASES = ["c10d_all_reduce", "c10d_all_gather_into_tensor",
         "c10d_reduce_scatter_tensor", "c10d_broadcast",
         "functional_all_reduce", "functional_all_gather_tensor",
         "functional_reduce_scatter_tensor", "dtensor_distribute",
         "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
         "dtensor_partial_to_shard"]


def _rank(rank: int, world: int, init: str, case: str) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    x = torch.ones(8, 4, device="cuda") * (rank + 1)
    g = dist.group.WORLD
    mesh = (init_device_mesh("cuda", (2, 2), mesh_dim_names=("data",
                                                             "model"))
            if case.startswith("dtensor") else None)
    calls = {
        "c10d_all_reduce": lambda: dist.all_reduce(x.clone()),
        "c10d_all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, 4, device="cuda"), x),
        "c10d_reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, 4, device="cuda"), x),
        "c10d_broadcast": lambda: dist.broadcast(x.clone(), 0),
        "functional_all_reduce": lambda: fc.all_reduce(x, "sum", g).wait(),
        "functional_all_gather_tensor":
            lambda: fc.all_gather_tensor(x, 0, g).wait(),
        "functional_reduce_scatter_tensor":
            lambda: fc.reduce_scatter_tensor(x, "sum", 0, g).wait(),
        "dtensor_distribute":
            lambda: distribute_tensor(x, mesh, [Shard(0), Replicate()]),
        "dtensor_shard_to_replicate": lambda: distribute_tensor(
            x, mesh, [Shard(0), Shard(1)]).full_tensor(),
        "dtensor_partial_to_replicate": lambda: DTensor.from_local(
            x, mesh, [Partial(), Replicate()]).redistribute(
            mesh, [Replicate(), Replicate()]).to_local(),
        "dtensor_partial_to_shard": lambda: DTensor.from_local(
            x, mesh, [Partial(), Partial()]).redistribute(
            mesh, [Shard(0), Replicate()]).to_local(),
    }
    calls[case]()
    torch.cuda.synchronize()
    dist.barrier()
    if rank == 0:
        print("done", flush=True)
    dist.destroy_process_group()


def _one(case: str) -> None:
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(4, f"file://{d}/rdv", case), nprocs=4)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--case":
        _one(sys.argv[2])
        return 0
    for case in CASES:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--case", case], capture_output=True, text=True,
                           timeout=180)
        print(json.dumps({"case": case, "rc": r.returncode,
                          "rank0_done": "done" in r.stdout,
                          "sigsegv": "SIGSEGV" in r.stderr
                          or "Segmentation fault" in r.stderr}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
