"""Both halves of the port's multi-device gate (``tests/test_torch_sharded.py``).

``torch_ranks``: the port's sharded ``moe_apply`` (expert- and
tensor-parallel) and sharded train step, on a (2, 4) ``("data",
"model")`` DeviceMesh of 8 gloo processes on the CPU; rank 0 pickles the
whole tensors.  ``python tests/helpers/torch_sharded_gate.py jax OUT``:
the JAX references, in a process of its own that sees 8 placeholder XLA
devices (the rest of the suite must see one): JAX's sharded
``moe_apply`` on the same mesh and inputs, and the JAX package's
unsharded train step of every case on the same weights and batches.

The cases are ``tests/helpers/sharded_gate.py``'s seven.  Weights come
from the port's seeded ``init_params`` (the JAX side gets them stacked),
the MoE inputs from a numpy generator, the batches from ``SyntheticLM``,
whose bytes both packages share.
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")

TRAIN_CASES = [
    ("qwen3_4b", {}),                                        # megatron GQA
    ("qwen3_4b", {"n_heads": 6, "n_kv_heads": 3, "d_model": 192}),  # context
    ("olmoe_1b_7b", {"moe_capacity_factor": 8.0}),           # MoE EP
    ("mixtral_8x7b", {"n_experts": 2}),                      # MoE TP
    ("mamba2_1_3b", {}),                                     # SSM
    ("zamba2_7b", {}),                                       # hybrid
    ("gemma3_4b", {}),                                       # local/global, tied
]
MOE_CASES = {"ep": ("olmoe_1b_7b", {"moe_capacity_factor": 1.25}),
             "tp": ("mixtral_8x7b", {"n_experts": 2})}
MESH = (2, 4)
B, S, N_MICRO = 4, 16, 2


def case_id(arch: str, tweak: dict) -> str:
    return arch + "".join(f"-{k}{v}" for k, v in sorted(tweak.items()))


def port_cfg(arch: str, tweak: dict):
    from dataclasses import replace

    from repro_torch.configs.base import get_arch, smoke
    return replace(smoke(get_arch(arch)), **tweak)


def train_batch(cfg) -> dict:
    """The global batch as [N_MICRO, B / N_MICRO, ...] numpy arrays."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import micro_batches
    src = SyntheticLM(cfg.vocab, S, B, seed=5, input_mode=cfg.input_mode,
                      d_model=cfg.d_model)
    return micro_batches(src.batch(0), N_MICRO)


def moe_inputs(cfg, seed: int = 7):
    """x [B, S, d] and the MoE weights (float32 numpy), with the init
    scales; the router favours the first two experts (one EP shard's), so
    that shard's slots overflow a capacity of 1.25."""
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff or cfg.d_ff
    s = d ** -0.5
    x = rng.standard_normal((B, S, d), dtype=np.float32)
    w = {"w_router": rng.standard_normal((d, E), dtype=np.float32) * s,
         "w_gate": rng.standard_normal((E, d, ff), dtype=np.float32) * s,
         "w_up": rng.standard_normal((E, d, ff), dtype=np.float32) * s,
         "w_down": rng.standard_normal((E, ff, d), dtype=np.float32) * s}
    w["w_router"][:, :2] *= 3.0
    return x, w


# --- the port, 8 gloo ranks --------------------------------------------------------

def torch_ranks(rank: int, world: int, init: str, out: str,
                ckpt_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = _torch_gate(rank)
        res["restore"] = _restore_check(rank, ckpt_dir)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _torch_gate(rank: int) -> dict:
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_info
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    mi = make_mesh_info(make_debug_mesh(*MESH, device_type="cpu"))
    host = lambda t: sh.full(t).detach().numpy()
    res: dict = {"moe": {}, "train": {}}
    for name, (arch, tweak) in MOE_CASES.items():
        cfg = port_cfg(arch, tweak)
        x, w = moe_inputs(cfg)
        spec = sh.param_specs(cfg, mi)["layers"][0]["moe"]
        p = sh.distribute({k: torch.from_numpy(v) for k, v in w.items()},
                          mi, spec)
        with implicit_replication():
            y, probs, idx, counts = moe.moe_apply(
                torch.from_numpy(x), p, top_k=cfg.top_k, mi=mi,
                capacity_factor=cfg.moe_capacity_factor,
                softmax_before_topk=cfg.softmax_before_topk)
        res["moe"][name] = {"y": host(y), "probs": host(probs),
                            "idx": host(idx), "counts": counts.numpy()}
    for arch, tweak in TRAIN_CASES:
        cfg = port_cfg(arch, tweak)
        params = sh.distribute(T.init_params(cfg, seed=0, device="cpu"), mi,
                               sh.param_specs(cfg, mi))
        opt = adamw.init(params)
        params, opt, m = make_train_step(cfg, mi)(params, opt,
                                                  train_batch(cfg))
        out = {"params": [host(p) for p in tree.leaves(params)],
               "m": [host(t) for t in tree.leaves(opt.m)],
               "names": tree.flatten_with_names(params)[0],
               "step": int(opt.step),
               "placements": [str(t.placements) for t in tree.leaves(opt.m)],
               **{k: v.numpy() if isinstance(v, torch.Tensor) else v
                  for k, v in m.items()}}
        res["train"][case_id(arch, tweak)] = out
    return res


def _restore_check(rank: int, ckpt_dir: str):
    """Save a ZeRO-laid-out smoke olmoe tree from the (2, 4) mesh and
    restore it onto the mesh ``plan_elastic_remesh`` plans after losing 4
    chips, on its ranks, in that mesh's ZeRO placements.  Rank 0 returns
    (the new mesh shape, the step, whether every whole tensor came back
    equal, the placements seen)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer, plan_elastic_remesh
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_info
    from repro_torch.launch.train import _zero_placements
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as sh
    cfg = port_cfg("olmoe_1b_7b", {})
    mi = make_mesh_info(make_debug_mesh(*MESH, device_type="cpu"))
    full = T.init_params(cfg, seed=3, device="cpu")
    state = tree.unflatten(full, [
        sh.distribute(t, mi, ()).redistribute(mi.mesh, z)
        for t, z in zip(tree.leaves(full), _zero_placements(cfg, mi, full))])
    ck = Checkpointer(ckpt_dir)
    ck.save(7, state, block=True)
    dist.barrier()
    plan = plan_elastic_remesh(MESH, ("data", "model"), lost_chips=4)
    small = DeviceMesh("cpu", torch.arange(plan.chips_after).reshape(
        plan.new_shape), mesh_dim_names=plan.axes)
    result = None
    if rank < plan.chips_after:
        smi = make_mesh_info(small)
        lay = tree.unflatten(full, [
            (small, p) for p in _zero_placements(cfg, smi, full)])
        back, step, _ = ck.restore(full, shardings=lay)
        whole = [sh.full(t) for t in tree.leaves(back)]
        result = (plan.new_shape, step,
                  all(torch.equal(a, b)
                      for a, b in zip(whole, tree.leaves(full))),
                  sorted({str(t.placements) for t in tree.leaves(back)}))
    dist.barrier()
    return result


# --- the JAX package ------------------------------------------------------------------

def jax_main(out: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8"
                               ).strip()
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]
    from functools import partial

    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch, smoke
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.train import make_train_step
    from repro.models import moe as jmoe
    from repro.models import transformer as JT
    from repro.optim import adamw
    from repro_torch import tree
    from repro_torch.models import transformer as T
    from dataclasses import replace
    assert jax.device_count() == 8, jax.devices()
    res: dict = {"moe": {}, "train": {}}
    mesh = make_debug_mesh(*MESH)
    for name, (arch, tweak) in MOE_CASES.items():
        jcfg = replace(smoke(get_arch(arch)), **tweak)
        x, w = moe_inputs(jcfg)
        fn = jax.jit(partial(
            jmoe.moe_apply, top_k=jcfg.top_k, mesh=mesh, dp_axes=("data",),
            model_axis="model", capacity_factor=jcfg.moe_capacity_factor,
            softmax_before_topk=jcfg.softmax_before_topk))
        y, (probs, idx, counts) = fn(jnp.asarray(x), jmoe.MoEParams(
            **{k: jnp.asarray(v) for k, v in w.items()}))
        res["moe"][name] = {"y": np.asarray(y), "probs": np.asarray(probs),
                            "idx": np.asarray(idx),
                            "counts": np.asarray(counts)}
    for arch, tweak in TRAIN_CASES:
        cfg = port_cfg(arch, tweak)
        jcfg = replace(smoke(get_arch(arch)), **tweak)
        p = T.init_params(cfg, seed=0, device="cpu")
        np_p = {k: tree.map_leaves(lambda t: t.numpy(), v)
                for k, v in p.items() if k != "layers"}
        np_p["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *[
            tree.map_leaves(lambda t: t.numpy(), lp) for lp in p["layers"]])
        jp = jax.tree.map(jnp.asarray, np_p)
        batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
        step = make_train_step(jcfg, None)

        def step_and_counts(q, o, b):
            # the step returns no counts: each microbatch's, beside it
            counts = None
            if jcfg.is_moe:
                counts = jnp.stack([JT.forward_hidden(
                    q, jcfg, {"tokens": b["tokens"][i]})[1]["expert_counts"]
                    for i in range(N_MICRO)])
            return step(q, o, b), counts

        (new, opt, m), counts = jax.jit(step_and_counts)(
            jp, adamw.init(jp), batch)
        res["train"][case_id(arch, tweak)] = {
            "params": jax.tree.map(np.asarray, new),
            "m": jax.tree.map(np.asarray, opt.m),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "expert_counts": None if counts is None else np.asarray(counts)}
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    if sys.argv[1:2] != ["jax"] or len(sys.argv) != 3:
        raise SystemExit("usage: torch_sharded_gate.py jax OUT.pkl")
    jax_main(sys.argv[2])
