"""Both halves of the port's multi-device gates (``tests/test_torch_sharded.py``,
and for serving ``tests/test_torch_sharded_serve.py``).

``torch_ranks``: the port's sharded ``moe_apply`` (expert- and
tensor-parallel) and sharded train step, on a (2, 4) ``("data",
"model")`` DeviceMesh of 8 gloo processes on the CPU; rank 0 pickles the
whole tensors.  ``python tests/helpers/torch_sharded_gate.py jax OUT``:
the JAX references, in a process of its own that sees 8 placeholder XLA
devices (the rest of the suite must see one): JAX's sharded
``moe_apply`` on the same mesh and inputs, and the JAX package's
unsharded train step of every case on the same weights and batches.

Both rank functions record, in the context-mode cases (``CONTEXT``: 6
heads on 4 ``model`` ranks), each rank's query rows and first query
position in every attention call (``query_rows``), and
``torch_serve_ranks`` runs ``sdpa_sharded``'s context branch on a
sequence that ``model`` does not divide (``UNEVEN_S``) against the
unsharded ``sdpa``, values and gradients.

``torch_serve_ranks``: the port's ``prefill`` and ``decode_step`` with a
mesh (``SERVE_CASES``) on the same (2, 4) mesh, and one real step of
the dry run's (2, 4) train cell (``DRYRUN_TRAIN``) under
``CommDebugMode`` on rank 0; ``python tests/helpers/torch_sharded_gate.py
jax-serve OUT``: JAX's ``prefill``/``decode_step`` with ``mi`` on 8
placeholder devices on the same weights and tokens, and ``jax-dryrun
OUT``: JAX's dry-run lowering (specs, plan, ``memory_analysis()``,
``cost_analysis()``) of ``DRYRUN_CELLS`` on a (2, 4) mesh.

The training cases are ``tests/helpers/sharded_gate.py``'s seven.  Weights come
from the port's seeded ``init_params`` (the JAX side gets them stacked),
the MoE inputs from a numpy generator, the batches from ``SyntheticLM``,
whose bytes both packages share.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")

# 6 heads do not divide 4 model ranks: context-mode attention
CONTEXT = ("qwen3_4b", {"n_heads": 6, "n_kv_heads": 3, "d_model": 192})
TRAIN_CASES = [
    ("qwen3_4b", {}),                                        # megatron GQA
    CONTEXT,                                                 # context
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
SERVE_CASES = [
    ("qwen3_4b", {}),                                        # megatron
    ("gemma3_4b", {}),                           # local rings, tied, gemma
    ("olmoe_1b_7b", {"moe_capacity_factor": 8.0}),           # MoE EP
    ("mixtral_8x7b", {"n_experts": 2}),                      # MoE TP, rings
    ("mamba2_1_3b", {}),                                     # SSM
    ("zamba2_7b", {}),                                       # hybrid
    ("qwen3_4b", {"kv_cache_quant": True}),                  # int8 caches
    ("qwen3_4b", {"attn_q_chunk": 8}),                       # chunked prompt
    CONTEXT,                                                 # context
]
SERVE_B, SERVE_S, SERVE_NEW, SERVE_CACHE = 4, 24, 5, 40
UNEVEN_S = 22           # torch's chunks over 4 model ranks: 6, 6, 6, 4
# the dry run's cells at small shapes: (kind, arch, config changes,
# (name, seq_len, global_batch, kind))
DRYRUN_CELLS = {
    "train": ("olmoe_1b_7b", {}, ("train_s", 32, 8, "train")),
    "prefill": ("qwen3_4b", {}, ("prefill_s", 64, 4, "prefill")),
    "decode": ("gemma3_4b", {}, ("decode_s", 3584, 8, "decode")),
    "long_decode": ("zamba2_7b", {}, ("long_s", 3584, 1, "long_decode")),
}
DRYRUN_TRAIN = DRYRUN_CELLS["train"]


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


@contextlib.contextmanager
def query_rows(seen: list):
    """Append (local query rows, first query position, local keys) to
    ``seen`` for every attention call ``attention.sdpa_sharded`` makes on
    this rank while open."""
    from repro_torch.models import attention
    plain = attention.sdpa_sharded

    def spy(q, k, v, mi, attend):
        def recorded(ql, kl, vl, q_start):
            seen.append((ql.shape[1], q_start, kl.shape[1]))
            return attend(ql, kl, vl, q_start)
        return plain(q, k, v, mi, recorded)

    attention.sdpa_sharded = spy
    try:
        yield seen
    finally:
        attention.sdpa_sharded = plain


def by_model_rank(mi, seen: list) -> dict:
    """{model rank: its ``query_rows`` records}, gathered from every rank
    (each model rank's records from the first data rank that has them)."""
    import torch.distributed as dist
    mine = (mi.mesh.get_local_rank(mi.model_axis), seen)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out: dict = {}
    for m, recs in every:
        out.setdefault(m, recs)
    return out


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
        seen: list = []
        with query_rows(seen):
            params, opt, m = make_train_step(cfg, mi)(params, opt,
                                                      train_batch(cfg))
        if (arch, tweak) == CONTEXT:
            res["context_rows"] = by_model_rank(mi, seen)
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


def serve_tokens(cfg):
    """The prompts [SERVE_B, SERVE_S] and the decode's forced tokens
    [SERVE_NEW, SERVE_B, 1] (int32 numpy)."""
    rng = np.random.default_rng(11)
    return (rng.integers(0, cfg.vocab, (SERVE_B, SERVE_S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (SERVE_NEW, SERVE_B, 1))
            .astype(np.int32))


def shape_config(spec):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(*spec)


def torch_serve_ranks(rank: int, world: int, init: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = {"serve": _torch_serve(), "dryrun_train": _real_train_comms(),
               "uneven": _uneven_context()}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _torch_serve() -> dict:
    import torch

    from repro_torch import tree
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_info
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as sh
    mi = make_mesh_info(make_debug_mesh(*MESH, device_type="cpu"))
    host = lambda t: sh.full(t).detach().numpy()
    res = {}
    with torch.no_grad():
        for arch, tweak in SERVE_CASES:
            cfg = port_cfg(arch, tweak)
            prompts, forced = serve_tokens(cfg)
            ps = sh.distribute(T.init_params(cfg, seed=0, device="cpu"), mi,
                               sh.param_specs(cfg, mi))
            seen: list = []
            with query_rows(seen):
                lg, st = T.prefill(ps, cfg, torch.from_numpy(prompts),
                                   SERVE_CACHE, mi=mi)
            logits = [host(lg)]
            for tok in forced:
                lg, st = T.decode_step(ps, cfg, st, torch.from_numpy(tok),
                                       mi=mi)
                logits.append(host(lg))
            res[case_id(arch, tweak)] = {
                "logits": logits,
                "positions": host(st["positions"]),
                "placements": sorted({str(t.placements)
                                      for t in tree.leaves(st)}),
                "query_rows": by_model_rank(mi, seen)}
    return res


def _uneven_context() -> dict:
    """``sdpa_sharded``'s context branch (``sdpa`` as ``attend``, over the
    rank's rows of a causal bias) on B 4 x ``UNEVEN_S`` rows of 6 q / 3
    kv heads, against the unsharded ``sdpa`` on the same inputs: the
    largest differences of the output and of q's, k's and v's gradients
    (whole tensors), and each model rank's ``query_rows`` records."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_info
    from repro_torch.models import attention as A
    from repro_torch.parallel import sharding as sh
    mi = make_mesh_info(make_debug_mesh(*MESH, device_type="cpu"))
    rng = np.random.default_rng(13)
    shapes = {"q": (SERVE_B, UNEVEN_S, 6, 16), "k": (SERVE_B, UNEVEN_S, 3, 16),
              "v": (SERVE_B, UNEVEN_S, 3, 16)}
    whole = {n: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
             for n, s in shapes.items()}
    g_out = torch.from_numpy(rng.standard_normal(shapes["q"],
                                                 dtype=np.float32))
    pos = torch.arange(UNEVEN_S)[None]
    bias = A._mask_bias(pos, pos, None)

    def attend(q, k, v, q_start=0):
        return A.sdpa(q, k, v, bias[:, q_start:q_start + q.shape[1]])

    ref = {n: t.clone().requires_grad_(True) for n, t in whole.items()}
    want = attend(ref["q"], ref["k"], ref["v"])
    want.backward(g_out)
    dist_in = {n: sh.distribute(t, mi, (sh.data_entry(mi), mi.model_axis))
               .requires_grad_(True) for n, t in whole.items()}
    seen: list = []
    with query_rows(seen):
        got = A.sdpa_sharded(dist_in["q"], dist_in["k"], dist_in["v"], mi,
                             attend)
    got.backward(sh.distribute(g_out, mi, (sh.data_entry(mi),
                                           mi.model_axis)))
    err = {"out": float((sh.full(got) - want).detach().abs().max())}
    for n in whole:
        err["d" + n] = float((sh.full(dist_in[n].grad) - ref[n].grad)
                             .abs().max())
    return {"err": err, "query_rows": by_model_rank(mi, seen)}


def _real_train_comms() -> dict:
    """One step of the dry run's train cell on zeros (bf16 parameters,
    ZeRO moments, the cell's batch), the collectives ``CommDebugMode``
    sees on this rank."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.dryrun import train_args
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_info
    from repro_torch.launch.train import make_train_step
    arch, tweak, shape = DRYRUN_TRAIN
    cfg = port_cfg(arch, tweak)
    mi = make_mesh_info(make_debug_mesh(*MESH, device_type="cpu"))
    args = train_args(cfg, shape_config(shape), mi, device="cpu")
    comm = CommDebugMode()
    with comm:
        make_train_step(cfg, mi)(*args)
    return {str(k): v for k, v in comm.get_comm_counts().items()}


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


def _jax_env():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8"
                               ).strip()
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]


def _jax_params(cfg):
    """The port's seeded weights stacked in the JAX layout (numpy)."""
    import jax

    from repro_torch import tree
    from repro_torch.models import transformer as T
    p = T.init_params(cfg, seed=0, device="cpu")
    np_p = {k: tree.map_leaves(lambda t: t.numpy(), v)
            for k, v in p.items() if k != "layers"}
    np_p["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *[
        tree.map_leaves(lambda t: t.numpy(), lp) for lp in p["layers"]])
    return np_p


def jax_serve_main(out: str) -> None:
    _jax_env()
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch, smoke
    from repro.launch.mesh import make_debug_mesh, make_mesh_info
    from repro.models import transformer as JT
    assert jax.device_count() == 8, jax.devices()
    mi = make_mesh_info(make_debug_mesh(*MESH))
    res = {}
    for arch, tweak in SERVE_CASES:
        cfg = port_cfg(arch, tweak)
        jcfg = replace(smoke(get_arch(arch)), **tweak)
        jp = jax.tree.map(jnp.asarray, _jax_params(cfg))
        prompts, forced = serve_tokens(cfg)
        with jax.set_mesh(mi.mesh):
            pre = jax.jit(lambda p, t: JT.prefill(p, jcfg, {"tokens": t},
                                                  SERVE_CACHE, mi))
            step = jax.jit(lambda p, st, t: JT.decode_step(
                p, jcfg, st, {"tokens": t}, mi))
            lg, st = pre(jp, jnp.asarray(prompts))
            logits = [np.asarray(lg)]
            for tok in forced:
                lg, st = step(jp, st, jnp.asarray(tok))
                logits.append(np.asarray(lg))
        res[case_id(arch, tweak)] = {"logits": logits,
                                     "positions": np.asarray(
                                         st["positions"])}
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _norm_spec(spec, ndim: int) -> tuple:
    """A JAX PartitionSpec (or a port spec) as a tuple of ``ndim`` entries:
    None, an axis name, or a tuple of two or more names."""
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    return tuple(out + [None] * (ndim - len(out)))


def jax_dryrun_main(out: str) -> None:
    """JAX's dry-run lowering of ``DRYRUN_CELLS`` on a (2, 4) mesh of 8
    placeholder devices: the plan, every input's shape, dtype and spec,
    and the compiled module's memory and cost analyses (``lower_cell``'s
    code path, on the small configs)."""
    _jax_env()
    from dataclasses import replace

    import jax

    from repro.configs import ShapeConfig, get_arch, smoke
    from repro.launch import specs as JS
    from repro.launch.mesh import make_debug_mesh, make_mesh_info
    from repro.launch.train import init_opt_shardings, make_train_step
    from repro.models import transformer as JT
    from repro.optim import adamw
    mi = make_mesh_info(make_debug_mesh(*MESH))
    res = {}

    def described(structs, specs):
        flat, _ = jax.tree.flatten_with_path(structs)
        sflat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        return [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype),
                 _norm_spec(sp, len(v.shape)))
                for (k, v), sp in zip(flat, sflat)]

    for kind, (arch, tweak, spec) in DRYRUN_CELLS.items():
        cfg = replace(smoke(get_arch(arch)), **tweak)
        shape = ShapeConfig(*spec)
        pstructs = JS.param_struct(cfg)
        psh, pspecs = JS.param_shardings(cfg, mi)
        plan = JS.plan_microbatches(cfg, shape, mi)
        cell = {"plan": (plan.n_micro, plan.micro_batch, plan.cache_len),
                "params": described(pstructs, pspecs)}
        with jax.set_mesh(mi.mesh):
            if kind == "train":
                ostructs = jax.eval_shape(lambda: adamw.init(pstructs))
                bspecs, bsh = JS.train_input_specs(cfg, shape, mi,
                                                   force_n_micro=1)
                cell["inputs"] = described(bspecs, jax.tree.map(
                    lambda s: s.spec, bsh))
                lowered = jax.jit(
                    make_train_step(cfg, mi, unrolled=True),
                    in_shardings=(psh, init_opt_shardings(cfg, mi), bsh),
                    donate_argnums=(0, 1)).lower(pstructs, ostructs, bspecs)
            elif kind == "prefill":
                bspecs, bsh = JS.prefill_input_specs(cfg, shape, mi)
                cell["inputs"] = described(bspecs, jax.tree.map(
                    lambda s: s.spec, bsh))
                lowered = jax.jit(
                    lambda p, b: JT.prefill(p, cfg, b, plan.cache_len, mi,
                                            unrolled=True),
                    in_shardings=(psh, bsh)).lower(pstructs, bspecs)
            else:
                state, sspecs, ssh, tok, tsh = JS.decode_input_specs(
                    cfg, shape, mi)
                cell["state"] = described(state, sspecs)
                cell["inputs"] = described(tok, jax.tree.map(
                    lambda s: s.spec, tsh))
                lowered = jax.jit(
                    lambda p, st, b: JT.decode_step(p, cfg, st, b, mi),
                    in_shardings=(psh, ssh, tsh),
                    donate_argnums=(1,)).lower(pstructs, state, tok)
        compiled = lowered.compile()
        mem = compiled.memory_analysis()
        cell["memory"] = {a: int(getattr(mem, a)) for a in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes")}
        cell["flops"] = float((compiled.cost_analysis() or {}).get(
            "flops", 0.0))
        res[kind] = cell
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    modes = {"jax": jax_main, "jax-serve": jax_serve_main,
             "jax-dryrun": jax_dryrun_main}
    if len(sys.argv) != 3 or sys.argv[1] not in modes:
        raise SystemExit("usage: torch_sharded_gate.py "
                         "jax|jax-serve|jax-dryrun OUT.pkl")
    modes[sys.argv[1]](sys.argv[2])
