"""Multi-pod dry run (torch twin of ``repro.launch.dryrun``): trace every
(arch x shape x mesh) cell on 256 or 512 ranks of torch's ``fake``
process-group backend over meta tensors, and record per rank what the
JAX dry run reads from XLA's compiled module: memory, operations and
collective traffic.

    python -m repro_torch.launch.dryrun --arch olmoe_1b_7b --shape train_4k \
        [--multi-pod] [--analysis] [--out results.json]
    python -m repro_torch.launch.dryrun --all [--multi-pod]

Nothing is computed and no device is touched (the JAX dry run compiled
for placeholder host devices; here this process is rank 0 of a fake
world).  Each cell runs the port's own entry point once on DTensors of
meta shards: ``make_train_step(cfg, mi)`` for ``train_4k``,
``transformer.prefill(..., mi=)`` for ``prefill_32k``,
``transformer.decode_step(..., mi=)`` for the decode shapes, with the
inputs of ``launch.specs``.  A ``TorchDispatchMode`` below DTensor (it
declines DTensor calls, so it sees the local ops DTensor issues, and
skips the fake tensors of DTensor's own shape propagation) records:

  * ``memory``: ``argument_size_in_bytes`` (the rank's shards of the
    inputs), ``output_size_in_bytes``, ``alias_size_in_bytes`` (outputs
    that are inputs updated in place: the train step's parameters and
    moments, the decode step's caches), ``temp_size_in_bytes`` (the peak
    of live storages the trace made, outputs excluded, followed through
    each meta storage's lifetime) and ``peak_size_in_bytes`` (arguments
    plus that peak, outputs included);
  * ``cost.flops``: the operations of the local ops (``torch.utils.
    flop_counter``'s formulas on local shapes) plus the hand-written
    kernels' (``kernels.meta_flops()``: K8, K9, ``moe_ffn``, which take
    meta tensors and count from their shapes);
  * ``collectives``: the functional collectives the trace issued, with
    JAX's ring multipliers (all-reduce 2x out, all-gather out,
    reduce-scatter in, all-to-all in).

Flags as JAX's.  ``--analysis`` traces one microbatch and records
``analysis_scale`` = the plan's microbatches (torch always runs every
layer, so the non-analysis trace runs every microbatch); ``--unstack``
is accepted (the port's layers are a list already); ``--save-hlo`` has
no torch counterpart and raises.  JAX's ``parse_op_bytes`` measures an
artifact of XLA's CPU backend and has no twin.  Results go to
``dryrun_torch_out/``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from dataclasses import replace
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels, tree
from repro_torch.configs.base import SHAPES, cells, get_arch
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (fake_world, make_mesh_info,
                                     make_production_mesh)
from repro_torch.parallel import sharding as sh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_torch_out"
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
_COLLECTIVE = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "reduce_scatter": "reduce-scatter",
               "all_to_all": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(leaves) -> int:
    """Bytes of the rank's shards of ``leaves`` (DTensors or tensors)."""
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in leaves if isinstance(t, torch.Tensor))


def _storages(leaves) -> set:
    from torch.distributed.tensor import DTensor
    out = set()
    for t in leaves:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            out.add(t.untyped_storage()._cdata)
    return out


class Trace(TorchDispatchMode):
    """Records the local ops of a trace: operations (flop-counter
    formulas), functional collectives by kind (count and ring bytes), and
    the live bytes of the storages the ops make, with their peak."""

    def __init__(self, known: set = frozenset()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.known = set(known)
        self.flops = 0.0
        self.counts = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)
        self.ops: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self._sizes:
            return
        self._sizes[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it on local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if any(isinstance(o, FakeTensor) for o in flat):
            return out                     # DTensor's shape propagation
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += self._formulas[packet](*args, **kwargs,
                                                 out_val=out)
        name = str(packet)
        if name.startswith("_c10d_functional."):
            op = name.split(".", 1)[1]
            kind = next((k for p, k in _COLLECTIVE.items()
                         if op.startswith(p)), None)
            if kind is not None:
                self.ops[name] = self.ops.get(name, 0) + 1
                ins = [a for a in tree_leaves(args)
                       if isinstance(a, torch.Tensor)]
                nout = sum(_nbytes(o) for o in flat)
                nin = sum(_nbytes(a) for a in ins)
                self.counts[kind] += 1
                self.bytes[kind] += (2 * nout if kind == "all-reduce"
                                     else nout if kind == "all-gather"
                                     else nin)
        for o in flat:
            if o.device.type == "meta" or o.untyped_storage().nbytes():
                self._track(o)
        return out

    def collectives(self) -> dict:
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes.values()),
                "ops": dict(self.ops)}


def train_args(cfg, shape, mi, *, analysis: bool = False,
               param_dtype: torch.dtype = S.PARAM_DTYPE, device="meta"):
    """The train step's arguments: DTensor parameters, the AdamW state
    with ZeRO-laid-out moments (``init_opt_shardings``), the batch
    (``specs.train_input_specs``); meta shards, or zeros on another
    ``device`` (a real run of the same cell)."""
    from repro_torch.launch.train import _zero_placements
    from repro_torch.optim import adamw
    params = S.place(S.param_struct(cfg, param_dtype),
                     sh.param_specs(cfg, mi), mi, device)
    fill = None if torch.device(device).type == "meta" else 0

    def moments():
        return tree.unflatten(params, [
            sh.empty(tuple(p.shape), z, mi, dtype=torch.float32,
                     device=device, fill=fill)
            for p, z in zip(tree.leaves(params),
                            _zero_placements(cfg, mi, params))])
    opt = adamw.AdamWState(
        step=sh.empty((), (), mi, dtype=torch.int32, device=device,
                      fill=fill),
        m=moments(), v=moments())
    bstructs, bspecs = S.train_input_specs(
        cfg, shape, mi, force_n_micro=1 if analysis else None)
    return params, opt, S.place(bstructs, bspecs, mi, device)


def trace(fn, args: tuple, *, aliased=lambda out: []) -> dict:
    """Run ``fn(*args)`` once under ``Trace``; the memory, operations and
    collectives of the rank.  ``aliased(out)`` names the outputs that are
    inputs updated in place."""
    leaves = tree.leaves(list(args))
    kernels.reset_meta_flops()
    t0 = time.perf_counter()
    with Trace(_storages(leaves)) as tr:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    outs = tree.leaves(list(out) if isinstance(out, tuple) else [out])
    alias = local_bytes(aliased(out))
    out_bytes = local_bytes(outs)
    kflops = kernels.meta_flops()
    return {"trace_s": trace_s,
            "memory": {"argument_size_in_bytes": local_bytes(leaves),
                       "output_size_in_bytes": out_bytes,
                       "alias_size_in_bytes": alias,
                       "temp_size_in_bytes": max(
                           tr.peak - (out_bytes - alias), 0),
                       "peak_size_in_bytes": local_bytes(leaves) + tr.peak},
            "cost": {"flops": tr.flops + sum(kflops.values()),
                     "local_op_flops": tr.flops,
                     "kernel_flops": {k: v for k, v in kflops.items() if v}},
            "collectives": tr.collectives()}


def trace_config(cfg, shape, mi, *, analysis: bool = False,
                 param_dtype: torch.dtype = S.PARAM_DTYPE) -> dict:
    """One cell of ``cfg`` at ``shape`` (a ``ShapeConfig``) on ``mi``'s
    mesh: the entry point of its kind run once on the ``launch.specs``
    inputs under ``Trace``.  Returns ``analysis_scale``, ``trace_s``,
    ``memory``, ``cost`` and ``collectives``."""
    from repro_torch.models import transformer as T
    analysis_scale = 1
    if shape.kind == "train":
        from repro_torch.launch.train import make_train_step
        if analysis:
            analysis_scale = S.plan_microbatches(cfg, shape, mi).n_micro
        res = trace(make_train_step(cfg, mi),
                    train_args(cfg, shape, mi, analysis=analysis,
                               param_dtype=param_dtype),
                    aliased=lambda out: tree.leaves(
                        [out[0], out[1].m, out[1].v]))
    else:
        params = S.place(S.param_struct(cfg, param_dtype),
                         sh.param_specs(cfg, mi), mi)
    if shape.kind == "prefill":
        plan = S.plan_microbatches(cfg, shape, mi)
        batch = S.place(*S.prefill_input_specs(cfg, shape, mi), mi)
        res = trace(lambda p, b: T.prefill(
                        p, cfg, b.get("tokens"), plan.cache_len,
                        embeds=b.get("embeds"), mi=mi), (params, batch))
    elif shape.kind != "train":
        state, sspecs, tok, tspecs = S.decode_input_specs(cfg, shape, mi)
        res = trace(lambda p, st, b: T.decode_step(
                        p, cfg, st, b.get("tokens"), embeds=b.get("embeds"),
                        mi=mi),
                    (params, S.place(state, sspecs, mi),
                     S.place(tok, tspecs, mi)),
                    aliased=lambda out: tree.leaves(out[1]["attn"]))
    return {"analysis_scale": analysis_scale, **res}


def trace_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
               seq_shard: bool = True, save_hlo: bool = False,
               analysis: bool = False, q_chunk: int | None = None,
               kv_int8: bool = False, unstack: bool = False) -> dict:
    """``lower_cell``'s twin: one cell traced on the production mesh of
    the fake world the caller opened (``fake_world``, 256 or 512
    ranks)."""
    if save_hlo:
        raise NotImplementedError("--save-hlo: a torch trace has no HLO "
                                  "(XLA's compiled text)")
    del unstack                       # the port's layers are a list already
    cfg = get_arch(arch_id)
    if q_chunk:
        cfg = replace(cfg, attn_q_chunk=q_chunk)
    if kv_int8:
        cfg = replace(cfg, kv_cache_quant=True)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    res = trace_config(cfg, shape, make_mesh_info(mesh, seq_shard=seq_shard),
                       analysis=analysis)
    return {"arch": arch_id, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "n_devices": mesh.size(), "kind": shape.kind,
            "analysis": analysis, "analysis_scale": res.pop("analysis_scale"),
            "trace_s": round(res.pop("trace_s"), 3), **res,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}


def run_and_save(arch_id: str, shape_name: str, *, multi_pod: bool,
                 seq_shard: bool = True, save_hlo: bool = False,
                 analysis: bool = False, q_chunk: int | None = None,
                 kv_int8: bool = False, unstack: bool = False,
                 tag: str = "", out_dir: Path | None = None) -> dict:
    """Trace one cell and write its result (or, if it fails, ``status:
    "error"`` with the error and traceback) to ``out_dir``."""
    out_dir = Path(out_dir or RESULTS_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    suffix = ("__analysis" if analysis else "") + (f"__{tag}" if tag else "")
    out_path = out_dir / f"{arch_id}__{shape_name}__{mesh_tag}{suffix}.json"
    try:
        res = trace_cell(arch_id, shape_name, multi_pod=multi_pod,
                         seq_shard=seq_shard, save_hlo=save_hlo,
                         analysis=analysis, q_chunk=q_chunk,
                         kv_int8=kv_int8, unstack=unstack)
        res["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - the failure is the cell's result
        res = {"arch": arch_id, "shape": shape_name, "mesh": mesh_tag,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    out_path.write_text(json.dumps(res, indent=1))
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save-hlo", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--analysis", action="store_true",
                    help="one microbatch, analysis_scale = the plan's")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--unstack", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help="results directory (default dryrun_torch_out/)")
    args = ap.parse_args(argv)
    if args.save_hlo:
        raise SystemExit("--save-hlo: a torch trace has no HLO to save")
    todo = cells() if args.all else [(args.arch, args.shape)]
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    suffix = "__analysis" if args.analysis else ""
    out_dir = Path(args.out or RESULTS_DIR)
    bad = 0
    with fake_world(512 if args.multi_pod else 256):
        for arch_id, shape_name in todo:
            if args.skip_existing:
                p = out_dir / f"{arch_id}__{shape_name}__{mesh_tag}{suffix}.json"
                if p.exists() and json.loads(p.read_text()).get(
                        "status") == "ok":
                    print(f"[   skip] {arch_id} {shape_name} {mesh_tag}")
                    continue
            t0 = time.time()
            res = run_and_save(arch_id, shape_name,
                               multi_pod=args.multi_pod,
                               seq_shard=not args.no_seq_shard,
                               analysis=args.analysis, q_chunk=args.q_chunk,
                               kv_int8=args.kv_int8, unstack=args.unstack,
                               tag=args.tag, out_dir=out_dir)
            status = res.get("status")
            if status == "ok":
                m = res["memory"]
                extra = (f"flops={res['cost']['flops']:.3g} "
                         f"coll={res['collectives']['total_bytes']:.3g}B "
                         f"args={m['argument_size_in_bytes'] / 1e9:.3g}GB "
                         f"temp={m['temp_size_in_bytes'] / 1e9:.3g}GB "
                         f"trace={res['trace_s']}s")
            else:
                bad += 1
                extra = res.get("error", "")[:200]
            print(f"[{time.time() - t0:7.1f}s] {arch_id} {shape_name} "
                  f"{res.get('mesh')}: {status} {extra}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
