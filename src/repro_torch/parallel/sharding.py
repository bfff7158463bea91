"""Sharding policy (torch twin of ``repro.parallel.sharding``): every
parameter and activation gets a spec over a ``DeviceMesh`` with axes
``("data", "model")`` or ``("pod", "data", "model")``.

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
those axes, major first), the entries of a JAX ``PartitionSpec``.
``placements`` turns one into DTensor ``Shard``/``Replicate``
placements, one per mesh dim, and ``constrain`` redistributes a DTensor
to it, as ``with_sharding_constraint`` asks GSPMD to.

Two attention-parallelism modes, picked per arch (``attn_mode``):

  * ``megatron``: heads divide the ``model`` axis; q/k/v/o sharded on
    heads (k/v only where the kv heads divide it too), MLP column/row
    split, activations sequence-sharded between blocks in training;
  * ``context``: heads do not divide it; attention weights replicated,
    activations sequence-sharded over ``model``, MLP column/row split.

The port's parameters keep one dict per layer (``params["layers"][l]``),
so a layer leaf's spec is the JAX spec without its leading layer entry.
ZeRO specs of the moments and gradient sums are ``optim.adamw.zero_specs``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig

Spec = tuple


@dataclass(frozen=True)
class MeshInfo:
    """A mesh and the roles of its axes.  ``mesh`` is a
    ``torch.distributed.device_mesh.DeviceMesh`` (or, for spec
    arithmetic alone, any object with ``mesh_dim_names`` and ``shape``)."""
    mesh: Any
    dp_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    seq_shard: bool = True          # Megatron-SP activations between blocks

    def axis_size(self, axis: str) -> int:
        return dict(zip(self.mesh.mesh_dim_names,
                        tuple(self.mesh.shape)))[axis]

    @property
    def n_model(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def n_data(self) -> int:
        return math.prod(self.axis_size(a) for a in self.dp_axes)


def attn_mode(cfg: ArchConfig, mi: MeshInfo) -> str:
    if cfg.layout == "mamba":
        return "none"
    return "megatron" if cfg.n_heads % mi.n_model == 0 else "context"


# --- parameter specs ---------------------------------------------------------

def _stacked_specs(cfg: ArchConfig, mi: MeshInfo, fsdp_attn: bool) -> dict:
    """The JAX package's spec tree, layer leaves with their leading layer
    entry, shared block without one."""
    M = mi.model_axis
    mode = attn_mode(cfg, mi)
    fsdp = mi.dp_axes[-1] if fsdp_attn else None

    def attn_spec():
        if mode == "megatron":
            kv = M if cfg.n_kv_heads % mi.n_model == 0 else None
            s = {"wq": (None, None, M, None), "wk": (None, None, kv, None),
                 "wv": (None, None, kv, None), "wo": (None, M, None, None)}
            biases = {"bq": (None, M, None), "bk": (None, kv, None),
                      "bv": (None, kv, None)}
        else:
            r = (None, fsdp, None, None)
            s = {"wq": r, "wk": r, "wv": r, "wo": (None, None, None, fsdp)}
            b = (None, None, None)
            biases = {"bq": b, "bk": b, "bv": b}
        if cfg.qkv_bias:
            s |= biases
        if cfg.qk_norm:
            s |= {"q_norm": (None, None), "k_norm": (None, None)}
        return s

    def mlp_spec():
        if cfg.mlp_kind == "gelu":
            return {"w_up": (None, None, M), "w_down": (None, M, None)}
        return {"w_gate": (None, None, M), "w_up": (None, None, M),
                "w_down": (None, M, None)}

    def moe_spec():
        if cfg.n_experts >= mi.n_model and cfg.n_experts % mi.n_model == 0:
            return {"w_router": (None, None, None),
                    "w_gate": (None, M, None, None),
                    "w_up": (None, M, None, None),
                    "w_down": (None, M, None, None)}
        return {"w_router": (None, None, None),
                "w_gate": (None, None, None, M),
                "w_up": (None, None, None, M),
                "w_down": (None, None, M, None)}

    def mamba_spec():
        return {"in_proj_z": (None, None, M), "in_proj_x": (None, None, M),
                "in_proj_B": (None, None, None),
                "in_proj_C": (None, None, None),
                "in_proj_dt": (None, None, None),
                "conv_w": (None, None, None), "conv_b": (None, None),
                "dt_bias": (None, None), "A_log": (None, None),
                "D": (None, None), "norm": (None, M),
                "out_proj": (None, M, None)}

    norm = (None, None)
    if cfg.layout in ("mamba", "hybrid"):
        layers = {"ln": norm, "mamba": mamba_spec()}
    else:
        layers = {"ln1": norm, "ln2": norm, "attn": attn_spec()}
        if cfg.is_moe:
            layers["moe"] = moe_spec()
        else:
            layers["mlp"] = mlp_spec()
        if cfg.gemma_norm:
            layers["ln1_post"] = norm
            layers["ln2_post"] = norm
    specs: dict = {"layers": layers, "final_norm": (None,)}
    if cfg.layout == "hybrid":
        specs["shared"] = {
            "ln1": (None,), "ln2": (None,),
            "attn": {k: v[1:] for k, v in attn_spec().items()},
            "mlp": {k: v[1:] for k, v in mlp_spec().items()}}
    if cfg.tie_embeddings:
        specs["embed"] = (M, None)           # vocab-sharded
    else:
        specs["embed"] = (None, M)           # d-sharded
        specs["lm_head"] = (None, M)         # padded vocab sharded
    return specs


def param_specs(cfg: ArchConfig, mi: MeshInfo, *, fsdp_attn: bool = False
                ) -> dict:
    """The spec tree of ``init_params``' tree: ``"layers"`` a list of
    ``cfg.n_layers`` equal dicts, each leaf the JAX spec without its
    leading layer entry."""
    specs = _stacked_specs(cfg, mi, fsdp_attn)

    def drop_lead(node):
        if isinstance(node, dict):
            return {k: drop_lead(v) for k, v in node.items()}
        return node[1:]

    one = drop_lead(specs["layers"])
    return dict(specs, layers=[one] * cfg.n_layers)


# --- activation specs ----------------------------------------------------------

def data_entry(mi: MeshInfo):
    """The spec entry of a dim split over the data axes: the axis name, or
    the tuple of them (a JAX ``PartitionSpec`` reads a one-name tuple as
    the name)."""
    return mi.dp_axes[0] if len(mi.dp_axes) == 1 else mi.dp_axes


def act_spec(cfg: ArchConfig, mi: MeshInfo, *, seq: bool) -> Spec:
    """[B, S, d] activations between blocks."""
    if seq and mi.seq_shard and cfg.layout not in ("mamba",):
        return (data_entry(mi), mi.model_axis, None)
    return (data_entry(mi), None, None)


def kv_cache_spec(mi: MeshInfo) -> Spec:
    """[B, S, Hkv, Dh] decode cache: batch over data, seq over model."""
    return (data_entry(mi), mi.model_axis, None, None)


SEQ_SPLIT_MIN = 4096    # decode state: caches of fewer slots stay whole


def decode_state_specs(state: dict, mi: MeshInfo, *, long_ctx: bool = False,
                       min_split: int = SEQ_SPLIT_MIN) -> dict:
    """The spec tree of a decode state (``init_decode_state``'s tree), as
    the JAX dry run lays it out (``specs.decode_input_specs``): the batch
    over the data axes; a K/V cache [B, W, Hkv, Dh] and its ``pos`` (and
    int8 scales) [B, W(, Hkv)] with the slots over ``model`` where W >=
    ``min_split`` (ring buffers of fewer slots whole); a Mamba layer's h
    [B, H, N, P] with the heads over ``model`` and its conv context
    [B, d_conv-1, conv_ch] with the channels over ``model``.
    ``long_ctx`` (one sequence, ``long_500k``): the batch whole and the
    slots over *every* axis.  ``min_split=0`` is ``kv_cache_spec``'s
    layout for every cache, the one ``prefill`` writes."""
    batch = None if long_ctx else data_entry(mi)
    axes = (*mi.dp_axes, mi.model_axis)
    seq_axes = axes if long_ctx else mi.model_axis

    def cache(c):
        seq = seq_axes if c["k"].shape[1] >= min_split else None
        out = {"k": (batch, seq, None, None), "v": (batch, seq, None, None),
               "pos": (batch, seq)}
        if "k_scale" in c:
            out["k_scale"] = out["v_scale"] = (batch, seq, None)
        return out

    return {"positions": (batch,),
            "attn": [cache(c) for c in state["attn"]],
            "mamba": [{"h": (batch, mi.model_axis, None, None),
                       "conv": (batch, None, mi.model_axis)}
                      for _ in state["mamba"]]}


# --- specs to DTensor placements -------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` if the spec splits tensor dim i over that axis, else
    ``Replicate()``.  A dim split over several axes takes them in mesh
    order, the order a JAX spec's tuple names them in."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    dim_of: dict[str, int] = {}
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} out of mesh order "
                             f"{names}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            dim_of[a] = i
    unknown = set(dim_of) - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} not in "
                         f"the mesh {names}")
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


def constrain(x, mi: MeshInfo | None, spec: Spec):
    """``x`` laid out as ``spec`` on ``mi``'s mesh: a DTensor is
    redistributed (a differentiable collective), a plain tensor made a
    DTensor replicated on every rank first.  Without a mesh ``x`` comes
    back unchanged."""
    if mi is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mi.mesh, [Replicate()] * mi.mesh.ndim,
                               run_check=False)
    return x.redistribute(mi.mesh, placements(spec, mi.mesh))


def map_with_specs(fn: Callable, params, specs):
    """``fn(leaf, spec)`` over ``params``' leaves beside their specs, in a
    tree shaped like ``params`` (dicts by key, lists by index)."""
    if isinstance(params, dict):
        return {k: map_with_specs(fn, params[k], specs[k]) for k in params}
    if isinstance(params, list):
        return [map_with_specs(fn, p, s) for p, s in zip(params, specs)]
    return fn(params, specs)


def spec_leaves(specs, params) -> list:
    """The specs of ``params``' leaves in ``repro_torch.tree`` order (a
    spec is a tuple, which the tree helpers would walk into)."""
    from repro_torch import tree
    out = []
    for name in tree.flatten_with_names(params)[0]:
        node = specs
        for key in name.split("/"):
            node = node[int(key)] if isinstance(node, list) else node[key]
        out.append(node)
    return out


def distribute(params, mi: MeshInfo, specs):
    """Each leaf of ``params`` (the same full tensor on every rank) as a
    DTensor laid out by its spec, on storage of its own (the train step
    updates it in place)."""
    from torch.distributed.tensor import distribute_tensor
    return map_with_specs(
        lambda p, s: distribute_tensor(p.detach().clone(), mi.mesh,
                                       placements(s, mi.mesh)),
        params, specs)


def empty(shape: tuple, spec, mi: MeshInfo, *, dtype: torch.dtype,
          device, fill=None):
    """A DTensor of global ``shape`` laid out by ``spec`` (or a tuple of
    DTensor placements) whose local shard is allocated here
    (``torch.empty``, or ``torch.full`` with ``fill``): nothing whole is
    made, so meta tensors and uneven shards work."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = (tuple(spec) if spec and isinstance(spec[0], Placement)
          else placements(spec, mi.mesh))
    local_shape, _ = compute_local_shape_and_global_offset(shape, mi.mesh,
                                                           pl)
    t = (torch.empty(local_shape, dtype=dtype, device=device) if fill is None
         else torch.full(local_shape, fill, dtype=dtype, device=device))
    return from_local(t, mi, pl, shape)


def from_local(t: torch.Tensor, mi: MeshInfo, places, shape: tuple):
    """DTensor of global ``shape`` (contiguous) from each rank's shard
    ``t`` (made contiguous) laid out by ``places`` (shards may be
    uneven)."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for dim in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= max(dim, 1)
    return DTensor.from_local(t.contiguous(), mi.mesh, places,
                              run_check=False,
                              shape=tuple(shape), stride=tuple(stride))


def local_offset(t) -> tuple[int, ...]:
    """Where DTensor ``t``'s local shard starts in the whole tensor."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return tuple(compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)[1])


def split_dims(t, dim: int) -> list[int]:
    """The mesh dims over which DTensor ``t``'s tensor dim ``dim`` is
    split, in mesh order."""
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(t.placements)
            if isinstance(pl, Shard) and pl.dim == dim]


def like_batch(t, batch_dim: int = 0) -> list:
    """Placements that keep DTensor ``t``'s split of its batch dim and
    leave every other dim whole (the layout a shard-local block reads its
    rows in)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if isinstance(pl, Shard) and pl.dim == batch_dim
            else Replicate() for pl in t.placements]


def seq_rows(t, mi: MeshInfo) -> list:
    """Placements that keep DTensor ``t``'s split of its batch dim, split
    its sequence dim (1) over ``model`` and leave every other dim whole:
    context-mode attention's layout of x, q and the output, each
    ``model`` rank's rows of the sequence (torch's ``chunk`` sizes where
    ``model`` does not divide S; ``local_offset(...)[1]`` is the rank's
    first row)."""
    from torch.distributed.tensor import Shard
    return [Shard(1) if n == mi.model_axis else pl
            for n, pl in zip(mi.mesh.mesh_dim_names, like_batch(t))]


def zero_places(t, mi: MeshInfo) -> list:
    """Placements of DTensor ``t`` laid out as ZeRO lays out its gradient
    sum and moments (``optim.adamw.zero_spec``): its splits kept and, where
    it is whole over the data axes, its first unsplit dim that they divide
    split over them."""
    from torch.distributed.tensor import Shard

    from repro_torch.optim.adamw import zero_spec
    names = mi.mesh.mesh_dim_names
    spec: list = [()] * t.dim()
    for n, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            spec[pl.dim] = (*spec[pl.dim], n)
    if any(n in mi.dp_axes for entry in spec for n in entry):
        return list(t.placements)
    spec = [e[0] if len(e) == 1 else (e or None) for e in spec]
    return list(placements(zero_spec(tuple(t.shape), tuple(spec),
                                     mi.dp_axes, mi.n_data), mi.mesh))


def full(x) -> torch.Tensor:
    """The whole tensor of a DTensor (a gather), a plain tensor as is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


# --- local maps: a block on each rank's shards, summed over ``model`` ------------

def local(t, mi: MeshInfo, partial_axes: tuple[str, ...] = ()):
    """The local shard of DTensor ``t`` for a block that runs on local
    tensors (JAX's ``shard_map`` body).  Its gradient is declared a
    partial sum over ``partial_axes``: the axes over which ``t`` is
    replicated but each rank uses it for a different part of the work
    (the heads, experts or tokens it holds), so the ranks' local
    gradients add up to the whole."""
    from torch.distributed.tensor import Partial
    return t.to_local(grad_placements=[
        Partial() if n in partial_axes else pl
        for n, pl in zip(mi.mesh.mesh_dim_names, t.placements)])


class _GradLayout(torch.autograd.Function):
    """Identity whose backward lays the gradient out as ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def psum(out, mi: MeshInfo, like):
    """The sum over ``model`` of each rank's local ``out`` (JAX's
    ``psum``), as a DTensor laid out as DTensor ``like`` with ``model``
    replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    names = mi.mesh.mesh_dim_names
    target = [Replicate() if n == mi.model_axis else pl
              for n, pl in zip(names, like.placements)]
    parts = [Partial() if n == mi.model_axis else pl
             for n, pl in zip(names, like.placements)]
    y = DTensor.from_local(out, mi.mesh, parts, run_check=False)
    # the gradient of a sum of local parts is the whole gradient on every
    # rank: one that arrives as a partial sum is reduced first
    return grad_as(y.redistribute(mi.mesh, target), target)


def grad_as(x, placements):
    """DTensor ``x`` unchanged, its gradient redistributed to
    ``placements`` on the way back (where DTensor would hand a reshape's
    backward a layout it cannot view)."""
    return _GradLayout.apply(x, tuple(placements))
