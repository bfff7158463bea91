"""Run plans and input stand-ins per (architecture x input shape x mesh)
(torch twin of ``repro.launch.specs``): gradient accumulation for
training, the cache length for decode, and for the dry run the inputs of
every cell as meta tensors (``*_input_specs``, ``param_struct``) beside
their specs (``parallel.sharding`` tuples, a JAX ``PartitionSpec``'s
entries), which ``place`` turns into DTensors of meta shards: nothing is
allocated anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import MeshInfo

PARAM_DTYPE = torch.bfloat16
ACT_DTYPE = torch.bfloat16
CACHE_PAD = 512  # decode caches get seq_len + CACHE_PAD slots (512 keeps
                 # cache_len divisible by every seq-sharding group size)


@dataclass(frozen=True)
class RuntimePlan:
    n_micro: int          # gradient-accumulation microbatches (train)
    micro_batch: int      # global tokens-batch per microbatch
    cache_len: int = 0    # decode cache capacity


def plan_microbatches(cfg: ArchConfig, shape: ShapeConfig,
                      mi: MeshInfo) -> RuntimePlan:
    """Gradient accumulation such that each data rank's microbatch is 1-2
    sequences (1 for models of d_model x n_layers >= 3072 x 32), the
    largest microbatch that divides the global batch."""
    if shape.kind != "train":
        return RuntimePlan(1, shape.global_batch,
                           cache_len=shape.seq_len + CACHE_PAD)
    per_dev = 1 if cfg.d_model * cfg.n_layers >= 3072 * 32 else 2
    micro = max(mi.n_data * per_dev, 1)
    micro = min(micro, shape.global_batch)
    while shape.global_batch % micro:
        micro -= 1
    return RuntimePlan(shape.global_batch // micro, micro)


# --- inputs ------------------------------------------------------------------

def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig, mi: MeshInfo,
                      force_n_micro: int | None = None) -> tuple[dict, dict]:
    """(meta tensors, specs) of the [n_micro, Bm, S] batch: labels and
    tokens int32 (embeds [n_micro, Bm, S, d] in ``ACT_DTYPE``), the
    microbatch over the data axes."""
    plan = plan_microbatches(cfg, shape, mi)
    nm, bm, S = plan.n_micro, plan.micro_batch, shape.seq_len
    if force_n_micro is not None:
        nm = force_n_micro
    dp = sh.data_entry(mi)
    structs = {"labels": _meta((nm, bm, S), torch.int32)}
    specs = {"labels": (None, dp, None)}
    if cfg.input_mode == "embeds":
        structs["embeds"] = _meta((nm, bm, S, cfg.d_model), ACT_DTYPE)
        specs["embeds"] = (None, dp, None, None)
    else:
        structs["tokens"] = _meta((nm, bm, S), torch.int32)
        specs["tokens"] = (None, dp, None)
    return structs, specs


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig, mi: MeshInfo
                        ) -> tuple[dict, dict]:
    """(meta tensors, specs) of the [B, S] prompts (embeds [B, S, d]), the
    batch over the data axes."""
    B, S = shape.global_batch, shape.seq_len
    dp = sh.data_entry(mi)
    if cfg.input_mode == "embeds":
        return ({"embeds": _meta((B, S, cfg.d_model), ACT_DTYPE)},
                {"embeds": (dp, None, None)})
    return {"tokens": _meta((B, S), torch.int32)}, {"tokens": (dp, None)}


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig, mi: MeshInfo):
    """The decode state and the one-token batch: (state, state specs,
    batch, batch specs), meta tensors beside specs.

    ``decode_32k``: the batch over the data axes, the cache slots over
    ``model``.  ``long_500k`` (batch 1): the slots over *all* axes, the
    whole pod holding one sequence's KV (distributed flash-decode).  Ring
    buffers of fewer than ``sharding.SEQ_SPLIT_MIN`` slots stay whole
    (``sharding.decode_state_specs``)."""
    from repro_torch.models import transformer as T
    B, S = shape.global_batch, shape.seq_len
    long_ctx = shape.kind == "long_decode"
    state = T.init_decode_state(cfg, B, S + CACHE_PAD, dtype=ACT_DTYPE,
                                start_pos=S, device="meta")
    specs = sh.decode_state_specs(state, mi, long_ctx=long_ctx)
    batch = None if long_ctx else sh.data_entry(mi)
    if cfg.input_mode == "embeds":
        return (state, specs,
                {"embeds": _meta((B, 1, cfg.d_model), ACT_DTYPE)},
                {"embeds": (batch, None, None)})
    return (state, specs, {"tokens": _meta((B, 1), torch.int32)},
            {"tokens": (batch, None)})


def param_struct(cfg: ArchConfig, dtype: torch.dtype = PARAM_DTYPE) -> dict:
    """``init_params``' tree as meta tensors of ``dtype`` (no
    allocation).  The port's tree is per layer already, so JAX's
    ``unstacked`` has no counterpart."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import transformer as T
    with FakeTensorMode():
        fake = T.init_params(cfg, dtype=dtype, device="cpu")
        leaves = [(tuple(p.shape), p.dtype) for p in tree.leaves(fake)]
    return tree.unflatten(fake, [_meta(s, d) for s, d in leaves])


def param_shardings(cfg: ArchConfig, mi: MeshInfo) -> tuple[dict, dict]:
    """(DTensor placements, specs) of every parameter, trees shaped like
    ``param_struct``'s."""
    specs = sh.param_specs(cfg, mi)
    return sh.map_with_specs(lambda _, s: sh.placements(s, mi.mesh),
                             specs, specs), specs


def place(structs, specs, mi: MeshInfo, device="meta"):
    """Each meta tensor of ``structs`` as a DTensor laid out by its spec in
    ``specs`` (a tree shaped like it), its local shard a meta tensor (or,
    on another ``device``, zeros)."""
    fill = None if torch.device(device).type == "meta" else 0
    return sh.map_with_specs(
        lambda t, s: sh.empty(tuple(t.shape), s, mi, dtype=t.dtype,
                              device=device, fill=fill), structs, specs)
