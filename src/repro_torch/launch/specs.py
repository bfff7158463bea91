"""Run plans per (architecture x input shape x mesh) (torch twin of
``repro.launch.specs``, its plan half): gradient accumulation for
training, the cache length for decode.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.parallel.sharding import MeshInfo

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
