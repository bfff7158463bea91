"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the JAX ``init_params`` tree with its leaves
already mapped to numpy arrays (``jax.tree.map(np.asarray, params)``) —
so this module needs no JAX — and returns the port's parameter dict:
the same leaf names and layouts, with the stacked ``params["layers"]``
leading axis split into a list of per-layer dicts.  bfloat16 leaves
(numpy dtype ``bfloat16`` from ml_dtypes) travel through their uint16
bits, so they arrive bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params: dict, cfg: ArchConfig, *,
                    device: str | torch.device | None = "cuda",
                    dtype: torch.dtype | None = None) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's parameters on
    ``device``, cast to ``dtype`` when given."""
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _tensor(a, dev, dtype))
           for k, v in np_params.items() if k != "layers"}
    stacked = np_params["layers"]
    out["layers"] = [
        _map(stacked, lambda a, i=i: _tensor(np.asarray(a)[i], dev, dtype))
        for i in range(cfg.n_layers)]
    return out
