"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

The port's tests hand the same numpy inputs to the JAX package and to
``repro_torch`` and compare the results: integer and host state exactly,
floats within ``ATOL``/``RTOL`` (XLA and torch sum in different orders).
Test modules cap torch's intra-op threads, since the suite runs under
several xdist workers.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

ATOL = 1e-5
RTOL = 1e-4
TORCH_THREADS = 2


def cap_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)


def cuda_device() -> torch.device:
    """The card, or skip the calling test (decided at run time, never at
    collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def np_of(x) -> np.ndarray:
    """numpy view of a torch tensor (any device) or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, atol: float = ATOL, rtol: float = RTOL) -> None:
    np.testing.assert_allclose(np_of(got).astype(np.float64),
                               np_of(want).astype(np.float64),
                               atol=atol, rtol=rtol)


def assert_same(got, want) -> None:
    np.testing.assert_array_equal(np_of(got), np_of(want))
