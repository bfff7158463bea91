"""Device selection for the port's entry points.

Every entry point (``init_params``, ``TierStore``, ``PagedServingEngine``)
takes an explicit ``device`` and defaults to the card.  Asking for the
card on a host without CUDA raises instead of quietly falling back to
the CPU: a run that silently lands on the CPU would report CPU numbers
under a device name.  The CPU is used only when the caller names it, as
the parity tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda"
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means the card.  Raises
    ``RuntimeError`` for a CUDA device on a host without one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return dev
