"""repro_torch — the PyTorch/CUDA port of the memos system.

A second package beside the JAX reference ``repro``: the same module
layout and names (``configs``, ``models``, ``kernels``, ``core``,
``nvm``, ``serving``, ``obs``), written in torch with hand-written CUDA
kernels for the card.  It never imports ``jax`` or ``repro``.

Entry points (``models.transformer.init_params``, ``core.tiers.TierStore``,
``serving.engine.PagedServingEngine``) run on the card by default and
raise without CUDA unless the caller passes ``device="cpu"``.
"""
import torch as _torch

# MKL's vector math library, which computes torch.exp, log, tanh, ... on
# CPU float tensors, sets itself up on its first call in a process: when
# two intra-op threads make that first call at once (a torch.exp over
# >= 4096 elements on two threads), one of them can compute that call far
# off float32 rounding, which moved the plain SSD scan off its float64
# reference in some test processes (ROADMAP C10).  One call from this
# thread, at import, does the set-up before any parallel call can.
_torch.exp(_torch.zeros(1))
