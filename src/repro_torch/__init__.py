"""repro_torch — the PyTorch/CUDA port of the memos system.

A second package beside the JAX reference ``repro``: the same module
layout and names (``configs``, ``models``, ``kernels``, ``core``,
``nvm``, ``serving``, ``obs``), written in torch with hand-written CUDA
kernels for the card.  It never imports ``jax`` or ``repro``.

Entry points (``models.transformer.init_params``, ``core.tiers.TierStore``,
``serving.engine.PagedServingEngine``) run on the card by default and
raise without CUDA unless the caller passes ``device="cpu"``.
"""
