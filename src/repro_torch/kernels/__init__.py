"""Hand-written CUDA kernels of the port, one module per kernel family.

Each wrapper takes its kernel's plain PyTorch version *only* for CPU
tensors; for CUDA tensors it launches the kernel (built on first use by
``_build``) or raises.  Every launch adds one to the wrapper's entry in
the process-wide launch counts, so a run can show that its main path
went through the kernels:

    kernels.reset_launch_counts()
    ...drive the engine...
    kernels.launch_counts()   # {"paged_attention": 1152, ...}

The wrappers that the dry run reaches (K8 ``flash_attention``, K9
``ssd_scan`` and the ``moe_ffn`` entries) also take meta tensors: they
return empty outputs of the kernel's shapes and dtypes, launch and count
nothing, and add the kernel's operations, from a formula of its shapes,
to ``meta_flops()``.
"""
from __future__ import annotations

KERNELS = ("paged_attention", "touch_update", "page_gather", "page_scatter",
           "wear_update", "page_checksum", "sysmon_pass",
           "paged_attention_dual", "qkv_rope_append", "page_gather_quant",
           "dequant_gather", "flash_attention", "ssd_scan",
           "paged_attention_prefill", "paged_attention_prefill_dual",
           "moe_ffn", "moe_ffn_bwd")

_counts = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _counts[name] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0


_meta_flops = dict.fromkeys(KERNELS, 0.0)


def add_meta_flops(name: str, flops: float) -> None:
    """A wrapper called on meta tensors: the operations its kernel would
    do on tensors of those shapes."""
    _meta_flops[name] += float(flops)


def meta_flops() -> dict[str, float]:
    """Operations per wrapper of its meta calls since the last reset."""
    return dict(_meta_flops)


def reset_meta_flops() -> None:
    for k in _meta_flops:
        _meta_flops[k] = 0.0
