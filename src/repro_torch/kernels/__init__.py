"""Hand-written CUDA kernels of the port, one module per kernel family.

Each wrapper takes its kernel's plain PyTorch version *only* for CPU
tensors; for CUDA tensors it launches the kernel (built on first use by
``_build``) or raises.  Every launch adds one to the wrapper's entry in
the process-wide launch counts, so a run can show that its main path
went through the kernels:

    kernels.reset_launch_counts()
    ...drive the engine...
    kernels.launch_counts()   # {"paged_attention": 1152, ...}
"""
from __future__ import annotations

KERNELS = ("paged_attention", "touch_update", "page_gather", "page_scatter",
           "wear_update", "page_checksum", "sysmon_pass",
           "paged_attention_dual", "qkv_rope_append", "page_gather_quant",
           "dequant_gather", "flash_attention", "ssd_scan",
           "paged_attention_prefill", "paged_attention_prefill_dual",
           "moe_ffn")

_counts = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _counts[name] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0
