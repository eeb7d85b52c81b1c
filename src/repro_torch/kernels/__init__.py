"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel module (:mod:`.evict_select`, :mod:`.freq_table`,
:mod:`.flash_attention`, :mod:`.decode_attention`, :mod:`.ssd_scan`,
:mod:`.thrash_ce`) holds its wrappers, the kernels' plain PyTorch versions
and nothing else.  A wrapper given CPU tensors computes the plain
version; given CUDA tensors it launches the kernel (built at first use by
:mod:`._lib` from ``src/repro_torch/csrc``) or raises.  There is no
fallback from one to the other.

``LAUNCHES`` counts kernel launches by kernel name; a wrapper adds one
each time it launches its kernel and nowhere else, so a run can show that
its path went through the kernels.  Flash attention counts its float32
and bf16 instantiations apart (``flash_attention``,
``flash_attention_bf16``) and its float32 backward as
``flash_attention_bwd``; the thrashing CE counts its forward and backward
kernels apart (``thrash_ce_fwd``, ``thrash_ce_bwd``).
"""
from __future__ import annotations

KERNEL_NAMES = ("evict_select", "freq_update", "freq_lookup", "flash_attention", "flash_attention_bf16",
                "flash_attention_bwd", "decode_attention", "ssd_scan", "thrash_ce_fwd", "thrash_ce_bwd")

LAUNCHES: dict[str, int] = dict.fromkeys(KERNEL_NAMES, 0)


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0
