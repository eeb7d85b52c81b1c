"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel module (:mod:`.evict_select`, :mod:`.freq_table`,
:mod:`.flash_attention`, :mod:`.decode_attention`, :mod:`.ssd_scan`) holds a wrapper, the
kernel's plain PyTorch version and nothing else.  A wrapper given CPU tensors computes the plain
version; given CUDA tensors it launches the kernel (built at first use by
:mod:`._lib` from ``src/repro_torch/csrc``) or raises.  There is no
fallback from one to the other.

``LAUNCHES`` counts kernel launches by kernel name; a wrapper adds one
each time it launches its kernel and nowhere else, so a run can show that
its path went through the kernels.  Flash attention counts its float32
and bf16 instantiations apart (``flash_attention``,
``flash_attention_bf16``).
"""
from __future__ import annotations

KERNEL_NAMES = ("evict_select", "freq_update", "freq_lookup", "flash_attention", "flash_attention_bf16",
                "decode_attention", "ssd_scan")

LAUNCHES: dict[str, int] = dict.fromkeys(KERNEL_NAMES, 0)


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0
