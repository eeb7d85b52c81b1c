"""Victim selection: the ``n_evict`` lexicographically smallest candidates.

Port of ``repro.kernels.evict_select`` (TPU kernel ``_select_kernel``,
``src/repro/kernels/evict_select/kernel.py:28``).  CUDA kernel:
``src/repro_torch/csrc/evict_select.cu``, which ranks every candidate in
one pass (the candidates before it in that order) instead of drawing the
victims one by one.

The victims of the simulator's chained masked argmin are the first
``n_evict`` candidates in (k0, k1, k2, k3, index) order, because the keys
are constant for the step.  The plain version sorts once (stable sorts from
the least significant key up) and keeps the first ``n_evict`` ranks, so
``n_evict`` may stay a device scalar: neither version waits on the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._lib import LIBRARY, stream_handle


def evict_select_plain(cand: torch.Tensor, keys: tuple, n_evict: torch.Tensor) -> torch.Tensor:
    """Victim mask (bool (NB,)) computed with PyTorch sorts."""
    nb = cand.shape[0]
    iota = torch.arange(nb, device=cand.device)
    order = iota
    for k in reversed(keys):
        order = order[torch.argsort(k[order], stable=True)]
    order = order[torch.argsort((~cand[order]).to(torch.int8), stable=True)]  # candidates first
    rank = torch.empty_like(order)
    rank[order] = iota
    return cand & (rank < n_evict)


def _check(cand: torch.Tensor, keys: tuple, n_evict: torch.Tensor) -> None:
    shape, dev = cand.shape, cand.device
    if cand.dtype != torch.bool or len(shape) != 1 or not cand.is_contiguous():
        raise ValueError(f"cand must be a contiguous 1-D bool tensor, got {cand.dtype} {tuple(shape)}")
    if not 1 <= len(keys) <= 4:
        raise ValueError(f"evict_select takes 1-4 keys, got {len(keys)}")
    for k in keys:
        if k.dtype != torch.int32 or k.shape != shape or not k.is_contiguous() or k.device != dev:
            raise ValueError("keys must be contiguous int32 tensors shaped and placed like cand")
    if n_evict.dtype != torch.int32 or n_evict.numel() != 1 or n_evict.device != dev:
        raise ValueError("n_evict must be a one-element int32 tensor on cand's device")


def evict_select(cand: torch.Tensor, keys: tuple, n_evict: torch.Tensor) -> torch.Tensor:
    """Victim mask: the kernel for CUDA tensors, the plain version for CPU
    tensors.  ``keys`` holds 1-4 int32 (NB,) tensors, leading key first;
    ``n_evict`` is an int32 scalar tensor (no more victims than candidates
    are taken)."""
    _check(cand, keys, n_evict)
    dev = cand.device
    if dev.type == "cpu":
        return evict_select_plain(cand, keys, n_evict)
    if dev.type != "cuda":
        raise ValueError(f"evict_select runs on cpu or cuda tensors, not {dev}")
    vict = torch.empty_like(cand)
    kp = [k.data_ptr() for k in keys] + [None] * (4 - len(keys))
    LIBRARY.call("repro_evict_select", cand.data_ptr(), *kp, n_evict.data_ptr(), vict.data_ptr(), cand.shape[0],
                 stream_handle(dev))
    LAUNCHES["evict_select"] += 1
    return vict
