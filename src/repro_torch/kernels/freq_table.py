"""The prediction-frequency table's update stream and lookup.

Port of ``repro.kernels.freq_table`` (TPU kernels ``_update_kernel``,
``src/repro/kernels/freq_table/kernel.py:40``, and ``_lookup_kernel``,
``:105``).  CUDA kernels: ``src/repro_torch/csrc/freq_table.cu``.

The table is int32 tags and counters of shape (sets, 16).  The plain
update is the JAX package's vectorized host table ported to PyTorch: the
stream is grouped by set (stably), same-block runs within a set collapse
into one saturating ``+k``, and the k-th run of every set updates in one
conflict-free scatter wave.  Block ids are ints >= -1; -1 is padding.
The set index is a floor modulo (``-1 % 1024 == 1023`` for lookups).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._lib import LIBRARY, ptr, stream_handle

COUNTER_MAX = 63  # 6-bit saturating counters
WAYS = 16


def _update_wave(tags, counters, b, s, k) -> None:
    """``k[i]`` touches of block ``b[i]`` in set ``s[i]`` (distinct sets)."""
    row_tags = tags[s]
    hit = row_tags == b[:, None]
    is_hit = hit.any(dim=1)
    empty = row_tags == -1
    ins_way = torch.where(empty.any(dim=1), empty.to(torch.uint8).argmax(dim=1), counters[s].argmin(dim=1))
    way = torch.where(is_hit, hit.to(torch.uint8).argmax(dim=1), ins_way)
    base = torch.where(is_hit, counters[s, way], torch.zeros_like(k))
    tags[s, way] = b
    counters[s, way] = torch.clamp(base + k, max=COUNTER_MAX)


def freq_update_plain(tags: torch.Tensor, counters: torch.Tensor, blocks: torch.Tensor):
    """Updated copies of (tags, counters) after streaming ``blocks``."""
    tags, counters = tags.clone(), counters.clone()
    b = blocks[blocks >= 0].to(torch.int32)
    if b.numel() == 0:
        return tags, counters
    n_sets = tags.shape[0]
    s = b % n_sets
    order = torch.argsort(s, stable=True)
    bs, ss = b[order], s[order]
    change = torch.ones_like(bs, dtype=torch.bool)
    change[1:] = (bs[1:] != bs[:-1]) | (ss[1:] != ss[:-1])
    starts = torch.nonzero(change).flatten()
    run_len = torch.diff(starts, append=starts.new_tensor([len(bs)])).to(torch.int32)
    rb, rs = bs[starts], ss[starts]
    set_start = torch.ones_like(rs, dtype=torch.bool)
    set_start[1:] = rs[1:] != rs[:-1]
    grp = torch.nonzero(set_start).flatten()
    grp_len = torch.diff(grp, append=grp.new_tensor([len(rb)]))
    within = torch.arange(len(rb), device=b.device) - torch.repeat_interleave(grp, grp_len)
    for k in range(int(within.max()) + 1):
        m = within == k
        _update_wave(tags, counters, rb[m], rs[m].long(), run_len[m])
    return tags, counters


def freq_lookup_plain(tags: torch.Tensor, counters: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Counter per block (int32), -1 on a miss: the first-hit way."""
    s = (blocks % tags.shape[0]).long()
    rows = tags[s]
    hit = rows == blocks[:, None]
    way = hit.to(torch.uint8).argmax(dim=1)
    cnt = counters[s].gather(1, way[:, None])[:, 0]
    return torch.where(hit.any(dim=1), cnt, torch.full_like(cnt, -1))


def _check(tags, counters, blocks) -> None:
    for name, t in (("tags", tags), ("counters", counters)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != WAYS or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 (sets, {WAYS}) tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if tags.shape != counters.shape or counters.device != tags.device:
        raise ValueError("tags and counters must match in shape and device")
    if blocks.dtype != torch.int32 or blocks.dim() != 1 or not blocks.is_contiguous() or blocks.device != tags.device:
        raise ValueError("blocks must be a contiguous 1-D int32 tensor on the table's device")
    if tags.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the frequency table runs on cpu or cuda tensors, not {tags.device}")


def freq_update(tags: torch.Tensor, counters: torch.Tensor, blocks: torch.Tensor) -> None:
    """Stream ``blocks`` (int32, -1 = padding) through the table, updating
    ``tags`` and ``counters`` in place: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check(tags, counters, blocks)
    if tags.device.type == "cpu":
        new_t, new_c = freq_update_plain(tags, counters, blocks)
        tags.copy_(new_t)
        counters.copy_(new_c)
        return
    if blocks.numel() == 0:
        return
    LIBRARY.call("repro_freq_update", ptr(tags), ptr(counters), ptr(blocks), blocks.numel(), tags.shape[0],
                 stream_handle(tags.device))
    LAUNCHES["freq_update"] += 1


def freq_lookup(tags: torch.Tensor, counters: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Counter per block (int32 (N,)), -1 on a miss: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(tags, counters, blocks)
    if tags.device.type == "cpu":
        return freq_lookup_plain(tags, counters, blocks)
    out = torch.empty_like(blocks)
    if blocks.numel() == 0:
        return out
    LIBRARY.call("repro_freq_lookup", ptr(tags), ptr(counters), ptr(blocks), ptr(out), blocks.numel(),
                 tags.shape[0], stream_handle(tags.device))
    LAUNCHES["freq_lookup"] += 1
    return out
