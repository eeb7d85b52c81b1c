"""Paged KV cache: fixed-size token pages + per-sequence block tables.

The pool is the unit of the paper's technique at serving time: pages move
between the device pool and host memory under the offload manager
(:mod:`repro_torch.serving.offload`), as 64KB UVM basic blocks move between
device and CPU memory.  As in the JAX package, the engine's decode reads a
dense cache and this pool is not on its path.  ``append_token`` writes the
pool in place (the reference rebuilds it with ``.at[].set``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

PAGE_TOKENS = 64


@dataclasses.dataclass
class PagedKV:
    """Per-layer pools: k/v (L, n_pages, PAGE_TOKENS, KV, HD)."""

    k: torch.Tensor
    v: torch.Tensor
    block_table: np.ndarray  # (B, max_pages) int32 -> pool page id (-1 empty)
    seq_lens: np.ndarray  # (B,)
    free: list[int]

    @classmethod
    def create(cls, n_layers, n_pages, kv_heads, head_dim, batch, max_pages, dtype=torch.bfloat16,
               device="cuda"):
        shape = (n_layers, n_pages, PAGE_TOKENS, kv_heads, head_dim)
        dev = resolve_device(device)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            block_table=np.full((batch, max_pages), -1, np.int32),
            seq_lens=np.zeros(batch, np.int32),
            free=list(range(n_pages)),
        )

    def alloc_page(self, seq: int) -> int:
        page = self.free.pop()
        slot = int(self.seq_lens[seq]) // PAGE_TOKENS
        self.block_table[seq, slot] = page
        return page

    def append_token(self, seq: int, layer_k, layer_v):
        """layer_k/v: (L, KV, HD) for one token. Allocates pages on demand."""
        pos = int(self.seq_lens[seq])
        if pos % PAGE_TOKENS == 0:
            self.alloc_page(seq)
        page = int(self.block_table[seq, pos // PAGE_TOKENS])
        off = pos % PAGE_TOKENS
        self.k[:, page, off] = layer_k
        self.v[:, page, off] = layer_v
        self.seq_lens[seq] = pos + 1

    def gather(self, seq: int, max_len: int):
        """Contiguous (L, max_len, KV, HD) view for the dense attention path."""
        n_pages = (max_len + PAGE_TOKENS - 1) // PAGE_TOKENS
        pages = self.block_table[seq, :n_pages]
        pages = torch.tensor(np.where(pages < 0, 0, pages), dtype=torch.long, device=self.k.device)
        k = self.k[:, pages].reshape(self.k.shape[0], -1, *self.k.shape[3:])[:, :max_len]
        v = self.v[:, pages].reshape(self.v.shape[0], -1, *self.v.shape[3:])[:, :max_len]
        return k, v

    @property
    def n_pool_pages(self) -> int:
        return self.k.shape[1]
