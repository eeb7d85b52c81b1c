"""UVMSmart baseline (Ganguly et al., DATE'21), the paper's SOTA comparison
(port of ``repro.uvm.uvmsmart``).

An adaptive runtime with (1) a DFA detection engine over interconnect
traffic, (2) a dynamic policy engine choosing among existing policies, and
(3) delayed migration / pinning, against the simulator:

  per epoch (kernel segment):
    streaming      -> demand migration + LRU (prefetch garbage hurts streams)
    random(+reuse) -> pin the coldest blocks of the epoch (zero-copy) when
                      oversubscribed, migrate the hot ones
    regular/mixed  -> tree prefetcher + LRU (CUDA's default behaviour)

Pinning persists across epochs.  The simulator state lives on ``device``;
the classification and the choice of cold blocks are host numpy, as in the
reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pattern import LINEAR, RANDOM, RANDOM_REUSE, PatternClassifier
from repro_torch.device import resolve_device
from repro_torch.uvm import simulator as S
from repro_torch.uvm.trace import Trace


def run_uvmsmart(trace: Trace, *, oversubscription: float = 1.25, epoch: int = 2048, seed: int = 0,
                 device: str | torch.device = "cuda") -> dict:
    nb = S.bucket_blocks(trace.n_blocks)
    cap = S.capacity_for(trace.n_blocks, oversubscription)
    state = S.init_state(nb, resolve_device(device), seed)
    classifier = PatternClassifier()
    blocks = trace.block.astype(np.int32)
    nxt = S.next_use_for(trace)

    n = len(trace)
    for lo in range(0, n, epoch):
        hi = min(lo + epoch, n)
        pat = classifier.classify(blocks[lo:hi], trace.kernel[lo:hi])
        if pat in (RANDOM, RANDOM_REUSE):
            # delayed migration: pin this epoch's coldest blocks (zero-copy)
            uniq, counts = np.unique(blocks[lo:hi], return_counts=True)
            cold = uniq[counts <= max(np.percentile(counts, 30), 1)]
            pinned = state.pinned.clone()
            pinned[torch.as_tensor(cold, dtype=torch.int64, device=state.device)] = True
            state = dataclasses.replace(state, pinned=pinned)
            policy, prefetch = "lru", "demand"
        elif pat == LINEAR:
            policy, prefetch = "lru", "demand"
        else:  # regular / mixed / reuse
            policy, prefetch = "lru", "tree"
        state, _ = S.run_segment(
            state, blocks[lo:hi], nxt[lo:hi], capacity=cap, policy=policy, prefetch=prefetch,
            n_valid=trace.n_blocks, want_outs=False,  # the epoch loop only carries the state
        )
    return S.state_stats(state)
