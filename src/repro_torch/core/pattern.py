"""DFA access-pattern classifier (Section IV-C, after UVMSmart).

Scans the 64KB basic-block migration stream of a window, measures the
linearity/randomness of block address transitions and re-referencing across
kernel boundaries, and classifies into 6 categories:

    0 Linear/Streaming   3 Linear Reuse/Regular
    1 Random             4 Random Reuse
    2 Mixed/Irregular    5 Mixed Reuse
"""
from __future__ import annotations

import numpy as np

LINEAR, RANDOM, MIXED, LINEAR_REUSE, RANDOM_REUSE, MIXED_REUSE = range(6)

NAMES = ["Linear/Streaming", "Random", "Mixed/Irregular", "Linear Reuse", "Random Reuse", "Mixed Reuse"]


class PatternClassifier:
    def __init__(self, lin_hi: float = 0.6, lin_lo: float = 0.3, reref_thr: float = 0.2):
        self.lin_hi, self.lin_lo, self.reref_thr = lin_hi, lin_lo, reref_thr
        self.seen_by_kernel: dict[int, set[int]] = {}

    def classify(self, blocks: np.ndarray, kernels: np.ndarray) -> int:
        blocks = np.asarray(blocks)
        if len(blocks) < 2:
            return LINEAR
        d = np.diff(blocks.astype(np.int64))
        # linearity = stride dominance: streaming (even interleaved multi-array
        # streaming) is covered by a handful of fixed strides; random gather
        # spreads over many distinct deltas.
        _, counts = np.unique(d, return_counts=True)
        top = np.sort(counts)[::-1][:3].sum()
        lin = float(top / len(d))

        # re-reference across kernel boundaries
        reref = 0
        total = 0
        for b, k in zip(blocks, kernels):
            k = int(k)
            prev = any(b in s for kk, s in self.seen_by_kernel.items() if kk < k)
            reref += prev
            total += 1
            self.seen_by_kernel.setdefault(k, set()).add(int(b))
        rr = reref / max(total, 1)

        if lin >= self.lin_hi:
            base = LINEAR
        elif lin <= self.lin_lo:
            base = RANDOM
        else:
            base = MIXED
        return base + 3 if rr >= self.reref_thr else base

    def reset(self):
        self.seen_by_kernel.clear()
