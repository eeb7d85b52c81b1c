"""Pattern-based model table (Section IV-C).

A direct-mapped cache of per-pattern predictor weights: indexed by a hash of
the access-pattern id, returning that pattern's weights (plus the previous
snapshot needed by the LUCIR term, and the optimizer state so fine-tuning
resumes).  Params are flat ``dict[str, Tensor]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any


def clone_tree(tree):
    """Independent copy of a params dict (or an ``OptState`` of them)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: v.clone() for k, v in tree.items()}
    return type(tree)(*(clone_tree(x) for x in tree))


@dataclasses.dataclass
class Entry:
    params: Any
    prev_params: Any | None = None  # previous model (LUCIR distillation target)
    opt_state: Any | None = None
    step: int = 0
    n_updates: int = 0
    last_acc: float = 0.0  # top-1 on the most recent group (prefetch gate)


class ModelTable:
    def __init__(self, init_fn, n_slots: int = 8):
        self.init_fn = init_fn  # (slot_seed) -> params
        self.n_slots = n_slots
        self.slots: dict[int, Entry] = {}
        self.hits = 0
        self.misses = 0

    def slot_of(self, pattern_id: int) -> int:
        return hash(pattern_id) % self.n_slots

    def get(self, pattern_id: int) -> Entry:
        s = self.slot_of(pattern_id)
        if s not in self.slots:
            self.misses += 1
            self.slots[s] = Entry(params=self.init_fn(s))
        else:
            self.hits += 1
        return self.slots[s]

    def put(self, pattern_id: int, entry: Entry):
        self.slots[self.slot_of(pattern_id)] = entry

    def snapshot_prev(self, pattern_id: int):
        """Store the current weights as the LUCIR distillation target."""
        e = self.get(pattern_id)
        e.prev_params = clone_tree(e.params)

    def clone(self) -> "ModelTable":
        """Independent copy (runs fine-tune entries in place; benchmarks
        reusing one pretrained table must not leak state across runs)."""
        t = ModelTable(self.init_fn, self.n_slots)
        for s, e in self.slots.items():
            t.slots[s] = Entry(
                params=clone_tree(e.params),
                prev_params=clone_tree(e.prev_params),
                opt_state=clone_tree(e.opt_state),
                step=e.step,
                n_updates=e.n_updates,
                last_acc=e.last_acc,
            )
        return t

    @property
    def n_models(self) -> int:
        return len(self.slots)
