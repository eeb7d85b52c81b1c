"""Seeded fault injection for the streaming manager (the chaos harness;
port of ``repro.uvm.manager.chaos``).

Robustness claims need reproducible failures: :class:`FaultInjector`
wraps the manager's collaborators — the trainer, the frequency table, the
serve sidecar's input line stream — and injects faults drawn from ONE
seeded generator according to a declarative :class:`ChaosSchedule`, so a
chaos run replays bit-for-bit from ``(schedule, input)``.

Injected fault classes (each an independent per-event probability):

* ``trainer_exc`` — ``evaluate``/``evaluate_many`` raises :class:`ChaosError`
  (a dispatch failure: the health machine must degrade, not crash);
* ``nan_output`` — the predictor returns NaN float arrays (caught by
  ``check_result``'s output validation);
* ``train_exc`` — ``train_group``/``train_group_many`` raises (a lost
  fine-tune: the round must still close);
* ``nan_params`` — a fine-tuned entry's params are NaN-poisoned (caught
  by ``guard_dispatch``'s pre-dispatch finiteness check, which
  quarantines + re-initializes the slot);
* ``drop_batch`` / ``dup_batch`` / ``reorder_batch`` — observe lines
  vanish, repeat, or arrive late (stream-transport faults);
* ``lose_feedback`` / ``delay_feedback`` — outcome reports vanish or
  arrive after later lines (the manager's auto-close path must cope);
* ``drop_freq_update`` — frequency-table updates are silently lost
  (degraded telemetry, not an error: actions stay well-formed).

Wire-up (the reference's ``cli serve --inject`` flags do exactly this)::

    inj = FaultInjector(ChaosSchedule.parse("trainer_exc=0.3,seed=7"))
    mux.trainer = inj.wrap_trainer(mux.trainer)
    for line in inj.transform_lines(fh): ...
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from pathlib import Path

import numpy as np
import torch


class ChaosError(RuntimeError):
    """The injected dispatch failure (distinguishable from real bugs)."""


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """Declarative, seedable fault plan — the full specification of one
    chaos run.  Frozen so a schedule can never drift mid-run; JSON
    round-trippable (:meth:`to_dict`) for experiment records."""

    seed: int = 0
    trainer_exc: float = 0.0
    nan_output: float = 0.0
    train_exc: float = 0.0
    nan_params: float = 0.0
    drop_batch: float = 0.0
    dup_batch: float = 0.0
    reorder_batch: float = 0.0
    lose_feedback: float = 0.0
    delay_feedback: float = 0.0
    drop_freq_update: float = 0.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name == "seed":
                continue
            v = getattr(self, f.name)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"chaos probability {f.name}={v} outside [0, 1]")

    @classmethod
    def parse(cls, spec: str) -> "ChaosSchedule":
        """``'trainer_exc=0.3,nan_output=0.1,seed=7'`` inline, or
        ``'@plan.json'`` to load a JSON dict from disk."""
        if spec.startswith("@"):
            d = json.loads(Path(spec[1:]).read_text())
        else:
            d = {}
            for part in filter(None, (p.strip() for p in spec.split(","))):
                key, sep, val = part.partition("=")
                if not sep:
                    raise ValueError(f"chaos spec entry {part!r} is not key=value")
                d[key] = val
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown chaos keys {sorted(unknown)}; known: {sorted(known)}")
        typed = {k: int(v) if k == "seed" else float(v) for k, v in d.items()}
        return cls(**typed)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _nan_like(tree):
    """NaN-poison every floating leaf of a tree of tensors or arrays (ints
    pass through); a tensor stays a tensor on its device."""
    if isinstance(tree, dict):
        return {k: _nan_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_nan_like(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if isinstance(tree, torch.Tensor):
        return torch.full_like(tree, float("nan")) if tree.is_floating_point() else tree
    a = np.asarray(tree)
    return np.full_like(a, np.nan) if np.issubdtype(a.dtype, np.floating) else a


class _ChaosTrainer:
    """Delegating trainer proxy: same dispatch surface, injected faults."""

    def __init__(self, inner, injector: "FaultInjector"):
        self._inner = inner
        self._injector = injector

    def __getattr__(self, name):  # new_params, cfg, caches, ... pass through
        return getattr(self._inner, name)

    def evaluate(self, params, fs, n_active):
        if self._injector._fire("trainer_exc"):
            raise ChaosError("injected trainer exception (evaluate)")
        corr, pred = self._inner.evaluate(params, fs, n_active)
        if self._injector._fire("nan_output"):
            return np.full(len(np.asarray(corr)), np.nan), np.full(len(np.asarray(pred)), np.nan)
        return corr, pred

    def evaluate_many(self, params_list, fs_list, n_active_list):
        if self._injector._fire("trainer_exc"):
            raise ChaosError("injected trainer exception (evaluate_many)")
        out = self._inner.evaluate_many(params_list, fs_list, n_active_list)
        return [
            (np.full(len(np.asarray(c)), np.nan), np.full(len(np.asarray(p)), np.nan))
            if self._injector._fire("nan_output") else (c, p)
            for c, p in out
        ]

    def train_group(self, entry, fs, n_active, **kw):
        if self._injector._fire("train_exc"):
            raise ChaosError("injected trainer exception (train_group)")
        entry = self._inner.train_group(entry, fs, n_active, **kw)
        if self._injector._fire("nan_params"):
            entry.params = _nan_like(entry.params)
        return entry

    def train_group_many(self, entries, fs_list, n_active_list, **kw):
        if self._injector._fire("train_exc"):
            raise ChaosError("injected trainer exception (train_group_many)")
        out = self._inner.train_group_many(entries, fs_list, n_active_list, **kw)
        for entry in entries:
            if self._injector._fire("nan_params"):
                entry.params = _nan_like(entry.params)
        return out


class _ChaosFreqTable:
    """Delegating frequency-table proxy dropping a fraction of updates."""

    def __init__(self, inner, injector: "FaultInjector"):
        self._inner = inner
        self._injector = injector

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def update(self, blocks):
        if self._injector._fire("drop_freq_update"):
            return
        self._inner.update(blocks)


class FaultInjector:
    """One seeded RNG driving every injection site, so a chaos run is a
    pure function of ``(schedule, input stream)``.  ``counts`` tallies
    what actually fired (the chaos suite asserts on it)."""

    def __init__(self, schedule: ChaosSchedule):
        self.schedule = schedule
        self.rng = np.random.default_rng(schedule.seed)
        self.counts: Counter = Counter()

    def _fire(self, key: str) -> bool:
        p = getattr(self.schedule, key)
        if p <= 0.0:
            return False  # zero-probability sites consume no randomness
        hit = bool(self.rng.random() < p)
        if hit:
            self.counts[key] += 1
        return hit

    def wrap_trainer(self, trainer) -> _ChaosTrainer:
        return _ChaosTrainer(trainer, self)

    def wrap_freq_table(self, table) -> _ChaosFreqTable:
        return _ChaosFreqTable(table, self)

    def transform_lines(self, lines):
        """Apply the stream-transport faults to an iterable of serve JSONL
        lines: observe lines drop/duplicate/reorder, feedback lines get
        lost or delayed.  Held (reordered/delayed) lines are re-delivered
        right after the next delivered line; blanks and comments pass
        through untouched (they consume no randomness)."""
        held: list = []
        for line in lines:
            s = line.strip()
            if not s or s.startswith("#"):
                yield line
                continue
            if '"feedback"' in s:
                if self._fire("lose_feedback"):
                    continue
                if self._fire("delay_feedback"):
                    held.append(line)
                    continue
                yield line
            else:
                if self._fire("drop_batch"):
                    continue
                if self._fire("reorder_batch"):
                    held.append(line)
                    continue
                yield line
                if self._fire("dup_batch"):
                    yield line
            while held:
                yield held.pop(0)
        yield from held
