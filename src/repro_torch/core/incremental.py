"""The predictor's trainer: strictly causal evaluation and the fine-tune
bookkeeping of one group (Sections IV-B, V-A/B).

This slice ports serving: :meth:`Trainer.evaluate` and a frozen
:meth:`Trainer.train_group` (``TrainConfig.epochs == 0``), which keeps the
JAX package's bookkeeping exactly (optimizer state initialised to zeros,
``step`` unchanged, ``n_updates + 1``) and changes no weight.  Training
with ``epochs > 0`` is queued as the training slice (ROADMAP.md, queue A,
item 4).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.predictor_paper import PredictorConfig
from repro_torch.core import predictor
from repro_torch.core.features import FeatureSet
from repro_torch.core.model_table import Entry
from repro_torch.device import resolve_device
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainConfig:
    group_size: int = 2048  # accesses per train/predict group (paper: 50M instr)
    epochs: int = 3
    batch_size: int = 256
    lr: float = 3e-3
    seed: int = 0
    table_slots: int = 8


class Trainer:
    """Evaluation and frozen fine-tune bookkeeping for the transformer
    predictor on one device."""

    def __init__(self, pcfg: PredictorConfig, tcfg: TrainConfig, kind: str = "transformer",
                 device: str | torch.device = "cuda"):
        if kind != "transformer":
            raise NotImplementedError(f"predictor kind {kind!r} is not ported yet (only 'transformer')")
        self.pcfg, self.tcfg, self.kind = pcfg, tcfg, kind
        self.device = resolve_device(device)

    def new_params(self, seed: int = 0) -> dict:
        return predictor.init(seed, self.pcfg, self.device)

    def _eval_schedule(self, n: int) -> np.ndarray:
        """Batch-index rows for one group: consecutive batches of
        ``batch_size``, the last one padded with index 0 (its extra rows
        are sliced off), as in the JAX package."""
        B = self.tcfg.batch_size
        rows = []
        for lo in range(0, n, B):
            idx = np.arange(lo, min(lo + B, n))
            rows.append(np.concatenate([idx, np.zeros(B - len(idx), int)]))
        return np.stack(rows).astype(np.int64)

    def _stage(self, fs: FeatureSet) -> tuple[dict, torch.Tensor]:
        to = lambda a: torch.tensor(np.asarray(a), device=self.device)
        return {k: to(getattr(fs, k)) for k in ("page", "delta", "pc", "tb")}, to(fs.label)

    @torch.no_grad()
    def evaluate(self, params, fs: FeatureSet, n_active: int):
        """Top-1 correctness per sample + predicted class ids (numpy), with
        one host sync for the whole group."""
        n = len(fs)
        if n == 0:
            return np.zeros(0, bool), np.zeros(0, np.int32)
        feats, labels = self._stage(fs)
        pidx = torch.tensor(self._eval_schedule(n), device=self.device)
        correct, pred = [], []
        for idx in pidx:
            logits, _ = predictor.forward(params, {k: v[idx] for k, v in feats.items()}, self.pcfg)
            p = predictor.mask_inactive(logits, n_active).argmax(dim=-1)
            pred.append(p)
            correct.append(p == labels[idx])
        correct = torch.cat(correct)[:n].cpu().numpy()
        pred = torch.cat(pred)[:n].to(torch.int32).cpu().numpy()
        return correct, pred

    def train_group(self, entry: Entry, fs: FeatureSet, n_active: int, *, in_et=None, use_lucir=False, rng=None):
        """Fine-tune on one group.  Only the frozen case (``epochs == 0``) is
        ported: it initialises the optimizer state if missing, takes no
        step, and counts the update, exactly as the JAX package does."""
        if self.tcfg.epochs > 0:
            raise NotImplementedError(
                "training (TrainConfig.epochs > 0) is not ported yet: it is the training slice, "
                "ROADMAP.md queue A item 4; use epochs=0 for a frozen-model run")
        if entry.opt_state is None:
            entry.opt_state = adamw.init(entry.params)
        if len(fs) == 0:
            return entry
        entry.n_updates += 1
        return entry
