"""Training protocols for the page predictor (Sections III-C, IV-B, V-A/B),
port of ``repro.core.incremental``.

  * online_single — ONE model, plain CE, train on group k-1 / predict group k
                    (the existing-learning-based-works protocol, Fig. 4).
  * online_multi  — pattern-aware model table, plain CE (Fig. 6 'multiple').
  * ours          — pattern-aware table + LUCIR distillation + (optionally)
                    the thrashing term (the full Section IV design).
  * offline       — train one model on a random 50% of samples (future info!)
                    then predict everything in temporal order: the paper's
                    upper bound (Figs. 4/11).

Every protocol measures top-1 accuracy on a group BEFORE the model trains on
it (strictly causal evaluation).

:class:`Trainer` evaluates and fine-tunes the transformer predictor on one
device.  A fine-tune step is a forward, :func:`repro_torch.core.losses.
train_loss` (CE and the thrashing term through the ``thrash_ce`` kernel,
LUCIR beside it), a backward (through the attention backward kernel on the
card) and a functional AdamW update.  The JAX package scans a schedule
padded to a power-of-two bucket of steps whose padding rows are no-ops; the
port loops over the real rows only.  The LSTM, CNN and MLP baselines
(``core/baselines_nn.py``) are not ported: ``kind`` must be
``"transformer"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.predictor_paper import PredictorConfig
from repro_torch.core import losses, predictor
from repro_torch.core.features import DeltaVocab, FeatureSet, FeatureStream
from repro_torch.core.model_table import Entry, ModelTable
from repro_torch.core.pattern import PatternClassifier
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.util import pow2_bucket
from repro_torch.uvm.trace import Trace


@dataclasses.dataclass
class TrainConfig:
    group_size: int = 2048  # accesses per train/predict group (paper: 50M instr)
    epochs: int = 3
    batch_size: int = 256
    lr: float = 3e-3
    seed: int = 0
    table_slots: int = 8


class Trainer:
    """Evaluation and fine-tuning of the transformer predictor on one device."""

    def __init__(self, pcfg: PredictorConfig, tcfg: TrainConfig, kind: str = "transformer",
                 device: str | torch.device = "cuda"):
        if kind != "transformer":
            raise NotImplementedError(f"predictor kind {kind!r} is not ported yet (only 'transformer')")
        self.pcfg, self.tcfg, self.kind = pcfg, tcfg, kind
        self.device = resolve_device(device)
        self.opt = adamw.adamw(tcfg.lr, weight_decay=0.01)

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

    #: the JAX package stacks a bucket of lanes into one vmapped dispatch
    #: from this many lanes on; below it, it runs them one by one
    MIN_VMAP_LANES = 4

    def evaluate_many(self, params_list: list, fs_list: list, n_active_list: list) -> list:
        """:meth:`evaluate` across lanes (one model and feature group per
        lane: a mux's tenants, or many benchmarks), one ``(correct, pred)``
        per lane; an empty lane gives empty arrays.  Every lane runs through
        :meth:`evaluate` in turn, which is what the JAX package does below
        ``MIN_VMAP_LANES`` lanes a bucket; stacking a bucket into one
        launch per kernel belongs with ``run_ours_many`` (ROADMAP A2)."""
        return [self.evaluate(p, fs, na) for p, fs, na in zip(params_list, fs_list, n_active_list)]

    def train_group_many(self, entries: list, fs_list: list, n_active_list: list, *, in_et_list=None,
                         use_lucir=False) -> list:
        """:meth:`train_group` across lanes (one entry and group per lane),
        entries updated in place.  An empty lane is skipped (its optimizer
        state stays unset, its ``n_updates`` unbumped); the others get their
        optimizer state first, then train one by one in the JAX package's
        bucket order (sample bucket, step bucket, LUCIR eligibility, thrash
        flags present).  As in :meth:`evaluate_many`, one launch per bucket
        waits for ``run_ours_many`` (ROADMAP A2)."""
        tc = self.tcfg
        in_et_list = in_et_list if in_et_list is not None else [None] * len(entries)
        buckets: dict = {}
        for i, (entry, fs) in enumerate(zip(entries, fs_list)):
            n = len(fs)
            if n == 0:
                continue
            if entry.opt_state is None:
                entry.opt_state = self.opt.init(entry.params)
            use_l = use_lucir and entry.prev_params is not None
            n_steps = len(self._train_schedule(n, np.random.default_rng(tc.seed)))
            key = (pow2_bucket(n, 1024), pow2_bucket(n_steps, 16), use_l, in_et_list[i] is not None)
            buckets.setdefault(key, []).append(i)
        for lanes in buckets.values():
            for i in lanes:
                self.train_group(entries[i], fs_list[i], n_active_list[i], in_et=in_et_list[i], use_lucir=use_lucir)
        return entries

    @torch.no_grad()
    def old_features(self, prev_params, fs: FeatureSet, idx):
        """The previous model's features of the samples ``idx`` (LUCIR's
        target), or None without a previous model."""
        if prev_params is None:
            return None
        feats, _ = self._stage(fs)
        idx = torch.as_tensor(np.asarray(idx), device=self.device)
        return predictor.forward(prev_params, {k: v[idx] for k, v in feats.items()}, self.pcfg)[1]

    def _train_schedule(self, n: int, rng) -> np.ndarray:
        """Batch-index rows of one group's fine-tune (per-epoch permutation,
        full batches only, a tiny group resized to one batch): the JAX
        package's rng call sequence, without its padding rows."""
        tc = self.tcfg
        rows = []
        for _ in range(tc.epochs):
            order = rng.permutation(n)
            for lo in range(0, n - tc.batch_size + 1, tc.batch_size):
                rows.append(order[lo : lo + tc.batch_size])
            if n < tc.batch_size:  # tiny group: single padded batch
                rows.append(np.resize(order, tc.batch_size))
        return np.stack(rows).astype(np.int64) if rows else np.zeros((0, tc.batch_size), np.int64)

    def _train_step(self, params, opt_state, batch, labels, n_active: int, step: int, f_old, in_et, n_et: int):
        """One AdamW step on one batch; returns (params, opt_state, metrics)
        with the loss (``"total"``) and the gradient's global norm before
        clipping (``"grad_norm"``), both on the device."""
        keys = list(params)
        with torch.enable_grad():
            leaves = [params[k].detach().requires_grad_(True) for k in keys]
            logits, f = predictor.forward(dict(zip(keys, leaves)), batch, self.pcfg)
            loss = losses.train_loss(logits, f, labels, n_active=n_active, f_old=f_old, in_et=in_et, n_et=n_et,
                                     lam=self.pcfg.lucir_lambda, mu=self.pcfg.thrash_mu)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, grads)}
        updates, opt_state, gnorm = self.opt.update(grads, opt_state, params, step)
        return adamw.apply_updates(params, updates), opt_state, {"total": loss.detach(), "grad_norm": gnorm}

    def train_group(self, entry: Entry, fs: FeatureSet, n_active: int, *, in_et=None, use_lucir=False, rng=None):
        """Fine-tune on one group (``TrainConfig.epochs`` epochs of full
        batches).  ``in_et``: per-sample E∪T flags (the thrashing term), or
        None; ``use_lucir``: distil from ``entry.prev_params`` when it has
        one.  Counts the steps and the update as the JAX package does, also
        when there is no step (``epochs == 0``)."""
        tc = self.tcfg
        if entry.opt_state is None:
            entry.opt_state = self.opt.init(entry.params)
        n = len(fs)
        if n == 0:
            return entry
        rng = np.random.default_rng(tc.seed if rng is None else rng)
        use_l = use_lucir and entry.prev_params is not None
        rows = self._train_schedule(n, rng)
        if len(rows):
            feats, labels = self._stage(fs)
            idx = torch.tensor(rows, device=self.device)
            et_np = None if in_et is None else np.asarray(in_et, bool)
            et = None if et_np is None else torch.tensor(et_np.astype(np.int32), device=self.device)
            params, opt_state = entry.params, entry.opt_state
            for i, row in enumerate(rows):
                bidx = idx[i]
                batch = {k: v[bidx] for k, v in feats.items()}
                f_old = None
                if use_l:
                    with torch.no_grad():
                        f_old = predictor.forward(entry.prev_params, batch, self.pcfg)[1]
                bet, n_et = (None, 0) if et is None else (et[bidx], int(np.count_nonzero(et_np[row])))
                params, opt_state, _ = self._train_step(params, opt_state, batch, labels[bidx], n_active,
                                                        entry.step + i, f_old, bet, n_et)
            entry.params, entry.opt_state = params, opt_state
        entry.step += len(rows)
        entry.n_updates += 1
        return entry


@dataclasses.dataclass
class RunResult:
    top1: float
    per_group: list
    n_classes: int
    n_models: int
    n_samples: int
    predictions: np.ndarray  # predicted class id per sample
    t_index: np.ndarray
    correct: np.ndarray


def run_protocol(
    trace: Trace,
    pcfg: PredictorConfig,
    tcfg: TrainConfig,
    *,
    mode: str = "ours",
    kind: str = "transformer",
    in_et_flags: np.ndarray | None = None,  # per-access E∪T membership (thrash term)
    table: ModelTable | None = None,
    device: str | torch.device = "cuda",
) -> RunResult:
    assert mode in ("online_single", "online_multi", "ours", "offline")
    trainer = Trainer(pcfg, tcfg, kind, device)
    vocab = DeltaVocab(pcfg.delta_vocab)
    stream = FeatureStream(trace, vocab, pcfg.history, page_vocab=pcfg.page_vocab, pc_vocab=pcfg.pc_vocab,
                           tb_vocab=pcfg.tb_vocab)
    classifier = PatternClassifier()

    if mode == "offline":
        fs = stream.windows(0, len(trace))
        n_active = max(vocab.n_classes, 2)
        rng = np.random.default_rng(tcfg.seed)
        train_idx = rng.permutation(len(fs))[: len(fs) // 2]
        entry = Entry(params=trainer.new_params(tcfg.seed))
        half = FeatureSet(*(getattr(fs, f.name)[train_idx] for f in dataclasses.fields(fs)))
        for _ in range(3):  # extra passes — it has future knowledge anyway
            entry = trainer.train_group(entry, half, n_active)
        correct, pred = trainer.evaluate(entry.params, fs, n_active)
        return RunResult(float(correct.mean()), [float(correct.mean())], vocab.n_classes, 1, len(fs), pred,
                         fs.t_index, correct)

    if table is None:
        table = ModelTable(lambda s: trainer.new_params(s), n_slots=tcfg.table_slots)
    multi = mode in ("online_multi", "ours")
    use_lucir = mode == "ours"

    n = len(trace)
    G = tcfg.group_size
    per_group = []
    all_correct = np.zeros(0, bool)
    all_pred = np.zeros(0, np.int32)
    all_t = np.zeros(0, np.int32)
    for g0 in range(0, n, G):
        g1 = min(g0 + G, n)
        fs = stream.windows(g0, g1)
        if len(fs) == 0:
            continue
        n_active = max(vocab.n_classes, 2)
        pat = classifier.classify(trace.block[g0:g1], trace.kernel[g0:g1]) if multi else 0
        entry = table.get(pat)
        correct, pred = trainer.evaluate(entry.params, fs, n_active)  # predict BEFORE training
        per_group.append(float(correct.mean()))
        all_correct = np.concatenate([all_correct, correct])
        all_pred = np.concatenate([all_pred, pred])
        all_t = np.concatenate([all_t, fs.t_index])
        if use_lucir:
            table.snapshot_prev(pat)
            entry = table.get(pat)
        in_et = in_et_flags[fs.t_index] if in_et_flags is not None and mode == "ours" else None
        entry = trainer.train_group(entry, fs, n_active, in_et=in_et, use_lucir=use_lucir)
        table.put(pat, entry)

    top1 = float(all_correct.mean()) if len(all_correct) else 0.0
    return RunResult(top1, per_group, vocab.n_classes, table.n_models, len(all_correct), all_pred, all_t,
                     all_correct)
