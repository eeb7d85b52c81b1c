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

:class:`Trainer` evaluates and fine-tunes a predictor of any registered
``kind`` (``transformer``, or the LSTM, CNN and MLP baselines of
``core/baselines_nn.py``) on one device.  A fine-tune step is a forward, :func:`repro_torch.core.losses.
train_loss` (CE and the thrashing term through the ``thrash_ce`` kernel,
LUCIR beside it), a backward (through the attention backward kernel on the
card) and a functional AdamW update.  The JAX package scans a schedule
padded to a power-of-two bucket of steps whose padding rows are no-ops; the
port loops over the real rows only.  Many lanes (a mux's tenants, a
server's sessions, many benchmarks) go through :meth:`Trainer.evaluate_many`
and :meth:`Trainer.train_group_many`, which stack a bucket of transformer
lanes so that the attention launches once per block and layer for all of
them, each lane's results bit for bit its own call's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.predictor_paper import PredictorConfig
from repro_torch.core import losses, predictor
from repro_torch.core.baselines_nn import make_model
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
    """Evaluation and fine-tuning of a predictor of a registered ``kind`` on
    one device."""

    def __init__(self, pcfg: PredictorConfig, tcfg: TrainConfig, kind: str = "transformer",
                 device: str | torch.device = "cuda"):
        self.pcfg, self.tcfg, self.kind = pcfg, tcfg, kind
        self.device = resolve_device(device)
        self.init_fn, self.forward = make_model(pcfg, kind)
        self.opt = adamw.adamw(tcfg.lr, weight_decay=0.01)

    def new_params(self, seed: int = 0) -> dict:
        """The JAX package's ``new_params(seed)``: its initial weights for
        ``jax.random.key(seed)``."""
        return self.init_fn(seed, self.device)

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

    def evaluate(self, params, fs: FeatureSet, n_active: int):
        """Top-1 correctness per sample + predicted class ids (numpy), with
        one host sync for the whole group."""
        if len(fs) == 0:
            return np.zeros(0, bool), np.zeros(0, np.int32)
        return self._evaluate_bucket([params], [fs], [n_active])[0]

    #: from this many lanes of one bucket on, :meth:`evaluate_many` stacks
    #: them (the JAX package's threshold for its vmapped dispatch); below
    #: it, it runs them one by one
    MIN_VMAP_LANES = 4

    def evaluate_many(self, params_list: list, fs_list: list, n_active_list: list) -> list:
        """:meth:`evaluate` across lanes (one model and feature group per
        lane: a mux's tenants, a server's sessions, or many benchmarks), one
        ``(correct, pred)`` per lane; an empty lane gives empty arrays.

        The lanes are bucketed as the JAX package buckets them, by
        ``(pow2_bucket(n, 1024), its padded schedule rows)``.  A bucket of
        fewer than ``MIN_VMAP_LANES`` lanes, or of a kind other than
        ``transformer`` (which launch no attention), runs through
        :meth:`evaluate` lane by lane.  A larger transformer bucket is
        stacked: for each eval-schedule row one
        :func:`~repro_torch.core.predictor.forward_many` covers every lane
        that has the row, so the attention launches once per block and
        layer for the whole bucket, and the bucket has one host sync.
        Every lane's results are bit for bit its :meth:`evaluate`'s.  The
        bucket is not padded to a power of two of lanes (the JAX package
        pads it to reuse a compiled shape, which the port has no use for)."""
        results: list = [None] * len(fs_list)
        buckets: dict = {}
        for i, fs in enumerate(fs_list):
            n = len(fs)
            if n == 0:
                results[i] = self.evaluate(params_list[i], fs, n_active_list[i])
                continue
            rows = -(-n // self.tcfg.batch_size)
            buckets.setdefault((pow2_bucket(n, 1024), pow2_bucket(rows, 8)), []).append(i)
        for lanes in buckets.values():
            stack = len(lanes) >= self.MIN_VMAP_LANES and self.kind == "transformer"
            for group in [lanes] if stack else [[i] for i in lanes]:
                args = ([a[i] for i in group] for a in (params_list, fs_list, n_active_list))
                for i, res in zip(group, self._evaluate_bucket(*args)):
                    results[i] = res
        return results

    @torch.no_grad()
    def _evaluate_bucket(self, params_list: list, fs_list: list, n_active_list: list) -> list:
        """:meth:`evaluate` of non-empty lanes in one pass over their
        schedule rows, with one host sync for all of them.  Several lanes
        are for the transformer kind only: each row's lanes share one
        :func:`~repro_torch.core.predictor.forward_many`."""
        staged = [self._stage(fs) for fs in fs_list]
        pidx = [torch.tensor(self._eval_schedule(len(fs)), device=self.device) for fs in fs_list]
        correct: list = [[] for _ in fs_list]
        pred: list = [[] for _ in fs_list]
        for r in range(max(len(p) for p in pidx)):
            lanes = [j for j, p in enumerate(pidx) if r < len(p)]
            params = [params_list[j] for j in lanes]
            batches = [{k: v[pidx[j][r]] for k, v in staged[j][0].items()} for j in lanes]
            for j, (logits, _) in zip(lanes, self._forward_many(params, batches)):
                p = predictor.mask_inactive(logits, n_active_list[j]).argmax(dim=-1)
                pred[j].append(p)
                correct[j].append(p == staged[j][1][pidx[j][r]])
        ns = [len(fs) for fs in fs_list]
        flat_c = torch.cat([torch.cat(c)[:n] for c, n in zip(correct, ns)]).cpu().numpy()
        flat_p = torch.cat([torch.cat(p)[:n] for p, n in zip(pred, ns)]).to(torch.int32).cpu().numpy()
        bounds = np.cumsum([0, *ns])
        return [(flat_c[lo:hi], flat_p[lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:])]

    def train_group_many(self, entries: list, fs_list: list, n_active_list: list, *, in_et_list=None,
                         use_lucir=False) -> list:
        """:meth:`train_group` across lanes (one entry and group per lane),
        entries updated in place; an empty lane is skipped (its optimizer
        state stays unset, its ``n_updates`` unbumped).

        The lanes are bucketed as the JAX package buckets them, by
        ``(pow2_bucket(n, 1024), pow2_bucket(n_steps, 16), LUCIR
        eligibility, thrash flags present)``, and the buckets run in the
        order of their first lane.  A bucket of fewer than
        ``MIN_VMAP_LANES`` lanes, or of a kind other than ``transformer``,
        runs through :meth:`train_group` lane by lane.  A larger
        transformer bucket is stacked (:meth:`_train_lanes`): step ``r``
        runs the lanes whose own schedule has a row ``r`` through one
        forward and one backward, so the attention and its backward launch
        once per block and layer for all of them, while each lane keeps its
        own loss (one ``thrash_ce`` launch, its own ``mu`` and
        ``n_active``), gradient clipping and AdamW step at its own step
        number.  Every lane's params, moments, ``step`` and ``n_updates``
        are bit for bit its :meth:`train_group`'s.  A stacked bucket writes
        its entries only after its last step, so a bucket that raises
        leaves them as they were (the JAX package's vmapped dispatch is as
        atomic); one ``Entry`` twice in a stacked bucket raises
        ``ValueError`` before any lane trains."""
        tc = self.tcfg
        in_et_list = in_et_list if in_et_list is not None else [None] * len(entries)
        buckets: dict = {}
        for i, (entry, fs) in enumerate(zip(entries, fs_list)):
            n = len(fs)
            if n == 0:
                continue
            use_l = use_lucir and entry.prev_params is not None
            rows = self._train_schedule(n, np.random.default_rng(tc.seed))
            key = (pow2_bucket(n, 1024), pow2_bucket(len(rows), 16), use_l, in_et_list[i] is not None)
            buckets.setdefault(key, []).append((i, rows))
        stack = lambda lanes: len(lanes) >= self.MIN_VMAP_LANES and self.kind == "transformer"
        for lanes in buckets.values():
            if stack(lanes) and len({id(entries[i]) for i, _ in lanes}) < len(lanes):
                raise ValueError("train_group_many: one Entry is in a stacked bucket twice; serial train_group "
                                 "calls would train it twice and the JAX package's vmap would keep one update")
        for lanes in buckets.values():
            if stack(lanes):
                self._train_lanes(*([a[i] for i, _ in lanes] for a in (entries, fs_list, n_active_list, in_et_list)),
                                  [rows for _, rows in lanes], use_lucir)
                continue
            for i, _ in lanes:
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
        return self.forward(prev_params, {k: v[idx] for k, v in feats.items()})[1]

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

    def _forward_many(self, params_list: list, batches: list) -> list:
        """One ``(logits, features)`` per lane: several lanes (transformer
        only) through one :func:`~repro_torch.core.predictor.forward_many`,
        one lane through the kind's own forward."""
        if len(params_list) > 1:
            return predictor.forward_many(params_list, batches, self.pcfg)
        return [self.forward(params_list[0], batches[0])]

    def _train_step_many(self, lanes: list) -> list:
        """One AdamW step for each lane ``(params, opt_state, batch, labels,
        n_active, step, f_old, in_et, n_et)``: one forward and one backward
        over all of them (the sum of the lane losses, so each lane's
        upstream gradient is exactly 1), then each lane's own clipping and
        update.  Returns ``(params, opt_state, metrics)`` per lane, metrics
        the loss (``"total"``) and the gradient's global norm before
        clipping (``"grad_norm"``), both on the device."""
        keys = [list(ln[0]) for ln in lanes]
        with torch.enable_grad():
            leaves = [[ln[0][k].detach().requires_grad_(True) for k in ks] for ln, ks in zip(lanes, keys)]
            out = self._forward_many([dict(zip(ks, lv)) for ks, lv in zip(keys, leaves)], [ln[2] for ln in lanes])
            loss = [losses.train_loss(logits, f, labels, n_active=n_active, f_old=f_old, in_et=in_et, n_et=n_et,
                                      lam=self.pcfg.lucir_lambda, mu=self.pcfg.thrash_mu)
                    for (logits, f), (_, _, _, labels, n_active, _, f_old, in_et, n_et) in zip(out, lanes)]
            # the sum, not grad_outputs: a tensor in grad_outputs makes autograd import torch.fx's
            # symbolic shapes (and sympy), which costs a second once and slows every later step
            flat = torch.autograd.grad(sum(loss[1:], loss[0]), [x for lv in leaves for x in lv], allow_unused=True)
        res, lo = [], 0
        for (params, opt_state, _, _, _, step, *_), ks, lss in zip(lanes, keys, loss):
            grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(ks, flat[lo:lo + len(ks)])}
            lo += len(ks)
            updates, opt_state, gnorm = self.opt.update(grads, opt_state, params, step)
            res.append((adamw.apply_updates(params, updates), opt_state, {"total": lss.detach(), "grad_norm": gnorm}))
        return res

    def _train_step(self, params, opt_state, batch, labels, n_active: int, step: int, f_old, in_et, n_et: int):
        """:meth:`_train_step_many` of one lane: ``(params, opt_state,
        metrics)``."""
        return self._train_step_many([(params, opt_state, batch, labels, n_active, step, f_old, in_et, n_et)])[0]

    def _train_lanes(self, entries: list, fs_list: list, n_active_list: list, in_et_list: list, rows_list: list,
                     use_lucir: bool) -> None:
        """Fine-tune non-empty lanes on their schedules ``rows_list``
        together (several lanes: transformer only).  Step ``r`` takes the
        lanes that have a row ``r``: with LUCIR their previous models'
        features under one no-grad forward, then one
        :meth:`_train_step_many` (one lane: :meth:`_train_step`).  The
        entries get their params, moments, ``step`` and ``n_updates`` after
        the last step."""
        params = [e.params for e in entries]
        opt = [self.opt.init(e.params) if e.opt_state is None else e.opt_state for e in entries]
        n_steps = max(len(rows) for rows in rows_list)
        if n_steps:  # a frozen schedule (no rows) stages nothing
            staged = [self._stage(fs) for fs in fs_list]
            idx = [torch.tensor(rows, device=self.device) for rows in rows_list]
            et_np = [None if e is None else np.asarray(e, bool) for e in in_et_list]
            et = [None if e is None else torch.tensor(e.astype(np.int32), device=self.device) for e in et_np]
        use_l = use_lucir and entries[0].prev_params is not None  # the same for every lane of a bucket
        for r in range(n_steps):
            act = [j for j, rows in enumerate(rows_list) if r < len(rows)]
            bidx = [idx[j][r] for j in act]
            batches = [{k: v[b] for k, v in staged[j][0].items()} for j, b in zip(act, bidx)]
            f_old = [None] * len(act)
            if use_l:
                with torch.no_grad():
                    f_old = [f for _, f in self._forward_many([entries[j].prev_params for j in act], batches)]
            lanes = []
            for a, j in enumerate(act):
                bet, n_et = ((None, 0) if et[j] is None
                             else (et[j][bidx[a]], int(np.count_nonzero(et_np[j][rows_list[j][r]]))))
                lanes.append((params[j], opt[j], batches[a], staged[j][1][bidx[a]], n_active_list[j],
                              entries[j].step + r, f_old[a], bet, n_et))
            steps = self._train_step_many(lanes) if len(lanes) > 1 else [self._train_step(*lanes[0])]
            for j, (p, o, _) in zip(act, steps):
                params[j], opt[j] = p, o
        for e, p, o, rows in zip(entries, params, opt, rows_list):
            e.params, e.opt_state = p, o
            e.step += len(rows)
            e.n_updates += 1

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
        self._train_lanes([entry], [fs], [n_active], [in_et], [self._train_schedule(n, rng)], use_lucir)
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
    init_params: dict | None = None,
    device: str | torch.device = "cuda",
) -> RunResult:
    """One prediction-accuracy protocol run (strictly causal top-1).
    ``offline`` trains one model from ``init_params`` (a flat dict of
    tensors on ``device``), or from the JAX package's initial weights for
    ``tcfg.seed``; the other modes start each slot from ``table`` or a
    fresh one.  ``kind`` is a registered predictor architecture."""
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
        entry = Entry(params=init_params if init_params is not None else trainer.new_params(tcfg.seed))
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
