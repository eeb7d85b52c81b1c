"""The pretrained tables' AdamW moments, carried from the JAX package into
the port through the exported ``.npz`` (``scripts/export_torch_reference.py``
writes them, ``repro_torch.convert.blob_from_npz`` reads them).

* A ``SMOKE`` pretrain memo written as the export writes a table and read
  back by the port: params, moments and counters equal bit for bit.
* Why the moments matter: one JAX fine-tune group of a pretrained slot
  started from zero moments (the slot keeping its ``step``, so AdamW's bias
  correction treats the zeros as history) lands far from one started from
  the slot's own moments.
* The port's group from the ``.npz`` table against the JAX package's from
  the memo within ``GROUP_ATOL`` (``tests/test_torch_train.py``: a
  pretrained entry is confident, so more of its gradient elements sit at
  the rounding level than a fresh slot's).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.core.features import DeltaVocab as JVocab
from repro.core.features import FeatureStream as JStream
from repro.core.model_table import Entry as JEntry
from repro.core.model_table import ModelTable as JModelTable
from repro.uvm import runtime as JR
from repro.uvm import trace as JT
from repro_torch import convert
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.core.model_table import clone_tree

from test_torch_runtime import SMOKE_MEMO
from test_torch_train import GROUP_ATOL, _max_diff

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import export_torch_reference as E  # noqa: E402

TC = dict(group_size=512, epochs=1, batch_size=64)


def _memo_table() -> JModelTable:
    """The JAX table of the ``SMOKE`` memo, moments and all."""
    blob = JR._load_pretrain_blob(SMOKE_MEMO)
    trainer = JI.Trainer(JC.SMOKE, JI.TrainConfig())
    table = JModelTable(lambda s: trainer.new_params(s), n_slots=blob["n_slots"])
    for s, e in blob["slots"].items():
        table.slots[s] = JEntry(params=e["params"], prev_params=e["prev_params"], opt_state=e["opt_state"],
                                step=e["step"], n_updates=e["n_updates"], last_acc=e["last_acc"])
    return table


def _group():
    tr = JT.get_trace("Hotspot", 0.4)
    vocab = JVocab(JC.SMOKE.delta_vocab)
    stream = JStream(tr, vocab, JC.SMOKE.history, page_vocab=JC.SMOKE.page_vocab, pc_vocab=JC.SMOKE.pc_vocab,
                     tb_vocab=JC.SMOKE.tb_vocab)
    fs = stream.windows(0, 512)
    return fs, max(vocab.n_classes, 2)


def _jax_group(entry: JEntry):
    """One LUCIR fine-tune group of ``entry`` (its own weights the target)."""
    fs, n_active = _group()
    e = JEntry(params=entry.params, prev_params=entry.params, opt_state=entry.opt_state, step=entry.step,
               n_updates=entry.n_updates)
    return JI.Trainer(JC.SMOKE, JI.TrainConfig(**TC)).train_group(e, fs, n_active, use_lucir=True)


def test_npz_round_trip_keeps_every_moment(tmp_path):
    table = _memo_table()
    path = tmp_path / "table.npz"
    E._write_table_npz(table, path)
    blob = convert.blob_from_npz(path)
    assert blob["n_slots"] == table.n_slots and sorted(blob["slots"]) == sorted(table.slots) == [0, 3]
    for s, je in table.slots.items():
        e = blob["slots"][s]
        assert (e["step"], e["n_updates"], e["last_acc"]) == (je.step, je.n_updates, je.last_acc)
        assert e["prev_params"] is None and je.prev_params is None  # pretraining leaves no snapshot
        for got, want in ((e["params"], je.params), (e["opt_state"].m, je.opt_state.m),
                          (e["opt_state"].v, je.opt_state.v)):
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], np.asarray(v))
        assert any(np.abs(v).max() > 0 for v in e["opt_state"].v.values())
    # the port's table holds the same moments, and so does the exporter's JAX table
    ptable = convert.table_from_blob(blob, PC.SMOKE, "cpu")
    back, _ = E._npz_table(JI.Trainer(JC.SMOKE, JI.TrainConfig()), path)
    assert E._tables_equal(back, table)
    for s, je in table.slots.items():
        for k, v in je.opt_state.v.items():
            np.testing.assert_array_equal(ptable.slots[s].opt_state.v[k].numpy(), np.asarray(v))


def test_snapshot_round_trips_and_params_only_files_load(tmp_path):
    """A slot's LUCIR snapshot where set; a file without moments (the format
    before they were exported) loads with ``opt_state`` and ``prev_params``
    unset."""
    table = _memo_table()
    table.snapshot_prev(3)
    path = tmp_path / "table.npz"
    E._write_table_npz(table, path)
    e = convert.blob_from_npz(path)["slots"][3]
    for k, v in table.slots[3].params.items():
        np.testing.assert_array_equal(e["prev_params"][k], np.asarray(v))
    old = tmp_path / "params_only.npz"
    with np.load(path) as z:
        np.savez(old, **{k: z[k] for k in z.files if "/opt/" not in k and "/prev/" not in k})
    blob = convert.blob_from_npz(old)
    assert all(x["opt_state"] is None and x["prev_params"] is None for x in blob["slots"].values())


def test_fine_tune_from_zero_moments_differs():
    """The fault the exported moments repair: a pretrained slot fine-tuned
    from zero moments (keeping its step) is not the one fine-tuned from its
    own moments."""
    entry = _memo_table().slots[3]
    assert entry.step > 0
    full = _jax_group(entry)
    bare = _jax_group(JEntry(params=entry.params, step=entry.step, n_updates=entry.n_updates))
    diff = max(float(np.abs(np.asarray(full.params[k]) - np.asarray(bare.params[k])).max()) for k in full.params)
    assert diff > 10 * GROUP_ATOL, diff


def test_port_group_from_the_npz_matches_jax(tmp_path):
    table = _memo_table()
    path = tmp_path / "table.npz"
    E._write_table_npz(table, path)
    pe = convert.table_from_blob(convert.blob_from_npz(path), PC.SMOKE, "cpu").slots[3]
    assert pe.opt_state is not None
    want = _jax_group(table.slots[3])
    fs, n_active = _group()
    pe.prev_params = clone_tree(pe.params)
    got = PI.Trainer(PC.SMOKE, PI.TrainConfig(**TC), device="cpu").train_group(pe, fs, n_active, use_lucir=True)
    assert (got.step, got.n_updates) == (want.step, want.n_updates)
    assert _max_diff(want.params, got.params) <= GROUP_ATOL
    assert _max_diff(want.opt_state.m, got.opt_state.m) <= GROUP_ATOL
