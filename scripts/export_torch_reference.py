"""Export the JAX package's paper-scale weights and a frozen reference run
for the PyTorch port (``src/repro_torch``).

The port cannot import JAX, and the machine that runs it on the GPU has
none, so this script carries both across as plain files:

* ``experiments/torch/pretrain_paper.npz`` — the Section V-A pretrained
  model table of ``Session.paper()`` (``CONFIG``, 632,066 parameters per
  slot): every slot's params as float32 under ``slot<s>/<param key>``, plus
  ``slot<s>/step``, ``slot<s>/n_updates``, ``slot<s>/last_acc`` and
  ``n_slots``.  Optimizer moments are left out: a frozen run re-initialises
  them to zeros, exactly as ``Trainer.train_group`` does when they are
  missing.
* ``experiments/torch/hotspot_paper_ref.json`` — the JAX package's frozen
  ``run_ours`` (``TrainConfig(2048, 0, 256)``, so no weight ever changes)
  on Hotspot at scale 1.0 and 150% oversubscription from that table: the
  stats, top-1, prediction count, per-group accuracy, the number of groups
  whose prefetch gate opened, and the same numbers for the first 8 groups.

    PYTHONPATH=src python scripts/export_torch_reference.py [--cache-dir DIR]

Pretraining takes about a minute on a CPU.  ``--cache-dir`` memoises it in
DIR (default: no memo, nothing is written outside ``experiments/torch``).
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "experiments" / "torch"
GROUP = 2048
CUT_GROUPS = 8


def _frozen_run(trace, table, oversub: float) -> dict:
    from repro.configs.predictor_paper import CONFIG
    from repro.core.incremental import TrainConfig
    from repro.uvm import runtime as R

    tcfg = TrainConfig(group_size=GROUP, epochs=0, batch_size=256)
    mgr = R.manager_for(trace, CONFIG, tcfg, oversubscription=oversub, table=table)
    gates, patterns, streamed = [], [], 0
    observe = mgr.observe

    def recording_observe(batch):
        nonlocal streamed
        a = observe(batch)
        gates.append(a.counters is not None)
        patterns.append(int(a.pattern))
        if a.counters is not None:
            streamed += a.n_samples
        return a

    mgr.observe = recording_observe
    res = R.run_ours(trace, CONFIG, tcfg, oversubscription=oversub, manager=mgr)
    return {
        "n_accesses": len(trace),
        "stats": res.stats,
        "top1": res.top1,
        "n_predictions": res.n_predictions,
        "per_group_acc": res.per_group_acc,
        "n_groups": len(gates),
        "n_gate_open": int(sum(gates)),
        "predicted_blocks_streamed": streamed,
        "patterns": patterns,
        "ipc": res.ipc(),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache-dir", default=None, help="memoise the pretraining in this directory")
    args = ap.parse_args()
    if args.cache_dir is None:
        os.environ["REPRO_PRETRAIN_CACHE"] = "0"

    import numpy as np

    from repro.uvm import runtime as R
    from repro.uvm import trace as T
    from repro.uvm.api.session import Session

    if args.cache_dir is not None:
        R.PRETRAIN_CACHE_DIR = Path(args.cache_dir)
    table = Session.paper().pretrained()
    OUT.mkdir(parents=True, exist_ok=True)
    arrays = {"n_slots": np.int64(table.n_slots)}
    for s, e in sorted(table.slots.items()):
        for k, v in e.params.items():
            arrays[f"slot{s}/{k}"] = np.asarray(v, np.float32)
        arrays[f"slot{s}/step"] = np.int64(e.step)
        arrays[f"slot{s}/n_updates"] = np.int64(e.n_updates)
        arrays[f"slot{s}/last_acc"] = np.float64(e.last_acc)
    np.savez_compressed(OUT / "pretrain_paper.npz", **arrays)

    trace = T.get_trace("Hotspot", 1.0)
    ref = {
        "benchmark": "Hotspot", "scale": 1.0, "oversubscription": 1.5,
        "train": {"group_size": GROUP, "epochs": 0, "batch_size": 256},
        "full": _frozen_run(trace, table.clone(), 1.5),
        f"first_{CUT_GROUPS}_groups": _frozen_run(trace.slice(0, CUT_GROUPS * GROUP), table.clone(), 1.5),
    }
    (OUT / "hotspot_paper_ref.json").write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps({k: ref["full"][k] for k in ("stats", "top1", "n_gate_open", "patterns")}))


if __name__ == "__main__":
    main()
