#!/usr/bin/env python3
"""Every cell of the paper's figures on the port against the JAX package's
(``experiments/torch/figures_paper_ref.json``), or, with ``--scale
quick``, of the quick preset's figures and tables (``figures_quick_ref.json``
and ``tables_quick_ref.json``).

    python3 experiments/torch/figure_cells.py [--scale quick] [--device cpu] [--out PATH]

Runs the figures the reference file lists (``repro_torch.bench.figures``;
at ``paper`` with the JAX package's fresh weights, ``init_paper_slots.npz``,
as ``python -m repro_torch.bench.figures --scale paper --fresh ...`` does;
at ``quick`` from the committed pretrain memo and the port's draws of the
fresh weights) and, at ``quick``, the tables ``tables_quick_ref.json``
lists, then holds every cell the reference recorded against the port's: a
simulator or UVMSmart cell equal or not, with the relative distance of its
IPC; a fine-tuned ``ours`` or a protocol run equal or not, with its
distance by ``chip_smoke.py``'s phase 7 (b) measures and whether it is
within that phase's limits; and each figure's and table's rows against the
reference's rows.  It prints one line per cell that is not equal, a
summary, and writes every distance to ``--out`` as JSON.  On the card it
takes about as long as the runners (6-7 minutes at ``paper``).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: the reference's key of a merge: ``WorkloadSpec(benchmark='A+B', ..., slice_len=N, ...)``
MERGE = re.compile(r"WorkloadSpec\(benchmark='([^']+)'.*slice_len=(\d+).*\)")


def within(d: dict, C) -> bool:
    """Phase 7 (b)'s limits, as ``chip_smoke.check_tuned`` applies them."""
    return (d["n_predictions_equal"] and d.get("occupancy_equal", True) and d["top1_diff"] <= C.RUN_TOP1_ATOL
            and max(d.get("stats_rtol", {"-": 0}).values()) <= C.RUN_STATS_RTOL
            and d["first_groups_acc_diff"] <= C.RUN_GROUP_ACC_ATOL)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", choices=("paper", "quick"), default="paper")
    ap.add_argument("--out", default=None, help="write every cell's distance here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.bench import figures as FG
    from repro_torch.bench import tables as TB

    paper = args.scale == "paper"
    ref = json.loads((C.FIGURES_REF if paper else TB.EXPERIMENTS / "figures_quick_ref.json").read_text())
    tables_ref = None if paper else json.loads(C.TABLES_QUICK_REF.read_text())
    ctx = TB.Context(args.scale, fresh=TB.PAPER_FRESH if paper else None, device=args.device)
    chains = {}
    chain = ctx.protocol_chain

    def recording_chain(workloads, mode, table=None):
        out = chain(workloads, mode, table=table)
        if table is not None:
            chains.update({w: r for w, r in zip(workloads, out)})
        return out

    ctx.protocol_chain = recording_chain
    t0 = time.perf_counter()
    rows = {name: getattr(FG, name)(ctx) for name in ref["figures"]}
    want_rows = {name: ref["figures_rows"][name] for name in rows}
    if tables_ref is not None:
        rows.update({name: getattr(TB, name)(ctx) for name in tables_ref["tables"]})
        want_rows.update({name: tables_ref["tables_rows"][name] for name in tables_ref["tables"]})
    seconds = time.perf_counter() - t0
    cells = {}
    ref_cells = {**ref["cells"], **(tables_ref["cells"] if tables_ref else {})}
    for key, want in ref_cells.items():
        kind, b, *rest = key.split("|")
        if "drift=DriftSpec" in b:
            continue  # Table IX's cells, held by chip_smoke.py's phase 11 and its runner
        merge = MERGE.fullmatch(b)
        if merge:  # a Section V-F merge, recorded by its WorkloadSpec
            b = ctx.concurrent(tuple(merge.group(1).split("+")), slice_len=int(merge.group(2)))
        if kind in ("sim", "uvmsmart"):
            st = ctx.sim(b, *rest[0].split("+"), float(rest[1])) if kind == "sim" else ctx.uvmsmart(b, float(rest[0]))
            cells[key] = {"equal": st == want["stats"], "ipc_rtol": abs(ctx.ipc(b, st) - want["ipc"]) / want["ipc"]}
            continue
        if kind == "ours":
            res = ctx.ours(b, float(rest[0]), use_thrash_term=rest[1] == "thrash=True",
                           tenancy=rest[2][len("tenancy="):] if rest[2:] else "mux")
            d = C.run_distance(res, want)
            d["ipc_1us_rtol"] = abs(res.ipc(pred_overhead_us=1.0) - want["ipc"]["1"]) / want["ipc"]["1"]
        else:
            chained = rest[1:] and not rest[1].startswith("kind=")
            kind_ = rest[1][len("kind="):] if rest[1:] and not chained else "transformer"
            res = chains[b] if chained else ctx.protocol(b, rest[0], kind=kind_)
            d = C.protocol_distance(res, want)
        cells[key] = {**d, "within": within(d, C)}
    row_diffs = {}
    for name, got in rows.items():
        want = want_rows[name]
        row_diffs[name] = [{k: (g[k], w[k]) for k in w if g[k] != w[k]} for g, w in zip(got, want)]
    for key, d in cells.items():
        if not d["equal"]:
            print(f"{key}: " + json.dumps({k: v for k, v in d.items() if k not in ("stats", "per_group_acc")}))
    summary = {"seconds": seconds, "cells": len(cells), "equal": sum(d["equal"] for d in cells.values()),
               "outside_limits": sorted(k for k, d in cells.items() if not d["equal"] and not d.get("within", False)),
               "rows_differing": {k: [r for r in v if r] for k, v in row_diffs.items() if any(v)}}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary, "cells": cells, "rows": rows}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
