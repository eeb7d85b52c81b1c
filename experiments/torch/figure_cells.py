#!/usr/bin/env python3
"""Every cell of the paper's figures on the port against the JAX package's
(``experiments/torch/figures_paper_ref.json``).

    python3 experiments/torch/figure_cells.py [--device cpu] [--out PATH]

Runs the figure runner's seven figures (``repro_torch.bench.figures``) at
the ``paper`` preset with the JAX package's fresh weights
(``init_paper_slots.npz``), as ``python -m repro_torch.bench.figures
--scale paper --fresh ...`` does, then holds every cell the reference
recorded against the port's: a simulator or UVMSmart cell equal or not,
with the relative distance of its IPC; a fine-tuned ``ours`` or a protocol
run equal or not, with its distance by ``chip_smoke.py``'s phase 7 (b)
measures and whether it is within that phase's limits; and each figure's
rows against the reference's rows.  It prints one line per cell that is not
equal, a summary, and writes every distance to ``--out`` as JSON.  On the
card it takes about as long as the runner (6-7 minutes).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def within(d: dict, C) -> bool:
    """Phase 7 (b)'s limits, as ``chip_smoke.check_tuned`` applies them."""
    return (d["n_predictions_equal"] and d.get("occupancy_equal", True) and d["top1_diff"] <= C.RUN_TOP1_ATOL
            and max(d.get("stats_rtol", {"-": 0}).values()) <= C.RUN_STATS_RTOL
            and d["first_groups_acc_diff"] <= C.RUN_GROUP_ACC_ATOL)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write every cell's distance here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.bench import figures as FG
    from repro_torch.bench import tables as TB

    ref = json.loads(C.FIGURES_REF.read_text())
    ctx = TB.Context("paper", fresh=TB.PAPER_FRESH, device=args.device)
    chains = {}
    chain = ctx.protocol_chain

    def recording_chain(workloads, mode, table=None):
        out = chain(workloads, mode, table=table)
        if table is not None:
            chains.update({w: r for w, r in zip(workloads, out)})
        return out

    ctx.protocol_chain = recording_chain
    t0 = time.perf_counter()
    rows = {name: getattr(FG, name)(ctx) for name in FG.FIGURES}
    seconds = time.perf_counter() - t0
    cells = {}
    for key, want in ref["cells"].items():
        kind, b, *rest = key.split("|")
        if kind in ("sim", "uvmsmart"):
            st = ctx.sim(b, *rest[0].split("+"), float(rest[1])) if kind == "sim" else ctx.uvmsmart(b, float(rest[0]))
            cells[key] = {"equal": st == want["stats"], "ipc_rtol": abs(ctx.ipc(b, st) - want["ipc"]) / want["ipc"]}
            continue
        if kind == "ours":
            res = ctx.ours(b, float(rest[0]), use_thrash_term=rest[1] == "thrash=True")
            d = C.run_distance(res, want)
            d["ipc_1us_rtol"] = abs(res.ipc(pred_overhead_us=1.0) - want["ipc"]["1"]) / want["ipc"]["1"]
        else:
            res = chains[b] if rest[1:] else ctx.protocol(b, rest[0])
            d = C.protocol_distance(res, want)
        cells[key] = {**d, "within": within(d, C)}
    row_diffs = {}
    for name, got in rows.items():
        want = ref["figures_rows"][name]
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
