"""Rehearse phase 10 of ``chip_smoke.py`` (a subset of the paper's figures
at the paper preset against ``experiments/torch/figures_paper_ref.json``)
on a CPU, where every kernel wrapper computes its plain PyTorch version:
every check of the phase, each column's host seconds, compressed events and
prefetch-gate openings, and how far the fine-tuned runs and the protocols
land from the JAX package's.

    PYTHONPATH=src python scripts/rehearse_figures_cpu.py [--threads 6] [--fig3 ATAX BICG ...] [--tuned NAME] [--events]

The cells phase 10 reads from phase 8 (``lru`` + ``tree`` at x1.25 on the
11 benchmarks, UVMSmart at x1.25 on FEATURED) are computed first, outside
the phase's timing, as phase 8 computes them on the card.  ``--fig3``
replaces the phase's Fig. 3 subset, ``--tuned`` the benchmark of its
fine-tuned and protocol runs (a long one lands as far from the JAX
package's as C3 carries it; its distances print before the checks
stop the run); ``--events`` prints, instead, the
compressed events of each benchmark's ``lru`` + ``tree`` cell at x1.0,
x1.1 and x1.5 and of its UVMSmart run at x1.5 (what the subset costs on the
card at phase 8's milliseconds per event).  The launch counts are printed
but not checked (on the CPU no wrapper launches a kernel).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=6)
    ap.add_argument("--fig3", nargs="+", default=None, help="the benchmarks of Fig. 3's subset")
    ap.add_argument("--tuned", default=None, help="the benchmark of the fine-tuned and protocol runs")
    ap.add_argument("--events", action="store_true", help="only count each benchmark's events")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.bench import tables as TB
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.uvm import simulator as S

    dev = torch.device("cpu")
    ctx = TB.Context("paper", frozen=True, fresh=C.FRESH, device=dev)
    if args.events:
        walked = [0]
        scan = S._scan_events

        def counting(state, ev, *a):
            walked[0] += len(ev.blk)
            return scan(state, ev, *a)

        S._scan_events = counting
        for b in ctx.benches:
            out = {}
            for os_ in C.FIG3_OVERSUBS:
                walked[0] = 0
                ctx.sim(b, "lru", "tree", os_)
                out[f"lru+tree x{os_}"] = walked[0]
            walked[0] = 0
            ctx.uvmsmart(b, 1.5)
            out["uvmsmart x1.5"] = walked[0]
            print(json.dumps({"benchmark": b, "accesses": len(ctx.trace(b)), **out}), flush=True)
        return
    if args.fig3:
        C.FIG3_BENCH = tuple(args.fig3)
    if args.tuned:
        C.FIG_TUNED = args.tuned
    C.figure_launch_checks = lambda columns: None  # on the CPU no wrapper launches a kernel
    ref = json.loads(C.TABLES_REF.read_text())
    tuned = ctx.with_train(TrainConfig(**ref["train"]["fine_tuned"]), benches=list(C.TABLES_TUNED))
    t0 = time.perf_counter()
    for b in ctx.benches:  # phase 8's cells
        ctx.sim(b, "lru", "tree")
    for b in TB.FEATURED:
        ctx.uvmsmart(b)
    print(f"phase 8's cells in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    C.figures_path(dev, ctx, tuned)
    print(f"phase 10 passed on the CPU in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
