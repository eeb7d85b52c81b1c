"""Rehearse phase 8 of ``chip_smoke.py`` (the table runner at the paper
preset against ``experiments/torch/tables_paper_ref.json``) on a CPU,
where every kernel wrapper computes its plain PyTorch version: every check
of the phase, the columns' host seconds and compressed events, and the
fine-tuned subset's distances from the JAX package's runs.

    PYTHONPATH=src python scripts/rehearse_tables_cpu.py [--threads 6] [--tuned ATAX BICG ...]

``--tuned`` replaces the phase's fine-tuned subset (e.g. with all 11
benchmarks, to see how far each lands).  The profile of the Hotspot
``lru`` + ``tree`` cell, which needs the card, runs unprofiled, and the
launch counts are printed but not checked (on the CPU no wrapper launches
a kernel).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=6)
    ap.add_argument("--tuned", nargs="+", default=None, help="the benchmarks of the fine-tuned ours")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    C.profile_run = lambda label, run: run()  # torch.profiler's CUDA activity needs the card
    C.table_launch_checks = lambda columns: None  # on the CPU no wrapper launches a kernel
    if args.tuned:
        C.TABLES_TUNED = tuple(args.tuned)
    t0 = time.perf_counter()
    C.tables_path(torch.device("cpu"))
    print(f"phase 8 passed on the CPU in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
