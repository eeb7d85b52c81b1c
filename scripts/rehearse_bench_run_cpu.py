"""Rehearse phase 15 of ``chip_smoke.py`` (the benchmark driver at the
quick preset on Tables I and VII, against
``experiments/torch/tables_quick_ref.json``) on a CPU, where every kernel
wrapper computes its plain PyTorch version: every check of the phase but
the launch counts, Table VII's distances (the runs equal here are
``chip_smoke.BENCH_RUN_EQUAL``) and each suite's host seconds, from which
the phase's time budget on the card is set.  ``--all`` rehearses
``chip_smoke.py --bench-run`` instead.

    PYTHONPATH=src python scripts/rehearse_bench_run_cpu.py [--all] [--threads 6]
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
    ap.add_argument("--all", action="store_true", help="rehearse --bench-run")
    ap.add_argument("--threads", type=int, default=6)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    C.bench_launch_checks = lambda suites: None  # on the CPU no wrapper launches a kernel
    t0 = time.perf_counter()
    (C.bench_run_all if args.all else C.bench_run_path)(torch.device("cpu"))
    print(f"phase 15{' --bench-run' if args.all else ''} passed on the CPU in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
