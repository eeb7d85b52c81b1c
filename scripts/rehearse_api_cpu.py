"""Rehearse phase 13 of ``chip_smoke.py`` (the experiment surface: ``cli
sweep``, ``sweep --spec``, ``run``, ``export``, ``serve`` with checkpoints
and a resume, ``report``, and ``run_ours_many``, against
``experiments/torch/cli_quick_ref.json`` and the committed table
references) on a CPU, where every kernel wrapper computes its plain
PyTorch version: every check of the phase and each piece's host seconds,
from which the phase's time budget on the card is set.

    PYTHONPATH=src python scripts/rehearse_api_cpu.py [--threads 6]

The launch counts are printed but not checked (on the CPU no wrapper
launches a kernel).
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
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    C.api_launch_checks = lambda pieces: None  # on the CPU no wrapper launches a kernel
    t0 = time.perf_counter()
    C.experiment_api_path(torch.device("cpu"))
    print(f"phase 13 passed on the CPU in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
