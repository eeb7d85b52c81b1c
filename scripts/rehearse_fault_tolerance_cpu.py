"""Rehearse phase 12 of ``chip_smoke.py`` (the fault-tolerant manager:
snapshots of the manager, the mux and the KV offload, the health machine
under chaos, plug-ins through ``run_batch`` and the fault log, against
``experiments/torch/fault_tolerance_ref.json``) on a CPU, where every kernel
wrapper computes its plain PyTorch version: every check of the phase, each
column's host seconds, and how far each run lands from the JAX package's
(the runs printed ``"equal": true`` are the ones ``chip_smoke.FT_EQUAL``
holds equal on the card).

    PYTHONPATH=src python scripts/rehearse_fault_tolerance_cpu.py [--threads 6]

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

    C.ft_launch_checks = lambda columns: None  # on the CPU no wrapper launches a kernel
    C.FT_EQUAL = ()  # print every distance; hold each by phase 7 (b)'s limits
    t0 = time.perf_counter()
    C.fault_tolerance_path(torch.device("cpu"))
    print(f"phase 12 passed on the CPU in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
