"""Rehearse phase 14 of ``chip_smoke.py`` (the async fault-stream server:
``FaultStreamServer`` in every dispatch mode with ``run_loadgen``'s clients
on the drift and churn logs of ``experiments/torch/cli_quick_ref.json``, a
stacked ``evaluate_many`` and ``train_group_many`` at ``CONFIG``,
isolation, kill -9 and ``--resume`` of ``cli server --device cpu``, and
load) on a CPU, where every kernel wrapper computes its plain PyTorch
version: every check of the phase but the launch counts, the AOT cache and
the profiled thread check (on the CPU no wrapper launches a kernel), with
each piece's ticks, lanes and seconds, from which the phase's time on the
card is planned.

    PYTHONPATH=src python scripts/rehearse_server_cpu.py [--threads 6] [--gather-spins 2]
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
    ap.add_argument("--gather-spins", type=int, default=None,
                    help="event-loop passes per tick (default: chip_smoke.SERVER_GATHER_SPINS)")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    if args.gather_spins is not None:
        C.SERVER_GATHER_SPINS = args.gather_spins
    t0 = time.perf_counter()
    C.server_path(torch.device("cpu"))
    print(f"phase 14 passed on the CPU in {time.perf_counter() - t0:.1f} s "
          f"(gather_spins {C.SERVER_GATHER_SPINS})")


if __name__ == "__main__":
    main()
