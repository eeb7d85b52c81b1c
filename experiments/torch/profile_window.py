#!/usr/bin/env python3
"""How often ``torch.profiler`` loses device events of a short window.

    python3 experiments/torch/profile_window.py [--pairs 250]

On one CUDA card, after phase 3's ``evict_select``, ``freq_table``,
``flash_attention`` and ``decode_attention`` checks of ``chip_smoke.py``
(the profiles that precede ``thrash_ce``'s there), profiles 20 ``thrash_ce``
forwards (B 256, V 1024) ``--pairs`` times in each of two ways, in turns:
an unpadded window, and ``chip_smoke.profiled``'s window with idle host
time at each end. One forward is one device kernel, so every profile should
read 1.0 operations per call. Prints one JSON line: for each way, the
profiles read, how many recorded no device operation, how many read other
than 1.0, and the distinct readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=250)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_window: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    from repro_torch.kernels import thrash_ce as K
    from repro_torch.kernels._lib import LIBRARY

    dev = torch.device("cuda", 0)
    LIBRARY.cdll()
    for phase3_check in (C.kernel_evict_select, C.kernel_freq_table, C.kernel_flash_attention, C.kernel_decode_attention):
        phase3_check(dev)
    B, V, n_active = C.THRASH_SHAPES[0]
    logits, labels, et = C._thrash_inputs(dev, B, V, n_active, seed=1)
    fwd = lambda: K.thrash_ce(logits, labels, et, n_active, 0.5)
    fwd()

    def unpadded(iters=20):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fwd()
            torch.cuda.synchronize()
        return sum(c for _, c in C.device_times(prof).values()) / iters

    seen = {"unpadded": [], "padded": []}
    t0 = time.perf_counter()
    for _ in range(args.pairs):
        seen["unpadded"].append(unpadded())
        seen["padded"].append(C.device_ops(fwd)[0] or 0.0)
    print(json.dumps({way: {"profiles": len(v), "no_device_op": sum(1 for x in v if not x),
                            "not_one": sum(1 for x in v if x != 1.0), "readings": sorted(set(v))}
                      for way, v in seen.items()}), f"({time.perf_counter() - t0:.1f} s; {C.nvidia_smi_line()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
