"""Phase 9 of ``chip_smoke.py`` alone, or the whole script with probes.

    python3 experiments/torch/phase_probe.py [RUN ...]     # phases 1-2 and 9 in a fresh process
    python3 experiments/torch/phase_probe.py --smoke [--freeze]

The first form builds (or loads) the kernels and runs phase 9 alone, holding
the runs named on the command line equal to the JAX package's (the others of
(c) and (d) within phase 7 (b)'s limits), and prints the phase's seconds: a
measure of phase 9 that no earlier phase can touch.  ``--smoke`` runs
``chip_smoke.py``'s ``main`` with a probe at the start of phases 4, 8 and 9:
the seconds of a pure-Python loop of 2,000,000 additions, the host
microseconds of 20,000 ``torch.zeros(8)`` + ``add_`` pairs on the card, and
the Python heap (``gc.get_objects()``, ``gc.get_count()``, collections per
generation); ``--freeze`` also collects and freezes the heap before phase 9
and probes again.  Two probes that read alike say that a later phase does
not run slower for the process's age.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def probe(label: str, dev) -> None:
    import torch

    t = time.perf_counter()
    s = 0
    for i in range(2_000_000):
        s += i
    py = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20000):
        x = torch.zeros(8, device=dev)
        x += 1
    torch.cuda.synchronize()
    ops = (time.perf_counter() - t) / 20000 * 1e6
    print(f"  PROBE {label}: python loop {py:.3f} s, torch zeros+add {ops:.2f} us/iter, gc objects "
          f"{len(gc.get_objects())}, gc counts {gc.get_count()}, gc stats {[s['collections'] for s in gc.get_stats()]}",
          flush=True)


def smoke(freeze: bool) -> int:
    import chip_smoke as C

    def wrap(name, label, freeze_first=False):
        orig = getattr(C, name)

        def wrapped(dev, *a, **k):
            probe(label, dev)
            if freeze_first:
                gc.collect()
                gc.freeze()
                probe(label + " after freeze", dev)
            return orig(dev, *a, **k)
        setattr(C, name, wrapped)

    wrap("main_path", "phase 4")
    wrap("tables_path", "phase 8")
    wrap("concurrent_path", "phase 9", freeze)
    sys.argv = [sys.argv[0]]
    return C.main()


def alone(equal: list) -> int:
    import torch

    import chip_smoke as C
    from repro_torch.kernels._lib import LIBRARY

    print(C.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    LIBRARY.cdll()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    C.CONCURRENT_EQUAL = tuple(equal)
    try:
        out = C.concurrent_path(torch.device("cuda", 0))
        print("phase 9 passed", json.dumps(out))
        rc = 0
    except C.SmokeFailure as exc:
        print("FAILED", exc)
        rc = 1
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    return rc


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--smoke" in args:
        sys.exit(smoke("--freeze" in args))
    sys.exit(alone(args))
