"""Rehearse phase 9 of ``chip_smoke.py`` (Tables VII and VIII's cells at the
paper preset against ``experiments/torch/concurrent_paper_ref.json``) on a
CPU, where every kernel wrapper computes its plain PyTorch version: every
check of the phase, each run's host seconds and compressed events, and how
far the fine-tuned runs and Table VII's protocols land from the JAX
package's.

    PYTHONPATH=src python scripts/rehearse_concurrent_cpu.py [--threads 6] [--long]

It holds no run of (c) and (d) equal (``CONCURRENT_EQUAL`` is emptied) and
prints, last, the runs it found equal to the JAX package's to the last
digit: the card run holds those equal.  The profiled run, which needs the
card, runs unprofiled; the launch counts are printed but not checked (on
the CPU no wrapper launches a kernel), and host syncs are not counted.

``--long`` runs, instead, the two long pairs' fine-tuned ``mux`` and
``merged`` runs (Hotspot+Srad-v2 and ATAX+Srad-v2, which phase 9 leaves to
the runner) and prints how far each lands from the JAX package's run by
phase 7 (b)'s measures and the first group whose accuracy differs.
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
    ap.add_argument("--long", action="store_true", help="the long pairs' fine-tuned runs instead")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    if args.long:
        long_pairs(C)
        return

    C.profile_run = lambda label, run: run()  # torch.profiler's CUDA activity needs the card
    C.concurrent_launch_checks = lambda *a: None  # on the CPU no wrapper launches a kernel
    C.CONCURRENT_EQUAL = ()
    equal = []
    check_tuned = C.check_tuned

    def recording(name, d):
        if d["equal"]:
            equal.append(name)
        check_tuned(name, d)

    C.check_tuned = recording
    t0 = time.perf_counter()
    C.concurrent_path(torch.device("cpu"))
    print(f"phase 9 passed on the CPU in {time.perf_counter() - t0:.1f} s")
    print("equal to the JAX package's: " + json.dumps(equal))


def long_pairs(C) -> None:
    from repro_torch.bench import tables as TB
    from repro_torch.core.incremental import TrainConfig

    ref = json.loads(C.CONCURRENT_REF.read_text())
    ctx = TB.Context("paper", fresh=C.FRESH, device="cpu").with_train(TrainConfig(**ref["train"]["fine_tuned"]))
    for pair in (("Hotspot", "Srad-v2"), ("ATAX", "Srad-v2")):
        w = ctx.concurrent(pair, slice_len=ref["slice_len"])
        for tenancy in ("mux", "merged"):
            t0 = time.perf_counter()
            res = ctx.ours(w, tenancy=tenancy)
            want = ref["pairs_ref"]["+".join(pair)]["runs"][f"{tenancy}_fine_tuned"]
            d = C.tuned_distance(res, want)
            first = next((i for i, (a, b) in enumerate(zip(res.per_group_acc, want["per_group_acc"])) if a != b), None)
            print(json.dumps({"run": f"{'+'.join(pair)}|{tenancy}", "seconds": time.perf_counter() - t0, **d,
                              "want_top1": want["top1"], "per_tenant_top1": res.per_tenant_top1,
                              "want_per_tenant_top1": want["per_tenant_top1"], "groups": len(res.per_group_acc),
                              "first_differing_group": first}), flush=True)


if __name__ == "__main__":
    main()
