"""Rehearse phase 7 of ``chip_smoke.py`` (the training path against its JAX
references) on a CPU, where every kernel wrapper computes its plain
PyTorch version, and measure how far a defective training step lands from
the references, so that the phase's limits can be set between the two.

    PYTHONPATH=src python scripts/rehearse_training_cpu.py [--threads 6] \\
        [--defect {mu_unscaled,no_lucir,no_bias_correction}] [--nudge SEED] [--parts a b c]

Parts:

a. the reference's recorded fine-tune group (``train_hotspot_ref.npz``):
   the first steps' loss and gradient-norm distances and the distance of
   the update from the reference's;
b. the fine-tuned Hotspot x1.5 ``run_ours``: stats, top-1 and the first
   groups' accuracies against the reference's;
c. the qwen2 reference's page-mass stream through ``LearnedOffloadManager``
   from the JAX package's initial slots (``serve_manager_ref.npz``).

``--defect`` runs them with a defective training step: the thrashing
term's mu not scaled by B / |S|, the LUCIR term dropped, or AdamW without
its bias correction.  ``--nudge SEED`` moves every pretrained weight by one
float32 ulp up or down (signs drawn from SEED) and, like ``--threads``,
which changes how the CPU splits its sums, measures how far the online
loop carries a difference that small: the spread a correct run may show.
Part b takes about 1.5 minutes on 6 threads; a and c a few seconds each.
The last line is one JSON object of the distances.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def inject(defect: str | None) -> None:
    from repro_torch.core import losses
    from repro_torch.optim import adamw

    if defect == "mu_unscaled":
        orig = losses.train_loss
        losses.train_loss = lambda *a, n_et=0, **kw: orig(*a, n_et=a[0].shape[0], **kw)
    elif defect == "no_lucir":
        orig = losses.train_loss
        losses.train_loss = lambda *a, f_old=None, **kw: orig(*a, **kw)
    elif defect == "no_bias_correction":
        orig_adamw = adamw.adamw

        def no_bc(lr, **kw):
            opt = orig_adamw(lr, **kw)
            return adamw.Optimizer(opt.init, lambda g, s, p, step: opt.update(g, s, p, 10 ** 6))

        adamw.adamw = no_bc


def nudge(seed: int) -> None:
    from repro_torch.uvm import runtime as R

    load = R.load_pretrained

    def nudged(*a, **kw):
        table = load(*a, **kw)
        gen = torch.Generator().manual_seed(seed)
        for entry in table.slots.values():
            for p in entry.params.values():
                up = torch.randint(0, 2, p.shape, generator=gen, device=p.device).bool()
                p.copy_(torch.nextafter(p, torch.where(up, p + 1, p - 1)))
        return table

    R.load_pretrained = nudged


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=6)
    ap.add_argument("--defect", choices=["mu_unscaled", "no_lucir", "no_bias_correction"], default=None)
    ap.add_argument("--nudge", type=int, default=None, metavar="SEED")
    ap.add_argument("--parts", nargs="+", choices=["a", "b", "c"], default=["a", "b", "c"])
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    inject(args.defect)
    if args.nudge is not None:
        nudge(args.nudge)
    dev = torch.device("cpu")
    out = {"defect": args.defect, "nudge": args.nudge, "threads": args.threads}
    if "a" in args.parts:
        res = C.train_group_run(dev)
        out["a"] = {k: res[k] for k in ("loss_rtol_held", "grad_norm_rtol_held", "loss_rtol_all", "update_rel",
                                        "params_max_abs", "wall_s")}
        print("a: " + json.dumps(out["a"]), flush=True)
    if "b" in args.parts:
        t0 = time.perf_counter()
        d = C.run_distances(C.fine_tuned_run(dev))
        out["b"] = {**{k: v for k, v in d.items() if k != "per_group_acc"}, "wall_s": time.perf_counter() - t0}
        print("b: " + json.dumps(out["b"]), flush=True)
    if "c" in args.parts:
        t0 = time.perf_counter()
        out["c"] = {**C.manager_replay(dev), "wall_s": time.perf_counter() - t0}
        print("c: " + json.dumps(out["c"]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
