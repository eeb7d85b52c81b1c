"""The paper's figures on the port (counterpart of ``benchmarks/figures.py``):
3 (slowdown against oversubscription), 4 and 11 (online against offline
against ``ours`` top-1), 6 (single against multi model), 10 (the predictor
zoo: transformer, LSTM, CNN and MLP under online training), 12 (the
thrashing-term ablation), 13 (IPC against the prediction overhead) and 14
(IPC against UVMSmart at 125% and 150%).

    PYTHONPATH=src python -m repro_torch.bench.figures --only fig3 fig4 fig6 fig10 fig11 fig12 fig13 fig14 \\
        [--scale paper] [--table PATH] [--fresh PATH] [--device cpu]

Every cell runs on the card unless ``--device cpu`` is given, through the
table runner's :class:`~repro_torch.bench.tables.Context` (its presets,
pretrained tables and memo).  Each figure prints the reference's contract
line (``name,us_per_call,derived``) and then one JSON object per row, with
the reference's rows, keys, rounding and benchmark lists.  ``--fresh
experiments/torch/init_paper_slots.npz`` starts the fresh slots and the
``offline`` protocol's model from the JAX package's exported initial
weights; without it they are drawn as the JAX package draws them
(:mod:`repro_torch.random`), which Fig. 10's four kinds always are.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.bench.tables import FEATURED, SCALE_PRESETS, Context, emit

FIGURES = ("fig3", "fig4", "fig6", "fig10", "fig11", "fig12", "fig13", "fig14")
#: Fig. 10's benchmarks and predictor kinds
FIG10_BENCH = ["Hotspot", "ATAX", "StreamTriad"]
FIG10_KINDS = ("transformer", "lstm", "cnn", "mlp")
#: Fig. 3's oversubscription axis
FIG3_OVERSUBS = (1.0, 1.1, 1.25, 1.5)
#: Fig. 12's benchmarks: the four that thrash most
FIG12_BENCH = ["ATAX", "BICG", "NW", "Srad-v2"]
#: Fig. 13's prediction overheads (microseconds per prediction)
FIG13_OVERHEADS_US = (1, 10, 20, 50, 100)


def fig3(ctx: Context) -> list[dict]:
    """Slowdown of ``lru`` + ``tree`` against oversubscription (x1.0 is the
    reference point)."""
    t0 = time.time()
    rows = []
    for b in ctx.benches:
        r = {"benchmark": b}
        ref = None
        for os_ in FIG3_OVERSUBS:
            ipc = ctx.ipc(b, ctx.sim(b, "lru", "tree", os_))
            ref = ipc if ref is None else ref
            r[f"slowdown_{os_}"] = round(1 - ipc / ref, 4)
        rows.append(r)
    emit("fig3_slowdown", rows, t0)
    return rows


def fig4(ctx: Context, benches=None) -> list[dict]:
    """Online against offline top-1 (the online-training gap)."""
    t0 = time.time()
    rows = []
    for b in benches or FEATURED:
        on = ctx.protocol(b, "online_single")
        off = ctx.protocol(b, "offline")
        rows.append({
            "benchmark": b, "online_top1": round(on.top1, 3), "offline_top1": round(off.top1, 3),
            "gap": round(off.top1 - on.top1, 3), "n_classes": on.n_classes,
        })
    emit("fig4_online_offline", rows, t0)
    return rows


def fig6(ctx: Context) -> list[dict]:
    """Hotspot: offline against online multi-model against online
    single-model."""
    t0 = time.time()
    b = "Hotspot"
    rows = [{
        "benchmark": b,
        "offline": round(ctx.protocol(b, "offline").top1, 3),
        "online_multi": round(ctx.protocol(b, "online_multi").top1, 3),
        "online_single": round(ctx.protocol(b, "online_single").top1, 3),
    }]
    emit("fig6_multimodel", rows, t0)
    return rows


def fig10(ctx: Context, benches=None) -> list[dict]:
    """The predictor architecture zoo under online training: each kind's
    ``online_single`` top-1 from fresh weights."""
    t0 = time.time()
    rows = []
    for b in benches or FIG10_BENCH:
        r = {"benchmark": b}
        for kind in FIG10_KINDS:
            r[kind] = round(ctx.protocol(b, "online_single", kind=kind).top1, 3)
        r["derived"] = "transformer_best" if r["transformer"] >= max(r["lstm"], r["cnn"], r["mlp"]) - 0.02 else "see_row"
        rows.append(r)
    emit("fig10_model_zoo", rows, t0)
    return rows


def fig11(ctx: Context, benches=None) -> list[dict]:
    """Top-1 of online and ``ours`` normalised to offline; ``ours`` is the
    pretrain-then-finetune protocol, one table (Fig. 11's own pretrain,
    ``seed0=123``) fine-tuned across the benchmarks in row order."""
    t0 = time.time()
    benches = benches or FEATURED
    ours_chain = ctx.protocol_chain(benches, "ours", table=ctx.pretrained("fig11"))
    rows = []
    for b, ours_res in zip(benches, ours_chain):
        off = ctx.protocol(b, "offline").top1
        on = ctx.protocol(b, "online_single").top1
        ours = ours_res.top1
        rows.append({
            "benchmark": b,
            "online_norm": round(on / max(off, 1e-9), 3),
            "ours_norm": round(ours / max(off, 1e-9), 3),
            "offline": round(off, 3),
            "derived": f"ours_gain={ours - on:+.3f}",
        })
    emit("fig11_normalized_acc", rows, t0)
    return rows


def fig12(ctx: Context) -> list[dict]:
    """The thrashing-term ablation on the four benchmarks that thrash most."""
    t0 = time.time()
    rows = []
    for b in FIG12_BENCH:
        w = ctx.ours(b, use_thrash_term=True)
        wo = ctx.ours(b, use_thrash_term=False)
        rows.append({
            "benchmark": b,
            "with_term_thrash": w.stats["pages_thrashed"],
            "without_term_thrash": wo.stats["pages_thrashed"],
            "with_term_top1": round(w.top1, 3),
            "without_term_top1": round(wo.top1, 3),
        })
    emit("fig12_thrash_term", rows, t0)
    return rows


def fig13(ctx: Context, benches=None) -> list[dict]:
    """IPC against UVMSmart's at a prediction overhead of 1-100 us, charged
    per far-fault (``LearnedRunResult.ipc``); the first row is the mean."""
    t0 = time.time()
    rows = []
    means = {}
    for b in benches or FEATURED:
        ours = ctx.ours(b)
        smart_ipc = ctx.ipc(b, ctx.uvmsmart(b))
        r = {"benchmark": b}
        for us in FIG13_OVERHEADS_US:
            ipc = ours.ipc(pred_overhead_us=us)
            r[f"norm_ipc_{us}us"] = round(ipc / smart_ipc, 3)
            means.setdefault(us, []).append(ipc / smart_ipc)
        rows.append(r)
    rows.insert(0, {"benchmark": "MEAN", **{f"norm_ipc_{u}us": round(float(np.mean(v)), 3) for u, v in means.items()}})
    emit("fig13_overhead", rows, t0)
    return rows


def fig14(ctx: Context, benches=None) -> list[dict]:
    """IPC against UVMSmart's at 125% and 150% oversubscription."""
    t0 = time.time()
    rows = []
    for b in benches or FEATURED:
        r = {"benchmark": b}
        for os_ in (1.25, 1.5):
            ours = ctx.ours(b, oversub=os_)
            smart_ipc = ctx.ipc(b, ctx.uvmsmart(b, os_))
            ipc = ours.ipc(pred_overhead_us=1.0)
            r[f"norm_ipc_{os_}"] = round(ipc / smart_ipc, 3)
        rows.append(r)
    emit("fig14_ipc", rows, t0)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=FIGURES, default=list(FIGURES))
    ap.add_argument("--scale", choices=sorted(SCALE_PRESETS), default="paper")
    ap.add_argument("--table", default=None, help="the pretrained table for ours (a memo pickle or .npz)")
    ap.add_argument("--fresh", default=None, help="initial weights of the slots a table lacks and of the offline "
                                                  "model (.npz; default: drawn as the JAX package draws them)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ctx = Context(args.scale, table=args.table, fresh=args.fresh, device=args.device)
    return {name: globals()[name](ctx) for name in args.only}


if __name__ == "__main__":
    main()
