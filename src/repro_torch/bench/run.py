"""The reference's benchmark driver on the port (counterpart of
``benchmarks/run.py``): the paper's tables and figures in the reference's
order, from one command line.

    PYTHONPATH=src python -m repro_torch.bench.run            # quick (reduced traces)
    PYTHONPATH=src python -m repro_torch.bench.run --scale paper
    PYTHONPATH=src python -m repro_torch.bench.run --only table6 fig14 [--frozen] [--table PATH] \\
        [--fresh PATH] [--device cpu]

One :class:`~repro_torch.bench.tables.Context` of the preset runs the names
in order, on the card unless ``--device cpu`` is given.  Each prints the
reference's ``name,us_per_call,derived`` line and its rows, and writes them
to ``experiments/bench_torch/<name>.csv`` with the reference's columns (the
reference writes ``experiments/bench/``, which stays the JAX package's).
``ORDER`` is the reference's without ``roofline``, its summary of the TPU
dry runs, which waits for ROADMAP A7.  No name is skipped and no error is
caught: at ``quick`` the default order stops at ``fig11``, whose quick
table is not committed (ROADMAP A1).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.bench import figures, tables
from repro_torch.bench.tables import SCALE_PRESETS, Context
from repro_torch.uvm.api.session import EXPERIMENTS

#: each table and figure of the port by the reference's name
SUITES = {**{n: getattr(tables, n) for n in tables.TABLES}, **{n: getattr(figures, n) for n in figures.FIGURES}}
#: the reference's order (cheap first, the fine-tuned runs later), less ``roofline``
ORDER = ["table1", "table2", "table3", "table4", "fig3", "fig4", "fig6", "fig10", "fig11", "fig12", "table6",
         "fig13", "fig14", "table7", "table8", "table9", "table10"]
OUT_DIR = EXPERIMENTS / "bench_torch"


def main(argv=None) -> dict:
    """Run the names (``--only``, default ``ORDER``) and return each one's
    rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", choices=sorted(SCALE_PRESETS), default="quick")
    ap.add_argument("--only", nargs="*", choices=ORDER, default=None)
    ap.add_argument("--frozen", action="store_true", help="ours without fine-tuning (epochs 0)")
    ap.add_argument("--table", default=None, help="the pretrained table for ours (a memo pickle or .npz)")
    ap.add_argument("--fresh", default=None, help="initial weights of the slots a table lacks and of the offline "
                                                  "model (.npz; default: drawn as the JAX package draws them)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ctx = Context(args.scale, frozen=args.frozen, table=args.table, fresh=args.fresh, out_dir=OUT_DIR,
                  device=args.device)
    t0 = time.time()
    rows = {name: SUITES[name](ctx) for name in args.only or ORDER}
    print(f"# total {time.time() - t0:.0f}s, results in experiments/bench_torch/")
    return rows


if __name__ == "__main__":
    main()
