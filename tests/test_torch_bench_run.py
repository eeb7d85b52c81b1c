"""The port's benchmark driver (``repro_torch.bench.run``) against the
reference's (``benchmarks/run.py``), the quick preset's committed Table VII
table, and ``timing.normalized_ipc``, on the CPU.

* The driver runs the reference's order less ``roofline``, each name
  through the port's function of that name, at ``quick`` by default and on
  the card unless asked for the CPU; ``--only table2 table3`` on a cut
  benchmark list prints the reference's contract lines and writes the
  reference's CSVs byte for byte; at ``quick`` the default order stops at
  ``fig11`` (its table is not committed), nothing caught.
* ``experiments/torch/pretrain_quick_s321.npz`` read through
  ``Context("quick").pretrained("table7")``: every array has the SHA-256
  the export recorded, and every slot its counters.
* One Table VII pair's ``ours`` from that table equals the JAX package's
  protocol cell (the CPU run is exact).
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import benchmarks.common as BC
import benchmarks.run as JRUN
from repro.uvm import timing as JTIMING
from repro.uvm.api import session as JSESSION
from repro_torch.bench import figures as PFIG
from repro_torch.bench import run as PRUN
from repro_torch.bench import tables as PTAB
from repro_torch.uvm import timing as PTIMING

ROOT = Path(__file__).resolve().parent.parent
QUICK_REF = ROOT / "experiments" / "torch" / "tables_quick_ref.json"


def test_order_and_suites_are_the_references():
    assert PRUN.ORDER == [n for n in JRUN.ORDER if n != "roofline"]
    assert set(PRUN.SUITES) == set(JRUN.SUITES) - {"roofline"} == set(PRUN.ORDER)
    for name, fn in PRUN.SUITES.items():
        assert fn is getattr(PTAB if name.startswith("table") else PFIG, name)
        assert fn.__name__ == JRUN.SUITES[name].__name__ == name


def test_driver_defaults_to_quick_on_the_card(monkeypatch):
    seen = {}

    class Built(Exception):
        pass

    def context(preset, **kw):
        seen.update(preset=preset, **kw)
        raise Built

    monkeypatch.setattr(PRUN, "Context", context)
    with pytest.raises(Built):
        PRUN.main([])
    assert seen["preset"] == "quick" and seen["device"] == "cuda"
    assert seen["out_dir"] == PRUN.OUT_DIR == ROOT / "experiments" / "bench_torch"
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PRUN.main(["--only", "table2"])


def test_only_table2_table3_prints_and_writes_the_references(monkeypatch, tmp_path, capsys):
    benches = ["ATAX", "NW", "StreamTriad"]  # Table III asserts on NW and StreamTriad
    monkeypatch.setattr(JSESSION, "ALL_BENCH", benches)
    monkeypatch.setattr(PTAB, "ALL_BENCH", benches)
    monkeypatch.setattr(BC, "OUT_DIR", tmp_path / "jax")
    monkeypatch.setattr(PRUN, "OUT_DIR", tmp_path / "port")
    monkeypatch.setenv("REPRO_RUN_STORE", "0")
    JRUN.main(["--only", "table2", "table3"])
    want = capsys.readouterr().out.splitlines()
    rows = PRUN.main(["--only", "table2", "table3", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [r["benchmark"] for r in rows["table2"]] == benches and list(rows) == ["table2", "table3"]
    for name in ("table2_hpe_prefetch", "table3_delta_growth"):
        heads = [[ln for ln in lines if ln.startswith(name + ",")] for lines in (want, got)]
        assert len(heads[0]) == len(heads[1]) == 1
        assert [re.sub(r",\d+,", ",US,", h[0]) for h in heads] == [re.sub(r",\d+,", ",US,", heads[0][0])] * 2
        assert (tmp_path / "port" / f"{name}.csv").read_bytes() == (tmp_path / "jax" / f"{name}.csv").read_bytes()
    assert re.fullmatch(r"# total \d+s, results in experiments/bench_torch/", got[-1])
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["table2_hpe_prefetch.csv",
                                                                     "table3_delta_growth.csv"]


def test_quick_order_stops_at_fig11_with_nothing_caught(monkeypatch):
    ran = []
    suites = {n: (lambda ctx, n=n: ran.append(n) or []) for n in PRUN.ORDER}
    suites["fig11"] = PFIG.fig11
    monkeypatch.setattr(PRUN, "SUITES", suites)
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        PRUN.main(["--device", "cpu"])
    assert ran == PRUN.ORDER[:PRUN.ORDER.index("fig11")]
    with pytest.raises(NotImplementedError, match=r"Fig\. 11.*ROADMAP A1"):
        PTAB.Context("quick", device="cpu").pretrained("fig11")


@pytest.mark.parametrize("seed", range(4))
def test_normalized_ipc_equals_jax(seed):
    rng = np.random.default_rng(seed)

    def stats():
        return {k: int(rng.integers(0, 5000)) for k in ("faults", "migrated_blocks", "zero_copy", "pages_thrashed")}

    a, b, n = stats(), stats(), int(rng.integers(1000, 60_000))
    for kw in ({}, {"pred_overhead_us": 10.0, "n_predictions": int(rng.integers(1, 500))}):
        got = PTIMING.normalized_ipc(a, b, n, **kw)
        assert got == JTIMING.normalized_ipc(a, b, n, **kw)
        assert got == PTIMING.ipc(a, n, **kw) / PTIMING.ipc(b, n)  # the overhead is charged to `stats` only
    assert PTIMING.normalized_ipc(a, a, n) == 1.0


def _sha(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(t.numpy(), "<f4").tobytes()).hexdigest()


def test_quick_table7_table_loads_bit_for_bit():
    ref = json.loads(QUICK_REF.read_text())["table7_quick"]
    table = PTAB.Context("quick", device="cpu").pretrained("table7")
    assert sorted(table.slots) == [0, 3] == ref["table"]["slots"]
    got = {}
    for s, e in table.slots.items():
        assert ref["slots"][str(s)] == {"step": e.step, "n_updates": e.n_updates, "last_acc": e.last_acc}
        assert e.prev_params is None  # pretraining leaves no LUCIR snapshot
        for prefix, tree in (("", e.params), ("opt/m/", e.opt_state.m), ("opt/v/", e.opt_state.v)):
            got.update({f"slot{s}/{prefix}{k}": _sha(v) for k, v in tree.items()})
    assert got == ref["sha256"]


def test_quick_table7_ours_equals_jax():
    cells = json.loads(QUICK_REF.read_text())["cells"]
    want = next(v for k, v in cells.items()
                if "benchmark='StreamTriad+2DCONV'" in k and k.endswith("|ours|chain_seed0=321|link0"))
    ctx = PTAB.Context("quick", device="cpu")
    w = ctx.concurrent(("StreamTriad", "2DCONV"), slice_len=ctx.tcfg.group_size)
    res = ctx.protocol(w, "ours", table=ctx.pretrained("table7"))
    assert (res.n_samples, res.n_classes, res.n_models) == (want["n_samples"], want["n_classes"], want["n_models"])
    assert max(abs(x - y) for x, y in zip(res.per_group, want["per_group"])) <= 2.5e-3
    assert (res.top1, list(res.per_group)) == (want["top1"], want["per_group"])  # exact on the CPU
