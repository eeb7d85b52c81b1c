"""The port's command line (``python -m repro_torch.uvm.cli``) against the
JAX package's (``python -m repro.uvm.cli``), both in process on the CPU:
``run``, ``sweep`` (and its second pass), ``--dump-spec``/``--spec``,
``report`` and ``export`` print the reference's lines (all but the run
store's path, and the module the replay hint names); exported fault logs
are byte for byte the reference's; ``serve``'s record stream over a log is
the reference's byte for byte, as is its stream under a QoS tier and a
seeded chaos schedule, and a ``--resume`` from a snapshot replays the
uninterrupted run's tail; malformed lines give ``{"error", "line"}``
records (exit 2 under ``--strict``), and ``--resume`` without
``--checkpoint-dir`` exits 2.  The keys and logs phase 13 of
``chip_smoke.py`` compares on the card (``experiments/torch/
cli_quick_ref.json``) are the port's.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from repro.uvm import cli as jcli
from repro_torch.uvm import cli as pcli

REF = Path(__file__).resolve().parent.parent / "experiments" / "torch" / "cli_quick_ref.json"
SMALL = ["--scale", "0.25", "--cap", "1500"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread keeps this module from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(capsys, argv: list, tmp_path: Path, *, port_extra=("--device", "cpu"), rc: int = 0) -> tuple:
    """Run one command line through each package (each on a run store of
    its own under ``tmp_path``); their output lines, the store's path
    stripped, and the module the replay hint names normalised."""
    outs = []
    for name, cli, extra in (("j", jcli, ()), ("p", pcli, port_extra)):
        args = [a.replace("{store}", str(tmp_path / f"runs_{name}")).replace("{tmp}", str(tmp_path / name))
                for a in argv]
        (tmp_path / name).mkdir(exist_ok=True)
        assert cli.main([*args, *extra]) == rc, (name, args)
        text = capsys.readouterr().out.replace(str(tmp_path / f"runs_{name}"), "<store>")
        outs.append(text.replace(str(tmp_path / name), "<tmp>").replace("repro_torch.uvm.cli", "repro.uvm.cli")
                    .splitlines())
    return tuple(outs)


def test_run_sweep_and_second_pass_print_the_reference_s_lines(tmp_path, capsys):
    for argv in (["run", "--benchmark", "ATAX", "--policy", "belady", "--prefetch", "demand", *SMALL],
                 ["run", "--benchmark", "NW", "--strategy", "uvmsmart", "--oversub", "1.5", *SMALL]):
        j, p = _both(capsys, [*argv, "--runs-dir", "{store}"], tmp_path)
        assert p == j and p[-1] == "# run cells=1 hits=0 computed=1 store=<store>"
    sweep = ["sweep", "--benchmarks", "ATAX", "BICG", "--policies", "lru", "hpe", "--prefetchers", "demand", "tree",
             "--oversubs", "1.25", "1.5", *SMALL, "--runs-dir", "{store}"]
    j, p = _both(capsys, sweep, tmp_path)
    assert p == j and p[-1] == "# sweep cells=16 hits=0 computed=16 store=<store>"
    j2, p2 = _both(capsys, sweep, tmp_path)
    assert p2 == j2 and p2[:-1] == p[:-1] and p2[-1] == "# sweep cells=16 hits=16 computed=0 store=<store>"
    # the port's store serves the JAX package's records and the reverse
    j3, p3 = _both(capsys, [a.replace("{store}", str(tmp_path / "runs_p")) for a in sweep], tmp_path)
    assert p3[-1].startswith("# sweep cells=16 hits=16 computed=0") and p3[:-1] == j3[:-1] == p[:-1]


def test_dump_spec_replay_and_report(tmp_path, capsys):
    sweep = ["sweep", "--benchmarks", "ATAX", "--policies", "lru", "--prefetchers", "tree", "demand", *SMALL,
             "--runs-dir", "{store}", "--dump-spec", "{tmp}/spec.json"]
    j, p = _both(capsys, sweep, tmp_path)
    assert p == j
    assert (tmp_path / "p" / "spec.json").read_bytes() == (tmp_path / "j" / "spec.json").read_bytes()
    for name in ("j", "p"):  # add a UVMSmart cell to the dumped spec, as phase 13 does
        path = tmp_path / name / "spec.json"
        spec = json.loads(path.read_text())
        spec["extra_cells"] = [{"workload": spec["workloads"][0], "strategy": "uvmsmart", "policy": {"name": "adaptive"},
                                "prefetch": {"name": "adaptive"}, "oversubscription": 1.25, "model": None, "seed": 0}]
        path.write_text(json.dumps(spec))
    j, p = _both(capsys, ["sweep", "--spec", "{tmp}/spec.json", *SMALL, "--runs-dir", "{store}"], tmp_path)
    assert p == j and p[-1] == "# sweep cells=3 hits=2 computed=1 store=<store>"
    j, p = _both(capsys, ["report", "--runs-dir", "{store}", "--csv", "{tmp}/report.csv"], tmp_path, port_extra=())
    assert p == j and p[-1] == "# 3 stored runs in <store>" and p[0] == "# wrote <tmp>/report.csv (3 rows)"
    assert (tmp_path / "p" / "report.csv").read_bytes() == (tmp_path / "j" / "report.csv").read_bytes()
    j, p = _both(capsys, ["report", "--runs-dir", "{store}", "--benchmark", "NW"], tmp_path, port_extra=())
    assert p == j == ["# empty run store at <store>"]


def test_export_logs_are_the_reference_s_byte_for_byte(tmp_path, capsys):
    ref = json.loads(REF.read_text())
    for name, argv in ref["cli"]["logs"].items():
        j, p = _both(capsys, ["export", *argv, "--no-store", "--out", "{tmp}/log.jsonl"], tmp_path)
        assert p == j
        got = (tmp_path / "p" / "log.jsonl").read_bytes()
        assert got == (tmp_path / "j" / "log.jsonl").read_bytes()
        assert hashlib.sha256(got).hexdigest() == ref["logs"][name]["sha256"]
    j, p = _both(capsys, ["export", "--benchmark", "Hotspot", "--scale", "0.1", "--no-store", "--batch", "100"],
                 tmp_path)
    assert p == j and p[0].startswith("# uvm-fault-log v1")


def test_reference_keys_are_the_port_s():
    """The spec keys ``cli_quick_ref.json`` holds (the JAX package's) are
    those the port's command lines build."""
    ref = json.loads(REF.read_text())
    args = pcli.build_parser().parse_args(["sweep", *ref["cli"]["sweep"], "--device", "cpu"])
    spec = pcli._sweep_spec(args, pcli._session(args))
    assert (spec.key, [c.key for c in spec.cells()]) == (ref["keys"]["sweep"], ref["keys"]["sweep_cells"])
    dumped = json.dumps(spec.to_dict(), indent=2, sort_keys=True) + "\n"
    assert hashlib.sha256(dumped.encode()).hexdigest() == ref["keys"]["dump_sha256"]
    args = pcli.build_parser().parse_args(["run", *ref["cli"]["run"], "--device", "cpu"])
    session = pcli._session(args)
    [cell] = pcli.ExperimentSpec(
        name="run", workloads=(session.workload(args.benchmark),), strategy=args.strategy,
        policies=(pcli.PolicySpec(args.policy),), prefetchers=(pcli.PrefetchSpec(args.prefetch),),
        oversubscriptions=(args.oversub,), model=pcli._strategy_model(session, args.strategy, args.kind)).cells()
    assert (cell.key, cell.model.key) == (ref["keys"]["run_ours"], ref["keys"]["run_ours_model"])


def _log(tmp_path, capsys, argv, cap: int) -> Path:
    path = tmp_path / f"log_{argv[argv.index('--phases') + 1]}_{len(argv)}.jsonl"
    assert pcli.main(["export", *argv, "--cap", str(cap), "--no-store", "--out", str(path), "--device", "cpu"]) == 0
    capsys.readouterr()
    return path


STREAM_FLAGS = ["--group-size", "256"]


@pytest.mark.parametrize("case", ["drift", "churn", "churn_qos"])
def test_serve_stream_is_the_reference_s_and_resumes(tmp_path, capsys, case):
    """``serve`` over an exported log (cut to 1,024 accesses: 4 batches),
    the reference's flags: the same records byte for byte; the port's run
    from a snapshot after 2 batches replays its own tail and summary."""
    ref = json.loads(REF.read_text())
    log = _log(tmp_path, capsys, ref["cli"]["logs"][case.split("_")[0]], 1024)
    qos = ["--qos-tier", "0:0.4:2", "--qos-tier", "1:0.2"] if case == "churn_qos" else []
    j, p = _both(capsys, ["serve", "--input", str(log), *STREAM_FLAGS, *qos], tmp_path)
    assert p == j
    records = [json.loads(line) for line in p if line.startswith("{")]
    assert len(records) == 4 and p[-1].startswith("# serve batches=4 ")
    assert all(("budget" in r) == bool(qos) for r in records)
    head = tmp_path / "head.jsonl"
    head.write_text("".join(log.read_text().splitlines(keepends=True)[:3]))
    ck = ["--checkpoint-dir", str(tmp_path / f"ck_{case}"), "--checkpoint-every", "2", "--device", "cpu"]
    assert pcli.main(["serve", "--input", str(head), *STREAM_FLAGS, *qos, *ck]) == 0
    capsys.readouterr()
    assert pcli.main(["serve", "--input", str(log), *STREAM_FLAGS, *qos, *ck, "--resume"]) == 0
    res = capsys.readouterr().out.splitlines()
    assert res[0].startswith("# resumed batch=2 lineno=3 ")
    assert [line for line in res if line.startswith("{")] == [line for line in p if line.startswith("{")][2:]
    assert res[-1] == p[-1]


def _serve_lines(n_batches=6, pages_per=40) -> list[str]:
    """Two tenants' observe and feedback lines (the reference's test's
    stream), with malformed lines among them."""
    import numpy as np

    rng = np.random.default_rng(42)
    lines, clock = [], 0
    for b in range(n_batches):
        t = "A" if b % 2 == 0 else "B"
        lines.append(json.dumps({"pages": rng.integers(0, 300, pages_per).tolist(), "tenant": t}))
        clock += 64
        lines.append(json.dumps({"feedback": {"was_evicted": [False] * pages_per, "fault_count": clock},
                                 "tenant": t}))
    return lines


SERVE_SMALL = ["--n-pages", "300", "--pages-per-block", "4", "--capacity", "16", "--group-size", "32"]


def test_serve_malformed_lines_strict_and_resume_without_directory(tmp_path, capsys):
    lines = _serve_lines()
    bad = ["{not json", "[1, 2]", '{"pages": [1, -2]}', '{"pages": [1], "feedback": {}}', '{"tenant": 1.5, "pages": []}',
           '{"feedback": {"was_evicted": [true]}, "tenant": "C"}', '{"pages": [1, 2], "pc": [1]}']
    stream = tmp_path / "s.jsonl"
    stream.write_text("\n".join(lines[:4] + bad + lines[4:]) + "\n")
    j, p = _both(capsys, ["serve", "--input", str(stream), *SERVE_SMALL], tmp_path)
    assert p == j
    errors = [json.loads(line) for line in p if line.startswith('{"error"')]
    assert [e["line"] for e in errors] == list(range(5, 5 + len(bad)))
    assert "Traceback" not in "\n".join(p) and f"errors={len(bad)}" in p[-1]
    j, p = _both(capsys, ["serve", "--input", str(stream), *SERVE_SMALL, "--strict"], tmp_path, rc=2)
    assert p == j
    assert pcli.main(["serve", "--input", str(stream), "--resume", "--device", "cpu"]) == 2
    assert "checkpoint-dir" in capsys.readouterr().err


def test_serve_inject_is_the_reference_s_and_never_tracebacks(tmp_path, capsys):
    """A seeded chaos schedule on the trainer: exit 0, structured records
    only, the health machine degrades and recovers, and the stream and the
    chaos line are the reference's."""
    stream = tmp_path / "s.jsonl"
    stream.write_text("\n".join(_serve_lines(12)) + "\n")
    j, p = _both(capsys, ["serve", "--input", str(stream), *SERVE_SMALL, "--inject", "trainer_exc=0.4,seed=3"],
                 tmp_path)
    assert p == j
    acts = [json.loads(line) for line in p if line.startswith('{"batch"')]
    assert {"degraded", "healthy"} <= {a["health"] for a in acts} and any(a["fallback"] for a in acts)
    assert any(line.startswith("# chaos schedule=") and "fired=" in line for line in p)
    assert "Traceback" not in "\n".join(p)


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    args = pcli.build_parser().parse_args(["run", "--benchmark", "ATAX"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["run", "--benchmark", "ATAX", "--runs-dir", str(tmp_path)])
    with pytest.raises(SystemExit):  # the async server is not ported yet
        pcli.build_parser().parse_args(["server"])
