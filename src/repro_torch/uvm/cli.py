"""Command-line front end for the declarative experiment API (port of
``repro.uvm.cli``: its flags, defaults and printed lines, plus
``--device``, which defaults to ``cuda``).

    PYTHONPATH=src python -m repro_torch.uvm.cli run   --benchmark ATAX --policy lru --prefetch tree
    PYTHONPATH=src python -m repro_torch.uvm.cli sweep --benchmarks ATAX BICG --policies lru hpe \
        --prefetchers demand tree --oversubs 1.25 1.5
    PYTHONPATH=src python -m repro_torch.uvm.cli sweep --spec experiment.json
    PYTHONPATH=src python -m repro_torch.uvm.cli report
    PYTHONPATH=src python -m repro_torch.uvm.cli serve --input faults.jsonl --n-pages 4096
    PYTHONPATH=src python -m repro_torch.uvm.cli export --phases StreamTriad PtrChase --out faults.jsonl
    PYTHONPATH=src python -m repro_torch.uvm.cli server --socket /tmp/uvm.sock
    PYTHONPATH=src python -m repro_torch.uvm.cli loadgen --connect unix:/tmp/uvm.sock --input faults.jsonl

Every executed cell is published to the content-addressed run store
(``experiments/runs_torch/`` by default; ``--runs-dir`` relocates it), so a
repeated invocation is served entirely from disk — the final
``# sweep cells=N hits=H computed=C`` line says how much work actually ran
(a second pass prints ``computed=0``). ``--dump-spec`` writes the
composed :class:`~repro_torch.uvm.api.specs.ExperimentSpec` as JSON, the
declarative artifact ``sweep --spec`` replays.

``serve`` is the streaming side: it drives a live multi-tenant
:class:`~repro_torch.uvm.manager.TenantMux` over a JSONL fault stream (stdin or
``--input``), emitting one JSON action line (prefetch + pre-evict block
ids, pattern, accuracy) per observed batch — the skeleton of a deployable
UVM-backend sidecar.  Input lines::

    {"pages": [0, 1, 2, ...], "pc": [...], "tb": [...], "kernel": [...]}
    {"pages": [...], "tenant": "job-a"}
    {"feedback": {"was_evicted": [false, ...], "fault_count": 128}, "tenant": "job-a"}

``pc``/``tb``/``kernel`` are optional.  The optional ``tenant`` field
(string or int) routes the line to that tenant's own classifier ->
predictor pipeline — tenants are admitted on first contact and the action
line echoes the tag; untagged lines share the ``--default-tenant``
pipeline.  A ``feedback`` line closes its tenant's pending batch (untagged:
the most recently observed one) — without one the batch auto-closes on the
tenant's next observation, fine-tuning without the thrashing term and
leaving the fault clock unchanged.  Malformed lines never produce a
traceback: each yields a structured ``{"error": ..., "line": N}`` record
(and a non-zero exit under ``--strict``).

``export`` is the replay bridge: it writes any workload — a registered
benchmark, a zoo pattern, or a drifting trace composed on the command line
(``--phases``/``--switch``/``--mix-window``, or ``--drift-kind churn`` with
``--joins``/``--spans``) — as a versioned JSONL UVM fault log
(:func:`repro_torch.uvm.trace.to_fault_log`) whose lines feed straight into
``serve``; real logs in the same schema ingest back through
:func:`repro_torch.uvm.trace.from_fault_log`.  The action records ``serve`` emits
carry the live classifier verdict in their ``"pattern"`` field, so a
drifting replay shows the re-classification switch as it happens (tune it
with ``--reclass-interval``/``--reclass-hysteresis``).

``serve`` is fault-tolerant end to end: the degraded-mode health machine
is always on (action records carry ``"health"``/``"fallback"``; a trainer
failure degrades to rule-based actions instead of crashing),
``--checkpoint-dir``/``--checkpoint-every`` persist versioned snapshots at
round boundaries, ``--resume`` restores the latest one and replays only
the unconsumed input tail (bit-identical actions), SIGTERM/SIGINT drain
gracefully (close pending batches, flush a final snapshot + the stats
record), and ``--inject`` runs a seeded chaos schedule against the live
pipeline.  Note: ``--inject`` composed with ``--resume`` replays the
stream-transport faults deterministically but not the dispatch-fault
positions (the injector's RNG is not checkpointed).

``server`` runs many ``serve`` sessions at once, one per connection on a
unix socket and/or a TCP port (:class:`~repro_torch.uvm.server.core.
FaultStreamServer`): each tick one worker thread dispatches every
session's staged half together (``--engine vmap``: one ``evaluate_many``
and one ``train_group_many`` over all of them; ``fused``: the serial calls
in one hop; ``--serial``: one hop per session-tick), and every connection
gets exactly the records ``serve`` would print for its lines.
``loadgen`` replays a fault log over N concurrent connections and reports
faults/s and the p50/p99 action latency.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

from repro_torch.uvm.api import (
    ExperimentSpec,
    ModelSpec,
    PolicySpec,
    PrefetchSpec,
    RunStore,
    Session,
    WorkloadSpec,
)
from repro_torch.uvm.api.specs import PAPER_TRAIN, TrainSpec, parse_scale
from repro_torch.uvm.trace import PAGES_PER_BLOCK
from repro_torch.uvm.zoo import workload_names


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--scale", default="quick",
                    help="'quick' (0.4x traces, <=6000 accesses), 'paper', or a float")
    ap.add_argument("--cap", type=int, default=None, help="max trace length (overrides the scale preset)")
    ap.add_argument("--runs-dir", default=None, help="run-store root (default experiments/runs_torch)")
    ap.add_argument("--no-store", action="store_true", help="compute without reading/writing the run store")
    _add_device(ap)


def _add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="torch device to run on ('cuda' or 'cpu')")


def _session(args) -> Session:
    scale, cap = parse_scale(args.scale, args.cap)
    store = RunStore(args.runs_dir) if args.runs_dir else RunStore()
    if args.no_store:
        store.enabled = False
    model = ModelSpec(train=PAPER_TRAIN if args.scale == "paper" else TrainSpec())
    if args.scale == "paper":
        from repro_torch.configs.predictor_paper import CONFIG

        model = dataclasses.replace(model, predictor=CONFIG)
    return Session(scale=scale, cap=cap, model=model, store=store, device=args.device)


def _strategy_model(session: Session, strategy: str, kind: str) -> ModelSpec | None:
    if strategy != "ours":
        return None
    return dataclasses.replace(session.model, kind=kind, pretrain=session.default_pretrain)


def _print_cell(cell, result) -> None:
    if cell.strategy == "sim":
        label = f"{cell.policy.name}+{cell.prefetch.name}"
    elif cell.strategy == "ours":
        label = f"ours[{cell.model.kind}]"
    else:
        label = "uvmsmart"
    stats = result.stats if hasattr(result, "stats") else result
    extra = f" top1={result.top1:.3f}" if hasattr(result, "top1") else ""
    print(f"{cell.workload.benchmark:>12} {label:>16} @{cell.oversubscription:<5} "
          f"thrash={stats['pages_thrashed']} faults={stats['faults']} "
          f"migrated={stats['migrated_blocks']}{extra}  key={cell.key}")


def cmd_run(args) -> int:
    session = _session(args)
    # build the cell through ExperimentSpec so it hashes IDENTICALLY to the
    # sweep path (non-sim strategies canonicalise their policy/prefetch
    # fields there — a different spelling here would duplicate store entries)
    spec = ExperimentSpec(
        name="run",
        workloads=(session.workload(args.benchmark),),
        strategy=args.strategy,
        policies=(PolicySpec(args.policy),),
        prefetchers=(PrefetchSpec(args.prefetch),),
        oversubscriptions=(args.oversub,),
        model=_strategy_model(session, args.strategy, args.kind),
    )
    [cell] = spec.cells()
    result = session.run(cell)
    _print_cell(cell, result)
    _report_counts("run", session, 1)
    return 0


def _sweep_spec(args, session: Session) -> ExperimentSpec:
    if args.spec:
        return ExperimentSpec.from_json(Path(args.spec).read_text())
    workloads = tuple(session.workload(b) for b in (args.benchmarks or session.benches))
    return ExperimentSpec(
        name=args.name,
        workloads=workloads,
        strategy=args.strategy,
        policies=tuple(PolicySpec(p) for p in args.policies),
        prefetchers=tuple(PrefetchSpec(p) for p in args.prefetchers),
        oversubscriptions=tuple(args.oversubs),
        model=_strategy_model(session, args.strategy, args.kind),
    )


def _report_counts(verb: str, session: Session, n_cells: int) -> None:
    c = session.counters
    hits = c["memory_hits"] + c["store_hits"]
    print(f"# {verb} cells={n_cells} hits={hits} computed={c['computed']} store={session.store.root}")


def cmd_sweep(args) -> int:
    session = _session(args)
    spec = _sweep_spec(args, session)
    if args.dump_spec:
        Path(args.dump_spec).write_text(json.dumps(spec.to_dict(), indent=2, sort_keys=True) + "\n")
        print(f"# wrote {args.dump_spec} (replay with: python -m repro_torch.uvm.cli sweep --spec {args.dump_spec})")
    cells = spec.cells()
    results = session.sweep(cells)
    for cell, result in zip(cells, results):
        _print_cell(cell, result)
    _report_counts("sweep", session, len(cells))
    return 0


def cmd_report(args) -> int:
    store = RunStore(args.runs_dir) if args.runs_dir else RunStore()
    rows = []
    for key, rec in store.records():
        spec, result = rec.get("spec", {}), rec.get("result", {})
        if rec.get("kind") == "CellSpec":
            w = spec["workload"]
            stats = result.get("stats", result)
            rows.append({
                "key": key, "kind": "cell", "benchmark": w["benchmark"],
                "strategy": spec["strategy"],
                "policy": spec["policy"]["name"], "prefetch": spec["prefetch"]["name"],
                "oversub": spec["oversubscription"], "scale": w["scale"],
                "pages_thrashed": stats.get("pages_thrashed"), "faults": stats.get("faults"),
                "top1": round(result["top1"], 3) if "top1" in result else "",
            })
        elif rec.get("kind") == "ProtocolSpec":
            rows.append({
                "key": key, "kind": "protocol", "benchmark": spec["workload"]["benchmark"],
                "strategy": spec["mode"], "policy": "", "prefetch": "",
                "oversub": "", "scale": spec["workload"]["scale"],
                "pages_thrashed": "", "faults": "",
                "top1": round(result["top1"], 3),
            })
    if args.benchmark:
        rows = [r for r in rows if r["benchmark"] == args.benchmark]
    if not rows:
        print(f"# empty run store at {store.root}")
        return 0
    cols = list(rows[0])
    if args.csv:
        import csv

        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols)
            w.writeheader()
            w.writerows(rows)
        print(f"# wrote {args.csv} ({len(rows)} rows)")
    widths = {c: max(len(str(c)), *(len(str(r[c])) for r in rows)) for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(str(r[c]).ljust(widths[c]) for c in cols))
    print(f"# {len(rows)} stored runs in {store.root}")
    return 0


def _manager_config(args):
    """The per-session ManagerConfig ``serve`` builds from its flag set
    (the reference's, which its async server shares)."""
    from repro_torch.configs.predictor_paper import CONFIG_QUICK
    from repro_torch.uvm.manager import HealthConfig, ManagerConfig

    n_blocks = (args.n_pages + args.pages_per_block - 1) // args.pages_per_block
    capacity = args.capacity if args.capacity is not None else max(int(n_blocks / args.oversub), 1)
    return ManagerConfig(
        predictor=CONFIG_QUICK,
        train=dataclasses.replace(TrainSpec(), group_size=args.group_size).to_train_config(),
        kind=args.kind, n_pages=args.n_pages, n_blocks=n_blocks, capacity=capacity,
        pages_per_block=args.pages_per_block,
        classifier=args.classifier, freq_table=args.freq_table,
        reclass_interval=args.reclass_interval, reclass_hysteresis=args.reclass_hysteresis,
        # the streaming surfaces always run the degraded-mode health
        # machine: a live stream must fail SOFT into rule-based actions
        health=HealthConfig(latency_budget_ms=args.latency_budget_ms),
    )


def _qos_controller(args, cfg):
    """The per-session BudgetController the shared --qos-* flags describe
    (``None`` when no tier is declared = the legacy shared pool)."""
    if not args.qos_tier:
        return None
    from repro_torch.uvm.qos import BudgetController, parse_tier_flags

    return BudgetController(
        cfg.capacity, cfg.n_blocks, tiers=parse_tier_flags(args.qos_tier),
        stability=args.qos_stability, interval=args.qos_interval,
    )


def cmd_serve(args) -> int:
    import signal

    from repro_torch.uvm.manager import TenantMux
    from repro_torch.uvm.server.session import StreamSession, SyncDispatch, drive

    cfg = _manager_config(args)
    # tenants are admitted on first contact (auto_create): every "tenant"-
    # tagged line gets its own classifier->predictor pipeline; untagged
    # lines share the --default-tenant one (the single-workload case)
    mux = TenantMux(cfg, shared_freq_table=args.shared_freq_table,
                    qos=_qos_controller(args, cfg), device=args.device)
    injector = None
    if args.inject:
        from repro_torch.uvm.manager import ChaosSchedule, FaultInjector

        # wrap BEFORE any tenant is admitted so lazily-created managers
        # inherit the chaos trainer (and restore() rebuilds through it)
        injector = FaultInjector(ChaosSchedule.parse(args.inject))
        mux.trainer = injector.wrap_trainer(mux.trainer)
    store = None
    if args.checkpoint_dir:
        from repro_torch.uvm.manager import SnapshotStore

        store = SnapshotStore(args.checkpoint_dir)
        store.clean_tmp()  # sweep turds a killed writer left behind
    session = StreamSession(mux, default_tenant=args.default_tenant,
                            store=store, checkpoint_every=args.checkpoint_every)
    if args.resume:
        if store is None:
            print("# serve --resume requires --checkpoint-dir", file=sys.stderr)
            return 2
        if store.latest_step() is not None:
            batches, resume_lineno = session.resume_latest()
            print(f"# resumed batch={batches} lineno={resume_lineno} "
                  f"tenants={len(mux.managers)} from {store.dir}", flush=True)
    # open the input only after every early-exit validation above: an
    # early `return 2` must not leak the handle (pytest's unraisable
    # gate turns the ResourceWarning into a failure)
    fh = sys.stdin if args.input == "-" else open(args.input)
    dispatch = SyncDispatch(mux.trainer, cfg.use_lucir)

    # SIGTERM/SIGINT: finish the current line, close pending batches, flush
    # a final snapshot + the stats record, exit 0 (a drain, not a crash)
    stop: dict = {}
    installed = {}
    for signame in ("SIGTERM", "SIGINT"):
        signum = getattr(signal, signame)
        try:
            installed[signum] = signal.signal(
                signum, lambda s, _frame: stop.__setitem__("signal", s)
            )
        except ValueError:  # not the main thread (embedded callers)
            pass
    line_iter = injector.transform_lines(fh) if injector is not None else fh
    try:
        for line in line_iter:
            if stop:
                break
            for rec in drive(session.step(line), dispatch):
                print(rec, flush=True)
        drive(session.drain(), dispatch)
    finally:
        for signum, old in installed.items():
            signal.signal(signum, old)
        if fh is not sys.stdin:
            fh.close()
    if store is not None:
        session.save_snapshot()
    if injector is not None:
        fired = {k: injector.counts[k] for k in sorted(injector.counts)}
        print(f"# chaos schedule={json.dumps(injector.schedule.to_dict(), sort_keys=True)} "
              f"fired={json.dumps(fired)}", flush=True)
    if stop:
        print(f"# serve shutdown signal={stop['signal']} (state flushed)", flush=True)
    print(session.summary_line())
    return 2 if session.errors and args.strict else 0


def cmd_server(args) -> int:
    """Async fault-stream server: many concurrent serve sessions, one
    cross-connection microbatched trainer dispatch per tick."""
    import asyncio
    import signal

    from repro_torch.core.incremental import Trainer
    from repro_torch.uvm.server.core import FaultStreamServer, ServerConfig

    mcfg = _manager_config(args)
    cfg = ServerConfig(
        manager=mcfg, default_tenant=args.default_tenant,
        shared_freq_table=args.shared_freq_table,
        max_sessions=args.max_sessions, idle_timeout_s=args.idle_timeout,
        gather_spins=args.gather_spins, microbatch=not args.serial,
        exec_mode=args.engine,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
        resume=args.resume, inject=args.inject,
        qos_tiers=args.qos_tier, qos_stability=args.qos_stability,
        qos_interval=args.qos_interval,
    )
    if args.socket is None and args.port is None:
        print("# server needs --socket PATH and/or --port N", file=sys.stderr)
        return 2

    async def main() -> int:
        trainer = Trainer(mcfg.predictor, mcfg.train, mcfg.kind, args.device)
        if args.aot_cache:
            from repro_torch.uvm.server.aot import enable_aot

            enable_aot(trainer, args.aot_cache)
        server = FaultStreamServer(cfg, trainer=trainer, device=args.device)
        await server.start(path=args.socket, host=args.host if args.port is not None else None,
                           port=args.port or 0)
        where = " ".join(filter(None, [
            f"unix={args.socket}" if args.socket else None,
            f"tcp={args.host}:{server.tcp_port}" if args.port is not None else None,
        ]))
        mode = "serial" if args.serial else f"batched-{server.dispatcher.engine}"
        # the handlers are in place before the banner, so a SIGTERM sent as
        # soon as it is read drains the server instead of killing it
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(signum, stop.set)
            except NotImplementedError:  # pragma: no cover - non-unix loops
                pass
        print(f"# server listening {where} mode={mode} "
              f"max_sessions={cfg.max_sessions}", flush=True)
        stopper = asyncio.ensure_future(stop.wait())
        forever = asyncio.ensure_future(server.serve_forever())
        await asyncio.wait({stopper, forever}, return_when=asyncio.FIRST_COMPLETED)
        forever.cancel()
        await server.shutdown()
        if server.injector is not None:
            inj = server.injector
            fired = {k: inj.counts[k] for k in sorted(inj.counts)}
            print(f"# chaos schedule={json.dumps(inj.schedule.to_dict(), sort_keys=True)} "
                  f"fired={json.dumps(fired)}", flush=True)
        if args.aot_cache:
            print(f"# aot cache={args.aot_cache} {json.dumps(trainer.aot_cache.stats())}",
                  flush=True)
        print(server.summary_line(), flush=True)
        return 0

    return asyncio.run(main())


def cmd_loadgen(args) -> int:
    """Deterministic multi-client replay of an exported fault log against
    a running server; reports faults/sec + p50/p99 action latency."""
    import asyncio

    from repro_torch.uvm.server.loadgen import make_connector, run_loadgen

    with (sys.stdin if args.input == "-" else open(args.input)) as fh:
        lines = [l.rstrip("\n") for l in fh if l.strip() and not l.startswith("#")]
    chaos_schedules = {}
    if args.inject is not None:
        from repro_torch.uvm.manager import ChaosSchedule, FaultInjector

        chaos_schedules[args.chaos_client] = FaultInjector(ChaosSchedule.parse(args.inject))
    stats = asyncio.run(run_loadgen(
        make_connector(args.connect), lines, args.clients, rate=args.rate,
        repeat=args.repeat, hello_prefix=args.hello_prefix,
        chaos_schedules=chaos_schedules,
        malformed_every=args.malformed_every, malformed_client=args.malformed_client,
    ))
    if args.json:
        payload = {k: v for k, v in dataclasses.asdict(stats).items() if k != "per_client"}
        Path(args.json).write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    print(f"# loadgen clients={stats.clients} lines={stats.lines_sent} "
          f"actions={stats.actions} errors={stats.errors} faults={stats.faults} "
          f"wall_s={stats.wall_s:.3f} faults_per_s={stats.faults_per_s:.1f} "
          f"p50_ms={stats.p50_ms:.2f} p99_ms={stats.p99_ms:.2f}")
    return 0


def _export_workload(args, session: Session) -> WorkloadSpec:
    if args.phases:
        return WorkloadSpec.drifting(
            tuple(args.phases), kind=args.drift_kind, scale=session.scale, cap=session.cap,
            segment=args.segment, switch=args.switch, mix_window=args.mix_window,
            joins=tuple(args.joins or ()), spans=tuple(args.spans or ()),
            slice_len=args.slice_len, seed=args.seed,
        )
    if not args.benchmark:
        raise SystemExit("export needs --benchmark or --phases")
    return session.workload(args.benchmark)


def cmd_export(args) -> int:
    from repro_torch.uvm.trace import to_fault_log

    session = _session(args)
    w = _export_workload(args, session)
    tr = session.trace(w)
    out = sys.stdout if args.out == "-" else args.out
    lines = to_fault_log(tr, out, batch=args.batch)
    print(f"# export workload={w.benchmark} accesses={len(tr)} n_pages={tr.n_pages} "
          f"tenants={len(tr.tenant_names)} lines={lines} out={args.out}",
          file=sys.stderr if args.out == "-" else sys.stdout)
    return 0


SUBCOMMANDS = {"run": cmd_run, "sweep": cmd_sweep, "report": cmd_report,
               "serve": cmd_serve, "server": cmd_server, "loadgen": cmd_loadgen,
               "export": cmd_export}


def _add_stream_flags(p) -> None:
    """The per-session manager surface of `serve` (the reference's, which
    its async server shares): one flag set -> one ManagerConfig
    (:func:`_manager_config`)."""
    p.add_argument("--n-pages", type=int, default=4096, help="working-set size in pages")
    p.add_argument("--pages-per-block", type=int, default=PAGES_PER_BLOCK,
                   help="pages per management block (1 = manage pages directly)")
    p.add_argument("--oversub", type=float, default=1.25,
                   help="oversubscription level (sets the prefetch-budget capacity)")
    p.add_argument("--capacity", type=int, default=None,
                   help="device capacity in blocks (overrides --oversub)")
    p.add_argument("--kind", default="transformer", help="registered predictor kind")
    p.add_argument("--classifier", default="dfa", help="registered pattern classifier")
    p.add_argument("--freq-table", default="setassoc", help="registered frequency-table engine")
    p.add_argument("--group-size", type=int, default=512, help="fine-tune schedule group size")
    p.add_argument("--default-tenant", default="default",
                   help="tenant id for JSONL lines without a per-line 'tenant' field "
                        "(tagged lines each get their own classifier->predictor pipeline)")
    p.add_argument("--shared-freq-table", action="store_true",
                   help="tenants share ONE prediction-frequency table (default: isolated per tenant)")
    p.add_argument("--reclass-interval", type=int, default=0,
                   help="re-run the pattern classifier every N faults (observed accesses "
                        "when no feedback reports a fault count; 0 = every batch)")
    p.add_argument("--reclass-hysteresis", type=int, default=2,
                   help="consecutive agreeing windows before a pattern switch")
    p.add_argument("--checkpoint-dir", default=None,
                   help="snapshot directory (versioned, content-hashed manager state; "
                        "also written once on shutdown)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="snapshot after every N observed batches, at the next fully "
                        "fed-back round boundary (0 = only the shutdown snapshot)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest snapshot in --checkpoint-dir and skip the "
                        "input lines it already consumed (the resumed action tail is "
                        "bit-identical to an uninterrupted run)")
    p.add_argument("--inject", default=None,
                   help="seeded chaos schedule, 'key=prob,...,seed=N' or '@plan.json' "
                        "(see repro_torch.uvm.manager.chaos); exercises the health machine — "
                        "degraded rounds answer with rule-based fallback actions "
                        "(health/fallback fields on every action record)")
    p.add_argument("--latency-budget-ms", type=float, default=0.0,
                   help="per-observe dispatch budget in ms; overruns demote the learned "
                        "path to degraded health (0 = no budget)")
    p.add_argument("--qos-tier", action="append", default=None, metavar="TENANT:FLOOR[:SHARE]",
                   help="per-tenant QoS tier (repeatable): guaranteed FLOOR fraction of "
                        "device capacity plus elastic SHARE weight (default 1.0); any "
                        "--qos-tier turns on budgeted eviction — over-budget tenants' "
                        "blocks are evicted before any under-budget tenant's, and each "
                        "action record gains the tenant's current 'budget'")
    p.add_argument("--qos-stability", default="percentile",
                   help="registered stability scorer weighting the elastic pool "
                        "(percentile | gmr; see repro_torch.uvm.qos)")
    p.add_argument("--qos-interval", type=int, default=1,
                   help="feedback rounds between budget recomputes")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.uvm.cli", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="execute (or look up) one experiment cell")
    _add_common(p_run)
    p_run.add_argument("--benchmark", required=True, choices=workload_names())
    p_run.add_argument("--strategy", default="sim", choices=("sim", "ours", "uvmsmart"))
    p_run.add_argument("--policy", default="lru", help="registered eviction policy (sim)")
    p_run.add_argument("--prefetch", default="tree", help="registered prefetcher (sim)")
    p_run.add_argument("--oversub", type=float, default=1.25)
    p_run.add_argument("--kind", default="transformer", help="registered predictor kind (ours)")

    p_sweep = sub.add_parser("sweep", help="execute a cross-product of cells in batched lanes")
    _add_common(p_sweep)
    p_sweep.add_argument("--spec", default=None, help="ExperimentSpec JSON to replay (overrides the axes)")
    p_sweep.add_argument("--name", default="sweep")
    p_sweep.add_argument("--benchmarks", nargs="*", default=None, choices=workload_names())
    p_sweep.add_argument("--strategy", default="sim", choices=("sim", "ours", "uvmsmart"))
    p_sweep.add_argument("--policies", nargs="*", default=["lru"])
    p_sweep.add_argument("--prefetchers", nargs="*", default=["tree"])
    p_sweep.add_argument("--oversubs", nargs="*", type=float, default=[1.25])
    p_sweep.add_argument("--kind", default="transformer")
    p_sweep.add_argument("--dump-spec", default=None, help="write the composed ExperimentSpec JSON here")

    p_rep = sub.add_parser("report", help="tabulate the persistent run store")
    p_rep.add_argument("--runs-dir", default=None)
    p_rep.add_argument("--benchmark", default=None)
    p_rep.add_argument("--csv", default=None, help="also write the table as CSV")

    p_srv = sub.add_parser("serve", help="drive the streaming manager over a JSONL fault stream")
    p_srv.add_argument("--input", default="-", help="JSONL fault-batch stream ('-' = stdin)")
    _add_stream_flags(p_srv)
    _add_device(p_srv)
    p_srv.add_argument("--strict", action="store_true",
                       help="exit non-zero if any malformed line was reported")

    p_ssrv = sub.add_parser(
        "server",
        help="async fault-stream server: many concurrent serve sessions, one "
             "cross-connection microbatched ('tenant'-aware, health-guarded) "
             "trainer dispatch per tick; action records carry the same "
             '"pattern"/"health"/"fallback" fields as serve',
    )
    _add_stream_flags(p_ssrv)
    _add_device(p_ssrv)
    p_ssrv.add_argument("--socket", default=None,
                        help="unix socket path to listen on (and/or --port)")
    p_ssrv.add_argument("--host", default="127.0.0.1", help="TCP bind host (with --port)")
    p_ssrv.add_argument("--port", type=int, default=None,
                        help="TCP port to listen on (0 = ephemeral, announced on startup)")
    p_ssrv.add_argument("--max-sessions", type=int, default=4096,
                        help="admission cap: concurrent connections beyond it are refused "
                             "with a structured error record")
    p_ssrv.add_argument("--idle-timeout", type=float, default=0.0,
                        help="close (drain + snapshot) connections idle this many seconds "
                             "(0 = never)")
    p_ssrv.add_argument("--gather-spins", type=int, default=2,
                        help="event-loop passes the dispatcher waits per tick so every "
                             "connection with buffered input stages its half")
    p_ssrv.add_argument("--serial", action="store_true",
                        help="per-connection serial dispatch instead of cross-connection "
                             "microbatching (the baseline; action streams are "
                             "bit-identical either way)")
    p_ssrv.add_argument("--engine", choices=("auto", "vmap", "fused"), default="auto",
                        help="how a microbatched tick executes: 'vmap' makes one "
                             "evaluate_many (a bucket of 4 or more transformer lanes "
                             "stacked into one attention launch per block and layer) and "
                             "one train_group_many over every lane, 'fused' sweeps the "
                             "serial calls in one worker hop; 'auto' is vmap with more "
                             "than one CUDA device, else fused")
    p_ssrv.add_argument("--aot-cache", default=None,
                        help="directory the CUDA kernel library is built into and loaded "
                             "from: a build already there is reused, so a fresh process "
                             "skips nvcc")

    p_lg = sub.add_parser(
        "loadgen",
        help="deterministic multi-client load generator: replay an exported "
             "fault log over N concurrent server connections at a target rate",
    )
    p_lg.add_argument("--connect", required=True,
                      help="server address: 'unix:/path/to.sock' or 'host:port'")
    p_lg.add_argument("--input", default="-",
                      help="JSONL fault log every client replays ('-' = stdin)")
    p_lg.add_argument("--clients", type=int, default=8, help="concurrent connections")
    p_lg.add_argument("--rate", type=float, default=0.0,
                      help="per-client lines/second pacing (0 = as fast as the "
                           "closed loop allows)")
    p_lg.add_argument("--repeat", type=int, default=1, help="replay passes per client")
    p_lg.add_argument("--hello-prefix", default=None,
                      help="send a hello line naming each session '<prefix><idx>' "
                           "(binds server-side checkpoints/resume)")
    p_lg.add_argument("--malformed-every", type=int, default=0,
                      help="the --malformed-client injects a non-JSON line every N lines")
    p_lg.add_argument("--malformed-client", type=int, default=None,
                      help="index of the client that injects malformed lines")
    p_lg.add_argument("--inject", default=None,
                      help="seeded chaos schedule applied to the --chaos-client's OUTGOING "
                           "stream (transform_lines: drops/dups/reorders/losses)")
    p_lg.add_argument("--chaos-client", type=int, default=0,
                      help="index of the client whose stream --inject transforms")
    p_lg.add_argument("--json", default=None, help="also write the aggregate stats as JSON")

    p_exp = sub.add_parser(
        "export",
        help="write a workload (benchmark or drifting zoo trace) as a versioned "
             "JSONL UVM fault log, ready to replay through `serve`",
    )
    _add_common(p_exp)
    p_exp.add_argument("--benchmark", default=None, choices=workload_names(),
                       help="a registered workload (the 11-benchmark suite + the zoo patterns)")
    p_exp.add_argument("--phases", nargs="*", default=None,
                       help="build a drifting zoo trace instead: two or more workload names, "
                            "spliced (--drift-kind phase) or merged as churning tenants "
                            "(--drift-kind churn)")
    p_exp.add_argument("--drift-kind", default="phase", choices=("phase", "churn"))
    p_exp.add_argument("--segment", type=int, default=1500,
                       help="accesses per phase segment (--drift-kind phase)")
    p_exp.add_argument("--switch", default="abrupt", choices=("abrupt", "gradual"),
                       help="phase-boundary style; 'gradual' blends --mix-window accesses")
    p_exp.add_argument("--mix-window", type=int, default=0,
                       help="accesses blended around each gradual phase boundary")
    p_exp.add_argument("--joins", nargs="*", type=int, default=None,
                       help="per-tenant admission offsets in merged accesses (churn; "
                            "default: auto-staggered)")
    p_exp.add_argument("--spans", nargs="*", type=int, default=None,
                       help="per-tenant access budgets (churn; 0 = the full trace)")
    p_exp.add_argument("--slice-len", type=int, default=256, help="scheduler-slice length (churn)")
    p_exp.add_argument("--seed", type=int, default=0, help="zoo generator seed")
    p_exp.add_argument("--batch", type=int, default=256, help="accesses per fault-log line")
    p_exp.add_argument("--out", default="-", help="output path ('-' = stdout)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return SUBCOMMANDS[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
