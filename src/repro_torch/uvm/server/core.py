"""The asyncio fault-stream server: many sessions, one dispatch per tick
(port of ``repro.uvm.server.core``).

:class:`FaultStreamServer` accepts JSONL fault-stream clients on a unix
and/or TCP socket, binds each connection to its own
:class:`~repro_torch.uvm.manager.TenantMux`-backed
:class:`~repro_torch.uvm.server.session.StreamSession` (health machine
always on, per-session checkpoints under ``checkpoint_dir/<session>/``),
and suspends every session at its staged
:class:`~repro_torch.uvm.server.session.EvalTick` /
:class:`~repro_torch.uvm.server.session.TrainTick`.
:class:`MicrobatchDispatcher` is the lockstep engine
(:func:`repro_torch.uvm.runtime.run_ours_many` spread across
connections): each tick it drains every session's staged halves and
executes them in ONE worker hop on a shared trainer, off the event loop so
new lines keep streaming in while the model dispatch runs.  How the hop
executes follows :func:`_resolve_engine`: one ``Trainer.evaluate_many``
over every lane and one ``train_group_many`` (each stacks a bucket of
four or more transformer lanes: one attention launch per block and layer,
and per fine-tune step), or a fused sweep of the serial calls.
``microbatch=False`` drops the gathering entirely — every session-tick
becomes its own executor task and event-loop round-trip, the
per-connection baseline.  All modes emit bit-identical per-connection
action streams (lanes are independent models and ``evaluate_many`` is
bit-identical to its serial calls, so neither tick composition nor
dispatch order can leak between sessions); a chaos-wrapped shared trainer
is the one exception — its seeded schedule fires per dispatch call, so
only the deterministic microbatched modes replay it reproducibly.

Isolation: a malformed line earns its connection a structured error
record, an overlong line closes that connection, and a failed batched
dispatch is absorbed by each session's degraded-mode health machine —
none of it stalls or corrupts the other sessions' action streams.

Where the port differs from the reference:

* **One worker thread owns the device.**  The dispatcher runs its work on
  a single-worker ``ThreadPoolExecutor`` in every mode, and everything
  that touches a session's state runs there: building the session's mux,
  advancing its generator (classification, the frequency table's
  ``freq_update`` launch and dense export in ``observe``, the fine-tune
  staging in ``feedback``), the trainer dispatch and the final snapshot.
  The event loop thread reads and writes sockets and never touches the
  card, so every launch goes to one CUDA stream in one order and the
  kernels' launch counters (``repro_torch.kernels.LAUNCHES``, not
  thread-safe) stay exact.  In the reference the loop thread advances the
  generators and, with ``microbatch=False``, the default executor runs
  several session-ticks at once; here they run one at a time.
* **A hop advances the generators.**  A hop takes every gathered
  session's staged tick (starting the line's generator first when it has
  none), dispatches them together, and sends each result back into its
  generator up to that session's next tick or the end of its line.  A
  session with a next tick joins the following gather; one that finished
  its line answers its records.
* **No environment knob.**  ``auto`` is ``vmap`` when more than one CUDA
  device is visible and ``fused`` otherwise; ``exec_mode="vmap"``
  (``--engine vmap``) does what the reference's
  ``REPRO_OURS_BATCHED=1`` did.
"""
from __future__ import annotations

import asyncio
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.core.incremental import Trainer
from repro_torch.device import resolve_device
from repro_torch.uvm.manager import (
    ChaosSchedule,
    FaultInjector,
    ManagerConfig,
    SnapshotStore,
    TenantMux,
)
from repro_torch.uvm.server.protocol import ProtocolError, encode_error
from repro_torch.uvm.server.session import EvalTick, SyncDispatch, StreamSession, TrainTick


@dataclasses.dataclass
class ServerConfig:
    """Everything the server needs beyond the per-session ManagerConfig."""

    manager: ManagerConfig
    default_tenant: str = "default"
    shared_freq_table: bool = False
    max_sessions: int = 4096  # admission cap; excess connections are refused
    idle_timeout_s: float = 0.0  # close connections idle this long (0 = never)
    gather_spins: int = 2  # event-loop passes that gather staged halves per tick
    microbatch: bool = True  # False: per-connection serial dispatch (baseline)
    exec_mode: str = "auto"  # batched tick engine: 'auto' | 'vmap' | 'fused'
    checkpoint_dir: str | None = None  # named sessions snapshot under <dir>/<name>/
    checkpoint_every: int = 0
    resume: bool = False  # restore a named session's latest snapshot on hello
    inject: str | None = None  # chaos schedule for the SHARED trainer
    line_limit: int = 1 << 20  # bytes; longer lines close the connection
    # per-session QoS capacity partitioning: raw --qos-tier strings
    # (TENANT:FLOOR[:SHARE]); None/empty = the legacy shared pool.  Each
    # connection gets its OWN BudgetController — sessions are isolated
    qos_tiers: list | None = None
    qos_stability: str = "percentile"
    qos_interval: int = 1


def _resolve_engine(exec_mode: str) -> str:
    """How a gathered tick executes: ``vmap`` makes one ``evaluate_many``
    (stacked per bucket) and one ``train_group_many`` over every lane;
    ``fused`` sweeps the lanes through the serial calls inside ONE worker
    hop.  ``auto`` is ``vmap`` when more than one CUDA device is visible,
    else ``fused`` (the reference's device-count policy; the port reads no
    environment variable)."""
    if exec_mode in ("vmap", "fused"):
        return exec_mode
    if exec_mode != "auto":
        raise ValueError(f"exec_mode must be auto|vmap|fused, got {exec_mode!r}")
    return "vmap" if torch.cuda.device_count() > 1 else "fused"


_START = object()  # the value that starts a session generator (``next`` instead of ``send``)


def _advance(gen, value):
    """Advance one session generator: ``(True, records)`` at its end, else
    ``(False, next_tick)``."""
    try:
        tick = next(gen) if value is _START else gen.send(value)
    except StopIteration as stop:
        return True, stop.value or []
    return False, tick


class MicrobatchDispatcher:
    """Cross-connection lockstep dispatcher.

    Sessions hand :meth:`run_step` one line's generator and suspend on a
    future; the run loop wakes, spins the event loop ``gather_spins`` times
    so every connection with buffered input can stage its line too, then
    cuts the batch and executes it in ONE hop on the worker thread
    (vmapped or fused per :func:`_resolve_engine`) so the socket side keeps
    streaming.  Results (or the shared exception — each session's health
    machine absorbs it) go back into the generators on the worker.

    With ``microbatch=False`` there is no gathering at all: every
    session-tick is its own executor task plus its own event-loop
    round-trip — the per-connection serial baseline.
    """

    def __init__(self, trainer, *, use_lucir: bool = False, microbatch: bool = True,
                 gather_spins: int = 2, exec_mode: str = "auto"):
        self.trainer = trainer
        self.use_lucir = use_lucir
        self.microbatch = microbatch
        self.engine = _resolve_engine(exec_mode)
        self.gather_spins = gather_spins
        self._sync = SyncDispatch(trainer, use_lucir)
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="repro-dispatch")
        self._pending: list = []  # [(generator, staged tick or None, future)]
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self.n_ticks = 0
        self.n_eval_requests = 0
        self.n_train_requests = 0
        self.max_eval_lanes = 0  # widest single gathered tick this run

    def start(self) -> None:
        self._wake = asyncio.Event()
        self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for _gen, _tick, fut in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending = []
        self._executor.shutdown(wait=True)

    async def call(self, fn, *args):
        """``fn(*args)`` on the worker thread (session state that may touch
        the device is built, read and saved there)."""
        return await asyncio.get_running_loop().run_in_executor(self._executor, fn, *args)

    async def run_step(self, gen) -> list:
        """Drive one session generator (``StreamSession.step``/``drain``) to
        its end through the dispatcher; returns its encoded records."""
        if not self.microbatch:
            tick = None
            while True:
                done, out = await self.call(self._serial_tick, gen, tick)
                if done:
                    return out
                tick = out
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((gen, None, fut))
        self._wake.set()
        return await fut

    def _count(self, tick) -> None:
        if isinstance(tick, EvalTick):
            self.n_eval_requests += len(tick.reqs)
        else:
            self.n_train_requests += len(tick.reqs)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._wake.wait()
            for _ in range(self.gather_spins):
                await asyncio.sleep(0)
            batch, self._pending = self._pending, []
            self._wake.clear()
            if not batch:
                continue
            outs = await loop.run_in_executor(self._executor, self._hop, [(g, t) for g, t, _ in batch])
            for (gen, _t, fut), (kind, val) in zip(batch, outs):
                if fut.done():
                    continue
                if kind == "tick":  # staged its next half: joins the next gather
                    self._pending.append((gen, val, fut))
                elif kind == "done":
                    fut.set_result(val)
                else:
                    fut.set_exception(val)
            if self._pending:
                self._wake.set()

    # -- worker-thread side (no loop state) --------------------------------------

    def _serial_tick(self, gen, tick):
        """One session-tick of the serial baseline: start the line when no
        tick is staged, dispatch the tick alone, advance to the next."""
        if tick is None:
            done, tick = _advance(gen, _START)
            if done:
                return True, tick
        self.n_ticks += 1
        self._count(tick)
        return _advance(gen, self._sync(tick))

    def _hop(self, batch: list) -> list:
        """One gathered tick: start the generators that have no staged tick,
        dispatch every staged tick together, and send the results back.
        Returns ``(kind, value)`` per entry: ``("tick", next_tick)``,
        ``("done", records)``, or ``("error", exc)`` for an exception the
        session's own code raised."""
        out: list = [None] * len(batch)
        staged = []
        for j, (gen, tick) in enumerate(batch):
            if tick is None:
                try:
                    done, tick = _advance(gen, _START)
                except Exception as exc:  # noqa: BLE001 — that connection's handler raises it
                    out[j] = ("error", exc)
                    continue
                if done:
                    out[j] = ("done", tick)
                    continue
            staged.append((j, gen, tick))
        if not staged:
            return out
        self.n_ticks += 1
        for _j, _g, t in staged:
            self._count(t)
        evals = [s for s in staged if isinstance(s[2], EvalTick)]
        trains = [s for s in staged if isinstance(s[2], TrainTick)]
        self.max_eval_lanes = max(self.max_eval_lanes, sum(len(t.reqs) for _, _, t in evals))
        eval_out, train_out = self._dispatch([t for _, _, t in evals], [t for _, _, t in trains])
        for (j, gen, _t), res in zip(evals + trains, eval_out + train_out):
            try:
                done, val = _advance(gen, res)
            except Exception as exc:  # noqa: BLE001
                out[j] = ("error", exc)
                continue
            out[j] = ("done", val) if done else ("tick", val)
        return out

    def _dispatch(self, evals: list, trains: list):
        if self.engine == "fused":
            # the gathered lanes sweep through the serial calls inside this
            # single worker hop — amortizes the executor/loop churn
            return [self._sync(t) for t in evals], [self._sync(t) for t in trains]
        return self._dispatch_evals(evals), self._dispatch_trains(trains)

    def _dispatch_evals(self, evals: list):
        flat = [r for t in evals for r in t.reqs]
        if not flat:
            return [[] for _ in evals]
        try:
            out = self.trainer.evaluate_many(
                [r.params for r in flat], [r.fs for r in flat], [r.n_active for r in flat])
        except Exception as exc:  # noqa: BLE001 — every session's health machine decides
            return [exc for _ in evals]
        results, i = [], 0
        for t in evals:
            results.append(out[i:i + len(t.reqs)])
            i += len(t.reqs)
        return results

    def _dispatch_trains(self, trains: list):
        flat = [r for t in trains for r in t.reqs]
        if not flat:
            return [None for _ in trains]
        try:
            self.trainer.train_group_many(
                [r.entry for r in flat], [r.fs for r in flat], [r.n_active for r in flat],
                in_et_list=[r.in_et for r in flat], use_lucir=self.use_lucir)
        except Exception as exc:  # noqa: BLE001
            return [exc for _ in trains]
        return [None for _ in trains]


class _Handle:
    __slots__ = ("name", "session", "writer", "last_active")

    def __init__(self, name, session, writer, last_active):
        self.name = name
        self.session = session
        self.writer = writer
        self.last_active = last_active


class FaultStreamServer:
    """Accept loop + session registry around :class:`MicrobatchDispatcher`.
    The shared trainer runs on ``device`` (the card unless the caller asks
    for the CPU); a caller's ``trainer`` must live there too."""

    def __init__(self, cfg: ServerConfig, *, trainer=None, device: str | torch.device = "cuda"):
        self.cfg = cfg
        mcfg = cfg.manager
        self.device = resolve_device(device)
        self.trainer = trainer if trainer is not None else Trainer(mcfg.predictor, mcfg.train, mcfg.kind, self.device)
        self.injector = None
        if cfg.inject:
            # wrap the SHARED trainer: every session's dispatches draw from
            # one seeded schedule, exactly like serve --inject
            self.injector = FaultInjector(ChaosSchedule.parse(cfg.inject))
            self.trainer = self.injector.wrap_trainer(self.trainer)
        self.dispatcher = MicrobatchDispatcher(
            self.trainer, use_lucir=mcfg.use_lucir,
            microbatch=cfg.microbatch, gather_spins=cfg.gather_spins,
            exec_mode=cfg.exec_mode)
        self.sessions: dict = {}  # name -> _Handle
        self.stats = {"served": 0, "refused": 0, "idle_closed": 0, "resumed": 0}
        self._conn_seq = 0
        self._servers: list = []
        self._gc_task: asyncio.Task | None = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self, *, path: str | None = None, host: str | None = None,
                    port: int = 0) -> "FaultStreamServer":
        self.dispatcher.start()
        if self.cfg.idle_timeout_s > 0:
            self._gc_task = asyncio.ensure_future(self._gc())
        if path is not None:
            self._servers.append(await asyncio.start_unix_server(
                self._handle, path=path, limit=self.cfg.line_limit))
        if host is not None:
            self._servers.append(await asyncio.start_server(
                self._handle, host=host, port=port, limit=self.cfg.line_limit))
        if not self._servers:
            raise ValueError("server needs a unix socket path and/or a TCP host")
        return self

    @property
    def tcp_port(self) -> int | None:
        for srv in self._servers:
            for sock in srv.sockets:
                name = sock.getsockname()
                if isinstance(name, tuple):
                    return name[1]
        return None

    async def serve_forever(self) -> None:
        await asyncio.gather(*(s.serve_forever() for s in self._servers))

    async def shutdown(self, timeout: float = 30.0) -> None:
        """Graceful drain: stop accepting, close every client connection
        (their handlers run the normal EOF drain + final snapshot), wait
        for the registry to empty, then stop the dispatcher."""
        for srv in self._servers:
            srv.close()
        for handle in list(self.sessions.values()):
            handle.writer.close()
        deadline = asyncio.get_running_loop().time() + timeout
        while self.sessions and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.02)
        if self._gc_task is not None:
            self._gc_task.cancel()
            try:
                await self._gc_task
            except asyncio.CancelledError:
                pass
            self._gc_task = None
        await self.dispatcher.stop()
        for srv in self._servers:
            await srv.wait_closed()

    def summary_line(self) -> str:
        d = self.dispatcher
        return (f"# server sessions={self.stats['served']} refused={self.stats['refused']} "
                f"idle_closed={self.stats['idle_closed']} resumed={self.stats['resumed']} "
                f"ticks={d.n_ticks} eval_requests={d.n_eval_requests} "
                f"train_requests={d.n_train_requests} max_eval_lanes={d.max_eval_lanes} "
                f"mode={f'batched-{d.engine}' if d.microbatch else 'serial'}")

    # -- per-connection plumbing (the session's own calls run on the worker) --

    def _new_session(self, handle: _Handle) -> StreamSession:
        qos = None
        if self.cfg.qos_tiers:
            from repro_torch.uvm.qos import BudgetController, parse_tier_flags

            # a fresh controller per connection: budgets partition each
            # session's OWN device capacity, never across sessions
            qos = BudgetController(
                self.cfg.manager.capacity, self.cfg.manager.n_blocks,
                tiers=parse_tier_flags(self.cfg.qos_tiers),
                stability=self.cfg.qos_stability, interval=self.cfg.qos_interval,
            )
        mux = TenantMux(self.cfg.manager, shared_freq_table=self.cfg.shared_freq_table,
                        trainer=self.trainer, qos=qos, device=self.device)
        return StreamSession(mux, default_tenant=self.cfg.default_tenant,
                             on_hello=lambda session, name: self._on_hello(handle, session, name))

    def _on_hello(self, handle: _Handle, session: StreamSession, name):
        if name is None:
            return None
        other = self.sessions.get(name)
        if other is not None and other is not handle:
            raise ProtocolError(f"session name {name!r} already in use")
        self.sessions.pop(handle.name, None)
        handle.name = session.name = name
        self.sessions[name] = handle
        if not self.cfg.checkpoint_dir:
            return None
        store = SnapshotStore(str(Path(self.cfg.checkpoint_dir) / name))
        store.clean_tmp()
        session.store = store
        session.checkpoint_every = self.cfg.checkpoint_every
        if self.cfg.resume and store.latest_step() is not None:
            batches, resume_lineno = session.resume_latest()
            self.stats["resumed"] += 1
            return (f"# resumed batch={batches} lineno={resume_lineno} "
                    f"tenants={len(session.mux.managers)} from {store.dir}")
        return None

    @staticmethod
    def _finish_session(session: StreamSession) -> str:
        """The final snapshot (named sessions with a store) and the summary
        line ``serve`` prints."""
        if session.store is not None:
            session.save_snapshot()
        return session.summary_line()

    async def _handle(self, reader, writer) -> None:
        loop = asyncio.get_running_loop()
        if len(self.sessions) >= self.cfg.max_sessions:
            self.stats["refused"] += 1
            with _swallow_transport_errors():
                writer.write((encode_error(
                    f"server full ({self.cfg.max_sessions} sessions)", 0) + "\n").encode())
                await writer.drain()
            writer.close()
            return
        handle = _Handle(f"conn-{self._conn_seq}", None, writer, loop.time())
        self._conn_seq += 1
        self.sessions[handle.name] = handle
        self.stats["served"] += 1
        try:
            handle.session = session = await self.dispatcher.call(self._new_session, handle)
            while True:
                try:
                    raw = await reader.readline()
                except (asyncio.LimitOverrunError, ValueError):
                    # an overlong line poisons the stream framing: report
                    # it and drop the connection (others are unaffected)
                    session.errors += 1
                    with _swallow_transport_errors():
                        writer.write((encode_error(
                            "line too long", session.lineno + 1) + "\n").encode())
                        await writer.drain()
                    break
                except (ConnectionResetError, BrokenPipeError, OSError):
                    break
                if not raw:
                    break
                handle.last_active = loop.time()
                records = await self.dispatcher.run_step(session.step(raw.decode("utf-8", "replace")))
                with _swallow_transport_errors():
                    for rec in records:
                        writer.write((rec + "\n").encode())
                    await writer.drain()
            # EOF / disconnect: close pending batches, flush the final
            # snapshot, answer with the same summary line `serve` prints
            await self.dispatcher.run_step(session.drain())
            summary = await self.dispatcher.call(self._finish_session, session)
            with _swallow_transport_errors():
                writer.write((summary + "\n").encode())
                await writer.drain()
        finally:
            self.sessions.pop(handle.name, None)
            with _swallow_transport_errors():
                writer.close()
                await writer.wait_closed()

    async def _gc(self) -> None:
        while True:
            await asyncio.sleep(max(self.cfg.idle_timeout_s / 4, 0.05))
            now = asyncio.get_running_loop().time()
            for handle in list(self.sessions.values()):
                if now - handle.last_active > self.cfg.idle_timeout_s:
                    # closing the transport EOFs the handler's readline;
                    # it drains + snapshots like any disconnect
                    self.stats["idle_closed"] += 1
                    handle.last_active = float("inf")  # close once
                    handle.writer.close()


class _swallow_transport_errors:
    """A peer that vanished mid-write must not take the handler down with
    a traceback — its session cleanup still runs."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, _tb):
        return exc_type is not None and issubclass(
            exc_type, (ConnectionResetError, BrokenPipeError, RuntimeError, OSError))
