"""Deterministic multi-client load generator for the fault-stream server
(port of ``repro.uvm.server.loadgen``: pure asyncio and numpy, no torch
and no device — it is a client).

Replays an exported JSONL fault log (``cli export`` /
:func:`repro_torch.uvm.trace.to_fault_log`) over N concurrent connections at a
target per-client rate, measuring closed-loop action latency (an observe
line's send → its action record's arrival) and sustained faults/sec.
Content is fully deterministic — seeded logs, seeded chaos — so the
per-client action streams it collects feed the bit-identity gates;
only the timing (and therefore the server's tick composition) varies,
which microbatching is designed to make invisible.

Two designated misbehaving clients exercise the isolation story:

* ``malformed_client`` injects a non-JSON line every ``malformed_every``
  data lines (each earns a structured error record, nothing else);
* ``chaos_client`` runs its outgoing lines through a seeded
  :meth:`~repro_torch.uvm.manager.chaos.FaultInjector.transform_lines`
  schedule (drops/dups/reorders/losses — transport chaos, client-side).

Latency is only sampled on clean clients (a transformed stream's
send→action pairing is ill-defined).
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
from collections import deque

import numpy as np


@dataclasses.dataclass
class ClientResult:
    idx: int
    name: str | None
    lines_sent: int
    malformed_sent: int
    faults_sent: int  # pages across the observe lines actually delivered
    actions: list  # encoded action records, arrival order
    errors: int
    comments: list  # "# ..." lines (resume notices, the final summary)
    latencies_ms: list


@dataclasses.dataclass
class LoadStats:
    clients: int
    lines_sent: int
    actions: int
    errors: int
    faults: int  # total pages across every delivered observe line
    wall_s: float
    faults_per_s: float
    p50_ms: float
    p99_ms: float
    per_client: list  # ClientResult, client order


def _is_observe(line: str) -> bool:
    s = line.strip()
    return bool(s) and not s.startswith("#") and '"pages"' in s and '"feedback"' not in s


def _count_faults(line: str) -> int:
    try:
        rec = json.loads(line)
        return len(rec.get("pages", ())) if isinstance(rec, dict) else 0
    except json.JSONDecodeError:
        return 0


async def _run_client(idx: int, connect, lines: list, *, rate: float, hello: str | None,
                      chaos=None, malformed_every: int = 0,
                      line_limit: int = 1 << 20) -> ClientResult:
    loop = asyncio.get_running_loop()
    reader, writer = await connect(line_limit)
    clean = chaos is None and not malformed_every
    pending: deque = deque()  # send-times of in-flight observe lines
    res = ClientResult(idx, hello, 0, 0, 0, [], 0, [], [])

    async def read_loop():
        while True:
            raw = await reader.readline()
            if not raw:
                return
            s = raw.decode("utf-8", "replace").strip()
            if not s:
                continue
            if s.startswith("#"):
                res.comments.append(s)
                continue
            rec = json.loads(s)
            if "batch" in rec:
                if clean and pending:
                    res.latencies_ms.append((loop.time() - pending.popleft()) * 1e3)
                res.actions.append(s)
            elif "error" in rec:
                res.errors += 1

    reader_task = asyncio.ensure_future(read_loop())
    try:
        if hello is not None:
            writer.write((json.dumps({"hello": {"session": hello}}) + "\n").encode())
        out_lines = chaos.transform_lines(lines) if chaos is not None else lines
        start = loop.time()
        for line in out_lines:
            if rate > 0:  # steady per-client pacing
                target = start + res.lines_sent / rate
                delay = target - loop.time()
                if delay > 0:
                    await asyncio.sleep(delay)
            if malformed_every and res.lines_sent and res.lines_sent % malformed_every == 0:
                writer.write(b"malformed line from client\n")
                res.malformed_sent += 1
            if _is_observe(line):
                res.faults_sent += _count_faults(line)
                if clean:
                    pending.append(loop.time())
            writer.write((line.rstrip("\n") + "\n").encode())
            res.lines_sent += 1
            await writer.drain()
        writer.write_eof()  # half-close: the server drains + answers the summary
        await reader_task
    finally:
        reader_task.cancel()
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
    return res


def make_connector(target: str):
    """``unix:/path`` or ``host:port`` -> an async ``connect(limit)``."""
    if target.startswith("unix:"):
        path = target[len("unix:"):]

        async def connect(limit):
            return await asyncio.open_unix_connection(path, limit=limit)
    else:
        host, _, port = target.rpartition(":")

        async def connect(limit):
            return await asyncio.open_connection(host or "127.0.0.1", int(port), limit=limit)
    return connect


async def run_loadgen(connect, lines: list, n_clients: int, *, rate: float = 0.0,
                      repeat: int = 1, hello_prefix: str | None = None,
                      chaos_schedules: dict | None = None, malformed_every: int = 0,
                      malformed_client: int | None = None,
                      line_limit: int = 1 << 20) -> LoadStats:
    """Drive ``n_clients`` concurrent replays of ``lines`` (``repeat``
    passes each) and aggregate the stats.  ``chaos_schedules`` maps client
    index -> a :class:`~repro_torch.uvm.manager.chaos.FaultInjector`."""
    stream = list(lines) * repeat
    chaos_schedules = chaos_schedules or {}
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    results = await asyncio.gather(*(
        _run_client(
            i, connect, stream, rate=rate,
            hello=f"{hello_prefix}{i}" if hello_prefix else None,
            chaos=chaos_schedules.get(i),
            malformed_every=malformed_every if i == malformed_client else 0,
            line_limit=line_limit,
        )
        for i in range(n_clients)
    ))
    wall = loop.time() - t0
    lat = np.asarray(sorted(x for r in results for x in r.latencies_ms), float)
    served_faults = sum(r.faults_sent for r in results)
    return LoadStats(
        clients=n_clients,
        lines_sent=sum(r.lines_sent for r in results),
        actions=sum(len(r.actions) for r in results),
        errors=sum(r.errors for r in results),
        faults=served_faults,
        wall_s=wall,
        faults_per_s=served_faults / wall if wall > 0 else 0.0,
        p50_ms=float(np.percentile(lat, 50)) if len(lat) else 0.0,
        p99_ms=float(np.percentile(lat, 99)) if len(lat) else 0.0,
        per_client=list(results),
    )
