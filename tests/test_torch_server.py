"""The port's async fault-stream server (``repro_torch.uvm.server``) against
the JAX package's (``repro.uvm.server``), on the CPU.

What is held, and how:

* **the reference's streams, byte for byte** — six concurrent clients, in
  every dispatch mode (``serial``, ``fused``, ``vmap``): each client's full
  output (records, error lines and the summary) equals the JAX package's
  ``FaultStreamServer`` output for the same lines and both packages'
  inline ``StreamSession`` + ``SyncDispatch`` (what ``cli serve`` prints),
  with the pure-numpy stub trainer on both sides and with the real
  ``SMOKE`` trainer (the port's initial weights are the JAX package's,
  through ``repro_torch.random``), whose ``vmap`` ticks stack their lanes;
* the seeded random line soups and the hypothesis property (where
  ``hypothesis`` is installed) of the reference's tests;
* admission cap, idle GC, an overlong line, duplicate ``hello`` names;
* isolation: loadgen with a malformed and a chaos client, and server-side
  chaos on the shared trainer degrading softly;
* kill -9 and ``--resume`` through ``python -m repro_torch.uvm.cli server
  --device cpu``;
* the port's own rule: only the dispatcher's worker thread runs session
  and trainer code; the event loop thread only moves bytes;
* the engine policy without an environment knob, and ``enable_aot``
  refusing a CPU trainer.
"""
from __future__ import annotations

import asyncio
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.uvm import manager as JM
from repro.uvm import server as JS
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.uvm import manager as PM
from repro_torch.uvm import server as PS
from repro_torch.uvm.server.core import _resolve_engine

ROOT = Path(__file__).resolve().parent.parent
# side -> (manager package, server package, predictor configs, incremental, device keywords)
SIDES = {"j": (JM, JS, JC, JI, {}), "p": (PM, PS, PC, PI, {"device": "cpu"})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StubTrainer:
    """Deterministic pure-numpy stand-in for ``Trainer`` (the reference's
    test's): predicts the window's last delta class, counts updates, and
    notes the threads it runs on."""

    def __init__(self):
        self.threads = set()

    def new_params(self, seed: int = 0):
        return np.zeros(1)

    def evaluate(self, params, fs, n_active: int):
        self.threads.add(threading.get_ident())
        pred = fs.delta[:, -1] % max(n_active, 1)
        return pred == fs.label, pred

    def evaluate_many(self, params_list, fs_list, n_active_list):
        return [self.evaluate(p, f, n) for p, f, n in zip(params_list, fs_list, n_active_list)]

    def train_group(self, entry, fs, n_active, *, in_et=None, use_lucir=False, rng=None):
        self.threads.add(threading.get_ident())
        entry.n_updates += 1
        return entry

    def train_group_many(self, entries, fs_list, n_active_list, *, in_et_list=None, use_lucir=False):
        self.threads.add(threading.get_ident())
        for e in entries:
            e.n_updates += 1
        return entries


def _stub_cfg(side: str, **kw):
    M, _, C, I, _ = SIDES[side]
    kw.setdefault("predictor", C.SMOKE)
    kw.setdefault("train", I.TrainConfig(group_size=64, epochs=1, batch_size=32))
    kw.setdefault("n_pages", 1024)
    kw.setdefault("n_blocks", 64)
    kw.setdefault("capacity", 16)
    kw.setdefault("use_lucir", False)
    kw.setdefault("use_thrash_term", False)
    if isinstance(kw.get("health"), dict):
        kw["health"] = M.HealthConfig(**kw["health"])
    return M.ManagerConfig(**kw)


def _lines(n_batches=8, pages_per=24, seed=0, tenants=("A", "B")):
    """A deterministic observe/feedback JSONL stream (tenant-tagged when
    ``tenants`` is non-empty)."""
    rng = np.random.default_rng(seed)
    out, clock = [], 0
    for b in range(n_batches):
        rec = {"pages": rng.integers(0, 1024, pages_per).tolist()}
        fb = {"feedback": {"was_evicted": [False] * pages_per, "fault_count": clock + 64}}
        clock += 64
        if tenants:
            rec["tenant"] = fb["tenant"] = tenants[b % len(tenants)]
        out.append(json.dumps(rec))
        out.append(json.dumps(fb))
    return out


def _inline_reference(side, lines, cfg, trainer):
    """What ``cli serve`` prints for this stream."""
    M, S, _, _, dev = SIDES[side]
    session = S.StreamSession(M.TenantMux(cfg, trainer=trainer, **dev), default_tenant="default")
    dispatch = S.SyncDispatch(trainer, cfg.use_lucir)
    recs = [r for ln in lines for r in S.drive(session.step(ln), dispatch)]
    recs += S.drive(session.drain(), dispatch)
    return recs + [session.summary_line()]


async def _raw_client(path, lines, *, hello=None):
    """Send ``lines``, half-close, and return every output line."""
    reader, writer = await asyncio.open_unix_connection(path)
    try:
        if hello is not None:
            writer.write((json.dumps({"hello": {"session": hello}}) + "\n").encode())
        for ln in lines:
            writer.write((ln.rstrip("\n") + "\n").encode())
        await writer.drain()
        writer.write_eof()
        out = []
        while True:
            raw = await reader.readline()
            if not raw:
                return out
            out.append(raw.decode().rstrip("\n"))
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass


def _server_cfg(side, mode, mcfg, **kw):
    return SIDES[side][1].ServerConfig(manager=mcfg, microbatch=(mode != "serial"),
                                       exec_mode=mode if mode != "serial" else "auto", **kw)


def _serve(side, scfg, trainer, fn, tmp_path, *, tcp=False):
    """Start ``side``'s server on a unix socket (and TCP), run ``fn(server,
    path)`` as a client, shut down."""
    _, S, _, _, dev = SIDES[side]

    async def main():
        server = S.FaultStreamServer(scfg, trainer=trainer, **dev)
        path = str(tmp_path / f"{side}.sock")
        await server.start(path=path, host="127.0.0.1" if tcp else None, port=0)
        try:
            return await fn(server, path)
        finally:
            await server.shutdown()

    return asyncio.run(main())


def _clients(lines, n):
    async def run(server, path):
        outs = await asyncio.gather(*(_raw_client(path, lines) for _ in range(n)))
        return outs, server.dispatcher.n_ticks, server.dispatcher.max_eval_lanes, server.summary_line()
    return run


# --- engine policy -----------------------------------------------------------


def test_resolve_engine_policy(monkeypatch):
    assert _resolve_engine("vmap") == "vmap"
    assert _resolve_engine("fused") == "fused"
    with pytest.raises(ValueError, match="exec_mode"):
        _resolve_engine("turbo")
    expected = "vmap" if torch.cuda.device_count() > 1 else "fused"
    for knob in ("1", "0", None):  # the reference's environment override is not read
        if knob is None:
            monkeypatch.delenv("REPRO_OURS_BATCHED", raising=False)
        else:
            monkeypatch.setenv("REPRO_OURS_BATCHED", knob)
        assert _resolve_engine("auto") == expected


# --- the reference's streams across dispatch modes ------------------------------


@pytest.mark.parametrize("mode", ["serial", "fused", "vmap"])
def test_server_streams_are_the_reference_s(tmp_path, mode, monkeypatch):
    """Six concurrent clients replaying one stream: every connection's full
    output is the JAX package's server's and both packages' inline serve
    state machine's, in every dispatch mode; one thread, not the event
    loop's, ran the trainer and the muxes."""
    mux_threads = set()
    for name in ("__init__", "observe_apply", "feedback_apply", "state"):
        inner = getattr(PM.TenantMux, name)

        def spy(self, *a, _inner=inner, **kw):
            mux_threads.add(threading.get_ident())
            return _inner(self, *a, **kw)

        monkeypatch.setattr(PM.TenantMux, name, spy)
    lines = _lines(8)
    expected = _inline_reference("j", lines, _stub_cfg("j"), _StubTrainer())
    assert _inline_reference("p", lines, _stub_cfg("p"), _StubTrainer()) == expected
    jouts, *_ = _serve("j", _server_cfg("j", mode, _stub_cfg("j")), _StubTrainer(), _clients(lines, 6), tmp_path)
    trainer = _StubTrainer()
    outs, n_ticks, lanes, summary = _serve("p", _server_cfg("p", mode, _stub_cfg("p")), trainer,
                                           _clients(lines, 6), tmp_path)
    assert jouts == [expected] * 6
    assert outs == [expected] * 6
    assert summary.startswith("# server sessions=6 refused=0 idle_closed=0 resumed=0 ticks=")
    assert summary.endswith(f"mode={'serial' if mode == 'serial' else 'batched-' + mode}")
    assert threading.get_ident() not in trainer.threads and len(trainer.threads) == 1
    main = threading.get_ident()
    mux_threads.discard(main)  # the inline reference above ran on this thread
    assert mux_threads == trainer.threads
    if mode != "serial":
        # the dispatcher genuinely gathered across connections
        assert lanes > 1
        assert n_ticks < 6 * sum(1 for ln in lines if "pages" in ln)


_MALFORMED = ["not json {", "[1, 2]", '{"pages": ["x"]}',
              '{"pages": [1], "feedback": {}}', ""]


def _random_soup(rng, n_lines):
    """One client's arbitrary line soup: tagged/untagged observes, bare
    fault-clock feedbacks, and malformed junk."""
    out = []
    for _ in range(n_lines):
        roll = rng.integers(0, 4)
        if roll <= 1:
            rec = {"pages": rng.integers(0, 1024, rng.integers(1, 13)).tolist()}
            tenant = rng.choice(["A", "B", None])
            if tenant is not None:
                rec["tenant"] = str(tenant)
            out.append(json.dumps(rec))
        elif roll == 2:
            out.append(json.dumps({"feedback": {"fault_count": int(rng.integers(0, 4096))}}))
        else:
            out.append(_MALFORMED[rng.integers(0, len(_MALFORMED))])
    return out


def _assert_soup_equivalence(per_client_lines, tmp, *, jax_too=False):
    """Concurrent connections with arbitrary soups: each client's
    microbatched output is its own inline serve reference (and, with
    ``jax_too``, the JAX package's)."""
    expected = [_inline_reference("p", ls, _stub_cfg("p"), _StubTrainer()) for ls in per_client_lines]
    if jax_too:
        assert expected == [_inline_reference("j", ls, _stub_cfg("j"), _StubTrainer()) for ls in per_client_lines]

    async def run(server, path):
        return await asyncio.gather(*(_raw_client(path, ls) for ls in per_client_lines))

    assert _serve("p", _server_cfg("p", "fused", _stub_cfg("p")), _StubTrainer(), run, tmp) == expected


def test_microbatched_equiv_random_soups(tmp_path):
    """The reference's 12 seeded random multi-client line soups."""
    for seed in range(12):
        rng = np.random.default_rng(seed)
        soups = [_random_soup(rng, int(rng.integers(1, 11))) for _ in range(int(rng.integers(1, 5)))]
        _assert_soup_equivalence(soups, tmp_path, jax_too=True)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    _line_st = st.one_of(
        st.tuples(st.lists(st.integers(0, 1023), min_size=1, max_size=12),
                  st.sampled_from(["A", "B", None])).map(
            lambda t: json.dumps({"pages": t[0], **({"tenant": t[1]} if t[1] else {})})),
        st.integers(0, 4096).map(lambda fc: json.dumps({"feedback": {"fault_count": fc}})),
        st.sampled_from(_MALFORMED),
    )

    @settings(max_examples=15, deadline=None)
    @given(st.lists(st.lists(_line_st, min_size=1, max_size=10), min_size=1, max_size=4))
    def test_microbatched_equiv_property(tmp_path_factory, per_client_lines):
        _assert_soup_equivalence(per_client_lines, tmp_path_factory.mktemp("prop"))
except ImportError:  # pragma: no cover - the seeded net above still runs
    pass


def test_server_real_trainer_streams_are_the_reference_s(tmp_path, monkeypatch):
    """The real ``SMOKE`` trainer on both sides: six clients in each of
    the port's modes print the JAX package's server's streams (its
    ``fused`` mode) and both inline references; ``vmap`` stacks its
    ticks' lanes."""
    mk = lambda side: _stub_cfg(side, train=SIDES[side][3].TrainConfig(group_size=32, epochs=1, batch_size=16))
    lines = _lines(4, pages_per=32, tenants=())
    jtrainer = JI.Trainer(JC.SMOKE, mk("j").train)
    expected = _inline_reference("j", lines, mk("j"), jtrainer)
    jouts, *_ = _serve("j", _server_cfg("j", "fused", mk("j")), jtrainer, _clients(lines, 6), tmp_path)
    assert jouts == [expected] * 6
    ptrainer = PI.Trainer(PC.SMOKE, mk("p").train, device="cpu")
    assert _inline_reference("p", lines, mk("p"), ptrainer) == expected
    stacked = []
    inner = PI.Trainer._evaluate_bucket
    monkeypatch.setattr(PI.Trainer, "_evaluate_bucket",
                        lambda self, p, f, n: len(p) > 1 and stacked.append(len(p)) or inner(self, p, f, n))
    for mode in ("serial", "fused", "vmap"):
        stacked.clear()
        outs, *_ = _serve("p", _server_cfg("p", mode, mk("p")), ptrainer, _clients(lines, 6), tmp_path)
        assert outs == [expected] * 6, mode
        assert bool(stacked) == (mode == "vmap") and all(n >= PI.Trainer.MIN_VMAP_LANES for n in stacked), mode


# --- admission, idle GC, overlong lines, hello -------------------------------


def test_admission_cap_refuses_with_structured_error(tmp_path):
    async def run(server, path):
        campers = [await asyncio.open_unix_connection(path) for _ in range(2)]
        await asyncio.sleep(0.05)  # let both handlers register
        refused = await _raw_client(path, [])
        for r, w in campers:
            w.write_eof()
            while await r.readline():
                pass
            w.close()
        return refused, dict(server.stats)

    refused, stats = _serve("p", _server_cfg("p", "fused", _stub_cfg("p"), max_sessions=2), _StubTrainer(), run,
                            tmp_path)
    assert refused == [json.dumps({"error": "server full (2 sessions)", "line": 0})]
    assert stats["refused"] == 1 and stats["served"] == 2


def test_idle_gc_drains_and_closes(tmp_path):
    line = json.dumps({"pages": [1, 2, 3]})

    async def run(server, path):
        reader, writer = await asyncio.open_unix_connection(path)
        writer.write((line + "\n").encode())
        await writer.drain()
        out = []  # no write_eof: only the GC can end this connection
        while True:
            raw = await asyncio.wait_for(reader.readline(), timeout=5.0)
            if not raw:
                break
            out.append(raw.decode().rstrip("\n"))
        writer.close()
        return out, dict(server.stats)

    out, stats = _serve("p", _server_cfg("p", "fused", _stub_cfg("p"), idle_timeout_s=0.15), _StubTrainer(), run,
                        tmp_path)
    assert stats["idle_closed"] == 1
    assert json.loads(out[0])["batch"] == 1  # the work done before idling survives


def test_overlong_line_closes_only_its_connection(tmp_path):
    clean = _lines(2)
    expected = _inline_reference("p", clean, _stub_cfg("p"), _StubTrainer())

    async def run(server, path):
        long = await _raw_client(path, ["x" * 4096])
        good = await _raw_client(path, clean)
        return long, good

    long, good = _serve("p", _server_cfg("p", "fused", _stub_cfg("p"), line_limit=256), _StubTrainer(), run,
                        tmp_path)
    assert json.loads(long[0]) == {"error": "line too long", "line": 1}
    assert good == expected


def test_hello_names_and_duplicates(tmp_path):
    async def run(server, path):
        r1, w1 = await asyncio.open_unix_connection(path)
        w1.write((json.dumps({"hello": {"session": "dup"}}) + "\n").encode())
        await w1.drain()
        await asyncio.sleep(0.05)
        names = set(server.sessions)
        second = await _raw_client(path, [json.dumps({"pages": [1]})], hello="dup")
        w1.write_eof()
        while await r1.readline():
            pass
        w1.close()
        return names, second

    names, second = _serve("p", _server_cfg("p", "fused", _stub_cfg("p")), _StubTrainer(), run, tmp_path)
    assert "dup" in names
    assert "already in use" in json.loads(second[0])["error"]
    assert json.loads(second[1])["batch"] == 1  # the connection itself survives


# --- isolation under malformed + chaos clients (loadgen, over TCP) -----------


def test_loadgen_isolation_malformed_and_chaos(tmp_path):
    """Six loadgen clients over TCP, one malformed and one chaos-transformed:
    the clean clients' action streams are the reference's, errors land only
    on the malformed connection."""
    lines = _lines(6)
    expected = [r for r in _inline_reference("j", lines, _stub_cfg("j"), _StubTrainer())
                if r.startswith("{") and "batch" in r]

    async def run(server, _path):
        connect = PS.make_connector(f"127.0.0.1:{server.tcp_port}")
        stats = await PS.run_loadgen(
            connect, lines, 6, hello_prefix="lg-", malformed_every=2, malformed_client=4,
            chaos_schedules={5: PM.FaultInjector(PM.ChaosSchedule.parse(
                "drop_batch=0.4,dup_batch=0.3,lose_feedback=0.5,seed=11"))},
        )
        return stats, dict(server.stats)

    stats, sstats = _serve("p", _server_cfg("p", "fused", _stub_cfg("p")), _StubTrainer(), run, tmp_path, tcp=True)
    assert sstats["served"] == 6
    per = stats.per_client
    for r in per[:4]:  # clean clients: the reference's actions, no errors
        assert r.actions == expected and r.errors == 0
        assert r.comments and r.comments[-1].startswith("# serve batches=6")
    assert per[4].malformed_sent > 0 and per[4].errors == per[4].malformed_sent
    assert per[4].actions == expected  # its own stream is undisturbed
    assert per[5].actions and all("batch" in json.loads(a) for a in per[5].actions)
    assert stats.errors == per[4].errors
    assert stats.p50_ms >= 0.0 and stats.faults_per_s > 0


def test_server_side_chaos_degrades_softly(tmp_path):
    """A chaos schedule on the shared trainer: dispatch failures become
    degraded fallback records, never a traceback or a lost batch."""
    lines = _lines(10, tenants=())

    async def run(server, path):
        outs = await asyncio.gather(*(_raw_client(path, lines) for _ in range(3)))
        return outs, server.injector

    outs, injector = _serve("p", _server_cfg("p", "fused", _stub_cfg("p", health={}), inject="trainer_exc=0.5,seed=3"),
                            _StubTrainer(), run, tmp_path)
    assert sum(injector.counts.values()) > 0
    for out in outs:
        acts = [json.loads(r) for r in out if r.startswith("{")]
        assert all("error" not in a for a in acts)
        assert len(acts) == 10
        assert any(a["fallback"] for a in acts)
        assert any(a["health"] == "degraded" for a in acts)


# --- kill -9 / --resume (subprocess) ------------------------------------------


_STREAM_FLAGS = ["--n-pages", "300", "--pages-per-block", "4", "--capacity", "16", "--group-size", "32",
                 "--device", "cpu"]


def _spawn_server(sock, extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.uvm.cli", "server", "--socket", sock, *_STREAM_FLAGS, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"},
    )
    deadline = time.time() + 120
    banner = ""
    while time.time() < deadline:
        r, _, _ = select.select([proc.stdout], [], [], 1.0)
        if r:
            banner = proc.stdout.readline()
            break
        assert proc.poll() is None, "server died before listening"
    assert "# server listening" in banner and "mode=batched-fused" in banner, banner
    return proc


async def _drive_named(sock, lines, *, n_actions=None):
    reader, writer = await asyncio.open_unix_connection(sock)
    writer.write((json.dumps({"hello": {"session": "job"}}) + "\n").encode())
    for ln in lines:
        writer.write((ln + "\n").encode())
    await writer.drain()
    if n_actions is None:
        writer.write_eof()
    out, acts = [], 0
    try:
        while True:
            raw = await asyncio.wait_for(reader.readline(), timeout=120)
            if not raw:
                break
            s = raw.decode().rstrip("\n")
            out.append(s)
            acts += s.startswith("{") and "batch" in s
            if n_actions is not None and acts >= n_actions:
                break
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
    return out


def test_server_kill9_resume_bit_identical_tail(tmp_path, capsys):
    """SIGKILL the checkpointing ``cli server`` mid-stream; a ``--resume``
    server replaying the stream answers the uninterrupted ``cli serve``
    run's tail and summary, byte for byte."""
    from repro_torch.uvm import cli

    lines = _lines(10, pages_per=40, seed=42, tenants=())
    full = tmp_path / "full.jsonl"
    full.write_text("\n".join(lines) + "\n")
    assert cli.main(["serve", "--input", str(full), *_STREAM_FLAGS]) == 0
    ref = capsys.readouterr().out.strip().splitlines()
    ref_acts = [ln for ln in ref if ln.startswith("{")]
    ck = tmp_path / "ckpt"
    proc = _spawn_server(str(tmp_path / "a.sock"), ["--checkpoint-dir", str(ck), "--checkpoint-every", "2"])
    try:
        # 13 lines = 6 closed batches + batch 7's observe: stepping line 13
        # flushes the batch-6 snapshot before answering, so once action 7
        # arrives the snapshot is durable — then kill -9
        out = asyncio.run(_drive_named(str(tmp_path / "a.sock"), lines[:13], n_actions=7))
        assert len([ln for ln in out if ln.startswith("{")]) == 7
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        proc.stdout.close()
    assert PM.SnapshotStore(str(ck / "job")).latest_step() == 6
    proc = _spawn_server(str(tmp_path / "b.sock"), ["--checkpoint-dir", str(ck), "--resume"])
    try:
        res = asyncio.run(_drive_named(str(tmp_path / "b.sock"), lines))
    finally:
        proc.terminate()
        proc.wait()
        tail_out = proc.stdout.read()
        proc.stdout.close()
    assert any(ln.startswith("# resumed batch=6") for ln in res)
    assert [ln for ln in res if ln.startswith("{")] == ref_acts[6:]
    assert res[-1] == ref[-1]
    # the SIGTERM drain printed the server's summary line
    assert "# server sessions=1 refused=0 idle_closed=0 resumed=1 " in tail_out


def test_server_drains_a_sigterm_sent_as_soon_as_it_listens(tmp_path):
    """The signal handlers are in place before the banner: a SIGTERM sent
    the moment the banner is read drains the server, which prints its
    summary and exits 0 (before, the default action could kill it with no
    output)."""
    for i in range(3):
        proc = _spawn_server(str(tmp_path / f"t{i}.sock"), [])
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
        assert proc.returncode == 0 and out.splitlines()[-1].startswith("# server sessions=0 "), (proc.returncode, out)


def test_enable_aot_refuses_a_cpu_trainer(tmp_path):
    trainer = PI.Trainer(PC.SMOKE, PI.TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="launches no kernel"):
        PS.enable_aot(trainer, tmp_path / "aot")
    assert not hasattr(trainer, "aot_cache")
    assert PS.AotCache(tmp_path / "aot").stats() == {"hits": 0, "misses": 0, "fallbacks": 0}
