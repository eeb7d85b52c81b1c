"""Sans-io per-connection serving state machine (port of
``repro.uvm.server.session``).

:class:`StreamSession` is ``cli serve``'s line loop factored out of the
CLI: one instance owns one client's :class:`~repro_torch.uvm.manager.TenantMux`
plus the stream bookkeeping (pending batches, fault clock, line counter,
round-boundary checkpoints).  It is transport- and scheduler-agnostic:
``step(line)`` is a *generator* that yields :class:`EvalTick` /
:class:`TrainTick` dispatch requests and receives their results (or the
exception the dispatch raised) via ``send``, finally returning the list
of encoded output records.  ``cli serve`` drives each step to completion
inline with :func:`drive` + :class:`SyncDispatch`; the reference's async
server suspends every session at its tick and batches the staged requests
of all sessions into one trainer call, which is why the state machine is a
generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.uvm.manager import FaultBatch, Outcomes
from repro_torch.uvm.server.protocol import ProtocolError, decode_line, encode_error, encode_record


@dataclasses.dataclass
class EvalTick:
    """Staged ``evaluate_many`` half: dispatch ``reqs`` and send back the
    aligned result list (or the raised exception)."""

    reqs: list


@dataclasses.dataclass
class TrainTick:
    """Staged ``train_group_many`` half: dispatch ``reqs`` and send back
    ``None`` (entries update in place) or the raised exception.  Dispatch
    happens even with zero requests — a chaos-wrapped trainer draws its
    RNG per call, so an elided empty call would shift every later
    injection site of a seeded schedule."""

    reqs: list
    use_lucir: bool = False


class SyncDispatch:
    """Inline tick dispatcher: the single-connection (``cli serve``) and
    shutdown-drain path.  Mirrors ``TenantMux.observe``/``feedback``'s
    trainer calls exactly, returning exceptions as values."""

    def __init__(self, trainer, use_lucir: bool = False):
        self.trainer = trainer
        self.use_lucir = use_lucir

    def __call__(self, tick):
        if isinstance(tick, EvalTick):
            if not tick.reqs:
                return []
            try:
                return self.trainer.evaluate_many(
                    [r.params for r in tick.reqs], [r.fs for r in tick.reqs],
                    [r.n_active for r in tick.reqs],
                )
            except Exception as exc:  # noqa: BLE001 — the session decides
                return exc
        try:
            self.trainer.train_group_many(
                [r.entry for r in tick.reqs], [r.fs for r in tick.reqs],
                [r.n_active for r in tick.reqs],
                in_et_list=[r.in_et for r in tick.reqs], use_lucir=tick.use_lucir,
            )
            return None
        except Exception as exc:  # noqa: BLE001
            return exc


def drive(gen, dispatch):
    """Run one session generator to completion against an inline
    dispatcher; returns the session's encoded output records."""
    try:
        tick = next(gen)
        while True:
            tick = gen.send(dispatch(tick))
    except StopIteration as stop:
        return stop.value or []


class StreamSession:
    """One client's serving state: mux + stream bookkeeping + checkpoints.

    ``store``/``checkpoint_every`` reproduce ``cli serve``'s round-boundary
    snapshot cadence; :meth:`resume_latest` restores the newest snapshot
    and arms the consumed-line skip so a replayed stream's action tail is
    bit-identical to an uninterrupted run.  ``on_hello`` (server-side) is
    called with ``(session, name)`` when the client's ``hello`` line
    arrives — it may bind a checkpoint store, trigger a resume, or raise
    :class:`ProtocolError` (e.g. a session name already in use), which
    surfaces as a structured error record like any malformed line.
    """

    def __init__(self, mux, *, default_tenant: str = "default", store=None,
                 checkpoint_every: int = 0, on_hello=None):
        self.mux = mux
        self.default_tenant = default_tenant
        self.store = store
        self.checkpoint_every = checkpoint_every
        self.on_hello = on_hello
        self.name: str | None = None
        self.pending: dict = {}  # tenant -> pending batch length (None: closed)
        self.last_fault = 0
        self.last_tenant = default_tenant
        self.batches = 0
        self.errors = 0
        self.lineno = 0
        self.resume_lineno = 0
        self.checkpoint_due = False
        self._saw_traffic = False

    # -- checkpointing -------------------------------------------------------

    def extra_record(self) -> dict:
        return {"lineno": self.lineno, "batches": self.batches, "errors": self.errors,
                "last_fault": self.last_fault, "last_tenant": self.last_tenant}

    def save_snapshot(self) -> None:
        self.store.save(self.batches, self.mux.state(), extra=self.extra_record())

    def resume_latest(self):
        """Restore the newest snapshot in ``store``; returns
        ``(batches, resume_lineno)`` (the caller announces them)."""
        step, state, extra = self.store.restore()
        self.mux.restore(state)
        self.pending = {k: None for k in self.mux.managers}
        self.batches = extra.get("batches", step)
        self.errors = extra.get("errors", 0)
        self.last_fault = extra.get("last_fault", 0)
        self.last_tenant = extra.get("last_tenant", self.default_tenant)
        self.resume_lineno = extra.get("lineno", 0)
        return self.batches, self.resume_lineno

    def summary_line(self) -> str:
        mux = self.mux
        return (f"# serve batches={self.batches} predictions={mux.n_predictions} "
                f"patterns={mux.n_models} classes={mux.n_classes} top1={mux.top1:.3f} "
                f"tenants={len(mux.managers)} errors={self.errors} "
                f"health_faults={mux.n_health_faults} fallbacks={mux.n_fallbacks} "
                f"recoveries={mux.n_recoveries}")

    # -- the line loop (one generator per input line) ------------------------

    def _close(self, tenant, outcomes):
        pairs, treqs = self.mux.feedback_requests(outcomes, tenant=tenant)
        exc = yield TrainTick([r for _, r in treqs], self.mux.cfg.use_lucir)
        self.mux.feedback_apply(pairs, treqs, exc)
        self.pending[tenant] = None

    def step(self, line: str):
        """Process one raw input line.  Yields dispatch ticks, receives
        their results, and returns (``StopIteration.value``) the encoded
        records this line produced."""
        out: list[str] = []
        # snapshots happen only at fully-closed round boundaries (every
        # tenant's pending batch fed back); a due checkpoint waits here
        # until the boundary comes around
        if self.checkpoint_due and all(v is None for v in self.pending.values()):
            self.save_snapshot()
            self.checkpoint_due = False
        self.lineno += 1
        if self.lineno <= self.resume_lineno:
            return out  # consumed before the snapshot we restored from
        line = line.strip()
        if not line or line.startswith("#"):
            return out
        try:
            kind, (tenant, tagged), payload = decode_line(line, self.default_tenant)
            if kind == "hello":
                if self._saw_traffic:
                    raise ProtocolError("'hello' must precede any observe/feedback traffic")
                if self.on_hello is not None:
                    comment = self.on_hello(self, payload["session"])
                    if comment:
                        out.append(comment)
                return out
            self._saw_traffic = True
            if kind == "feedback":
                if not tagged:
                    tenant = self.last_tenant  # untagged: closes the previous batch
                we = payload["was_evicted"]
                if self.pending.get(tenant) is None and we is not None:
                    # an outcome report with nothing to apply it to is
                    # lost data -> error; a bare fault_count line merely
                    # seeds the clock (legacy input, accepted silently)
                    raise ProtocolError(f"feedback for tenant {tenant!r} without a pending batch")
                if we is not None and len(we) != self.pending[tenant]:
                    raise ProtocolError(
                        f"'was_evicted' must have one entry per access of tenant "
                        f"{tenant!r}'s pending batch (expected {self.pending[tenant]}, got {len(we)})"
                    )
                if payload["fault_count"] is not None:
                    self.last_fault = payload["fault_count"]
                if self.pending.get(tenant) is not None:
                    yield from self._close(tenant, Outcomes(
                        was_evicted=np.asarray(we, bool) if we is not None else None,
                        fault_count=self.last_fault,
                    ))
                return out
            if self.pending.get(tenant) is not None:  # auto-close (no outcome report)
                yield from self._close(tenant, Outcomes(fault_count=self.last_fault))
            pairs, evals = self.mux.observe_requests(FaultBatch(
                payload["pages"], payload["pc"], payload["tb"], payload["kernel"],
                tenant=tenant,
            ))
            result = []
            if evals:
                result = yield EvalTick([r for _, r in evals])
            macts = self.mux.observe_apply(pairs, evals, result)
            actions = macts.per_tenant[tenant]
            self.pending[tenant] = len(payload["pages"])
            self.last_tenant = tenant
            self.batches += 1
            out.append(encode_record(
                self.batches, actions, tenant=tenant if tagged else None,
                budget=None if macts.budgets is None else macts.budgets.get(tenant),
            ))
            if self.store is not None and self.checkpoint_every and self.batches % self.checkpoint_every == 0:
                self.checkpoint_due = True
        except ProtocolError as e:
            self.errors += 1
            out.append(encode_error(str(e), self.lineno))
        return out

    def drain(self):
        """Close every pending batch (stream end / graceful shutdown);
        same generator protocol as :meth:`step`."""
        for tenant, p in list(self.pending.items()):
            if p is not None:
                yield from self._close(tenant, Outcomes(fault_count=self.last_fault))
        return []
