"""The serve JSONL wire codec (port of ``repro.uvm.server.protocol``): one
schema, every surface.

``cli serve`` speaks the ``cli export`` /
:func:`repro_torch.uvm.trace.to_fault_log` fault-log line schema::

    {"pages": [0, 1, 2, ...], "pc": [...], "tb": [...], "kernel": [...]}
    {"pages": [...], "tenant": "job-a"}
    {"feedback": {"was_evicted": [false, ...], "fault_count": 128}, "tenant": "job-a"}
    {"hello": {"session": "job-a"}}

plus the ``hello`` record of the reference's async server: a client's
optional FIRST line naming its session.  Malformed lines never produce a
traceback — they decode to a :class:`ProtocolError` whose message ships
back as a structured ``{"error": ..., "line": N}`` record.

The records are the JAX package's byte for byte: the field order is the
wire contract, and ``accuracy`` reaches ``json.dumps`` as a Python
``float`` (a numpy ``float32`` would print other digits).
"""
from __future__ import annotations

import json
import re

import numpy as np

_SESSION_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


class ProtocolError(ValueError):
    """A malformed JSONL line — reported as a structured error line, never
    a traceback (a long-lived sidecar must survive garbage input)."""


def decode_line(line: str, default_tenant: str):
    """Validate one JSONL line into ``(kind, (tenant, tagged), payload)``
    where kind is ``'observe'``, ``'feedback'`` or ``'hello'``.  Raises
    :class:`ProtocolError` with a one-line reason on anything malformed."""
    try:
        rec = json.loads(line)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"bad json: {e.msg}") from None
    if not isinstance(rec, dict):
        raise ProtocolError(f"line must be a JSON object, got {type(rec).__name__}")
    if "hello" in rec:
        if "pages" in rec or "feedback" in rec:
            raise ProtocolError("'hello' line must not carry 'pages' or 'feedback'")
        hello = rec["hello"]
        if not isinstance(hello, dict):
            raise ProtocolError("'hello' must be a JSON object")
        name = hello.get("session")
        if name is not None and (not isinstance(name, str) or not _SESSION_NAME_RE.match(name)):
            raise ProtocolError("'session' must match [A-Za-z0-9._-]{1,64}")
        return "hello", (None, False), {"session": name}
    tenant = rec.get("tenant", None)
    if tenant is not None and not isinstance(tenant, (str, int)):
        raise ProtocolError(f"'tenant' must be a string or int, got {type(tenant).__name__}")
    tagged = tenant is not None
    tenant = default_tenant if tenant is None else tenant
    if ("pages" in rec) == ("feedback" in rec):
        raise ProtocolError("line needs exactly one of 'pages' or 'feedback'")
    if "feedback" in rec:
        fb = rec["feedback"] or {}
        if not isinstance(fb, dict):
            raise ProtocolError("'feedback' must be a JSON object")
        we = fb.get("was_evicted")
        if we is not None and (not isinstance(we, list) or any(not isinstance(x, bool) for x in we)):
            raise ProtocolError("'was_evicted' must be a list of booleans")
        fc = fb.get("fault_count")
        if fc is not None and (isinstance(fc, bool) or not isinstance(fc, int) or fc < 0):
            raise ProtocolError("'fault_count' must be a non-negative integer")
        return "feedback", (tenant, tagged), {"was_evicted": we, "fault_count": fc}
    pages = rec["pages"]
    if not isinstance(pages, list) or any(isinstance(p, bool) or not isinstance(p, int) or p < 0 for p in pages):
        raise ProtocolError("'pages' must be a list of non-negative integers")
    sides = {}
    for ch in ("pc", "tb", "kernel"):
        v = rec.get(ch)
        if v is not None and (not isinstance(v, list) or len(v) != len(pages)
                              or any(isinstance(x, bool) or not isinstance(x, int) for x in v)):
            raise ProtocolError(f"'{ch}' must be a list of ints aligned with 'pages'")
        sides[ch] = v
    return "observe", (tenant, tagged), {"pages": np.asarray(pages, np.int64), **sides}


def encode_record(batch: int, actions, *, tenant=None, budget=None) -> str:
    """One JSON action line for an observed batch.  Field order is part of
    the wire contract — the kill/resume checks compare tails byte for
    byte.  ``budget``
    (the tenant's current QoS block budget) appears only on budgeted
    streams — legacy streams stay byte-identical."""
    rec = {
        "batch": batch,
        "pattern": actions.pattern,
        "n_samples": actions.n_samples,
        "accuracy": actions.accuracy,
        "warm": actions.warm,
        "health": actions.health,
        "fallback": actions.fallback,
        "prefetch_blocks": np.asarray(actions.prefetch_blocks).tolist(),
        "pre_evict_blocks": np.asarray(actions.pre_evict_blocks).tolist(),
    }
    if tenant is not None:
        rec["tenant"] = tenant
    if budget is not None:
        rec["budget"] = int(budget)
    return json.dumps(rec)


def encode_error(message: str, lineno: int) -> str:
    """The structured error record a malformed line earns."""
    return json.dumps({"error": message, "line": lineno})
