"""Content-addressed persistent run store under ``experiments/runs_torch/``
(port of ``repro.uvm.api.store``; the record format and the keys are the
JAX package's, so either package reads the other's records, but the
default root is the port's own: a fine-tuned result differs across
frameworks, and a shared root would serve one framework's result to the
other).

Every executed cell/protocol result is published as one JSON file at
``<root>/<key[:2]>/<key>.json`` where ``key`` is the spec's content hash —
so a result is found by ANY process that builds an equal spec, and a spec
change (workload, policy, model config, schema …) can never alias a stale
result.  Records are self-describing::

    {"schema": 1, "kind": "CellSpec", "key": "…", "spec": {...}, "result": {...}}

Writes are atomic (tmp + ``os.replace``) and failures are soft: an
unwritable checkout just runs without the memo, a torn/corrupt file reads
as a miss.  ``REPRO_RUN_STORE=0`` disables the store entirely.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

from repro_torch.uvm.api.specs import SCHEMA

DEFAULT_ROOT = Path("experiments") / "runs_torch"


class RunStore:
    def __init__(self, root: str | Path = DEFAULT_ROOT, *, enabled: bool | None = None):
        self.root = Path(root)
        if enabled is None:
            enabled = os.environ.get("REPRO_RUN_STORE", "1") != "0"
        self.enabled = enabled
        self.hits = 0
        self.misses = 0
        self.writes = 0

    def path(self, key: str) -> Path:
        return self.root / key[:2] / f"{key}.json"

    def get(self, spec) -> dict | None:
        """The stored result payload for ``spec``, or None."""
        if not self.enabled:
            return None
        p = self.path(spec.key)
        try:
            rec = json.loads(p.read_text())
            if not isinstance(rec, dict) or rec.get("schema") != SCHEMA or rec.get("key") != spec.key:
                raise ValueError("stale, torn, or mismatched record")
            result = rec["result"]
        except (OSError, ValueError, KeyError):
            self.misses += 1
            return None
        self.hits += 1
        return result

    def put(self, spec, result: dict) -> Path | None:
        """Atomically publish ``result`` for ``spec``; returns the path
        (None when disabled or the directory is unwritable)."""
        if not self.enabled:
            return None
        p = self.path(spec.key)
        rec = {
            "schema": SCHEMA,
            "kind": type(spec).__name__,
            "key": spec.key,
            "spec": spec.to_dict(),
            "result": result,
        }
        try:
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_suffix(f".tmp.{os.getpid()}")
            tmp.write_text(json.dumps(rec, sort_keys=True) + "\n")
            os.replace(tmp, p)
        except OSError:
            return None  # read-only checkouts still work, just without the memo
        self.writes += 1
        return p

    def records(self):
        """Iterate every (key, record) in the store (for `cli report`)."""
        if not self.root.exists():
            return
        for p in sorted(self.root.glob("*/*.json")):
            try:
                rec = json.loads(p.read_text())
            except (OSError, ValueError):
                continue
            if isinstance(rec, dict) and rec.get("schema") == SCHEMA:
                yield rec.get("key", p.stem), rec

    def __repr__(self) -> str:
        return f"RunStore({self.root}, hits={self.hits}, misses={self.misses}, writes={self.writes})"
