"""Versioned, content-hashed snapshots of streaming-manager state (port of
``repro.uvm.manager.snapshot``, with the same on-disk layout).

A long-lived ``cli serve`` (or KV-offload) process carries state that is
expensive to lose: the per-pattern model params fine-tuned online, the
grown delta vocabulary, the frequency table, the classifier's DFA memory,
the fault clock.  :class:`SnapshotStore` persists the host-side state dict
:meth:`OversubscriptionManager.state` / :meth:`TenantMux.state` produce,
with a tmp-then-rename crash-safety idiom:

* everything for one step lands in ``snap_<step>.tmp/`` first and the
  directory is RENAMED to its final name only after all writes complete —
  a reader never observes a partial snapshot, a killed writer leaves only
  a ``.tmp`` turd that :meth:`clean_tmp` sweeps;
* the pickled payload is content-hashed (sha256, recorded in
  ``manifest.json``) and the digest is verified on :meth:`restore`, so a
  truncated or corrupted blob fails loudly instead of restoring garbage;
* ``keep`` bounds disk: older snapshots are garbage-collected after each
  successful save.

The payload itself is an opaque pickle — the manager owns its schema and
stamps it with :data:`STATE_VERSION` (validated by ``restore()`` on the
manager side) plus a config signature so a snapshot never restores into a
differently-shaped manager.
"""
from __future__ import annotations

import hashlib
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import torch

#: schema version of the manager/mux state dicts (bump on layout change)
STATE_VERSION = 1

#: on-disk snapshot container format (manifest layout)
SNAPSHOT_FORMAT = 1

_MANIFEST = "manifest.json"
_PAYLOAD = "state.pkl"


def tree_to_host(tree):
    """Deep-copy a tree of tensors (a params dict, an ``OptState`` of them,
    lists and tuples) to host numpy.  A pickled CUDA tensor loads only on a
    host with a card, so a snapshot holds no tensor at all; copying at save
    time also decouples it from later in-place updates."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_to_host(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return np.array(tree)


def tree_to_device(tree, device):
    """The inverse of :func:`tree_to_host`: every numpy array (or tensor) of
    the tree as a tensor on ``device`` (dicts, lists, tuples and named
    tuples keep their shape; anything else passes as it is)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.tensor(np.array(tree), device=device)
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_to_device(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


class SnapshotStore:
    """Atomic, hashed, GC'd snapshots under one directory.

    Layout per step (tmp-then-rename)::

        <dir>/snap_000000042.tmp/     # staging (invisible to readers)
            state.pkl                 # pickled payload
            manifest.json             # {"format", "step", "sha256", "bytes", "extra"}
        <dir>/snap_000000042/         # atomic rename AFTER all writes land
    """

    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state: dict, extra: dict | None = None) -> Path:
        """Persist one snapshot; returns the final directory."""
        blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        final = self.dir / f"snap_{step:09d}"
        tmp = self.dir / f"snap_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        (tmp / _PAYLOAD).write_bytes(blob)
        manifest = {
            "format": SNAPSHOT_FORMAT,
            "step": int(step),
            "sha256": hashlib.sha256(blob).hexdigest(),
            "bytes": len(blob),
            "extra": extra or {},
        }
        (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1, sort_keys=True))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self.dir / f"snap_{s:09d}", ignore_errors=True)

    def clean_tmp(self) -> list[Path]:
        """Sweep staging turds a killed writer left behind."""
        dead = sorted(self.dir.glob("snap_*.tmp"))
        for d in dead:
            shutil.rmtree(d, ignore_errors=True)
        return dead

    # -- read ----------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for d in self.dir.glob("snap_*"):
            if d.suffix == ".tmp" or not d.is_dir():
                continue
            try:
                out.append(int(d.name.split("_", 1)[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> tuple[int, dict, dict]:
        """Load one snapshot (the latest by default), verifying the content
        hash; returns ``(step, state, extra)``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no snapshots under {self.dir}")
        d = self.dir / f"snap_{step:09d}"
        manifest = json.loads((d / _MANIFEST).read_text())
        if manifest.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(
                f"snapshot format {manifest.get('format')!r} != supported {SNAPSHOT_FORMAT}"
            )
        blob = (d / _PAYLOAD).read_bytes()
        digest = hashlib.sha256(blob).hexdigest()
        if digest != manifest["sha256"]:
            raise ValueError(
                f"snapshot {d.name} failed content-hash verification "
                f"(manifest {manifest['sha256'][:12]}…, payload {digest[:12]}…)"
            )
        return step, pickle.loads(blob), manifest.get("extra", {})
