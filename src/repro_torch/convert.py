"""Carry the JAX package's weights into the port.

Parameters on both sides are flat dicts under the same key names
(``"reg/attn/wq"``, ``"embed/page"``, ...), so conversion is a copy per
array with no renaming.  A *blob* is the host-side model table the JAX
package memoises after pretraining (``repro.uvm.runtime._table_to_host``)::

    {"n_slots": int, "slots": {slot: {"params", "prev_params", "opt_state",
                                      "step", "n_updates", "last_acc"}}}

with numpy arrays for every tensor.  :func:`blob_from_npz` reads the same
structure from the ``.npz`` that ``scripts/export_torch_reference.py``
writes: params, the AdamW moments (``opt_state``) where a slot has them and
the LUCIR snapshot (``prev_params``) where it is set, so that a fine-tuned
run starts from the same optimizer state as the JAX package's table.

A table's fresh slots draw their weights from ``torch.Generator`` in the
port and from ``jax.random`` in the JAX package.  To start a run from the
JAX package's fresh weights, pass ``fresh``, a mapping slot -> params (see
:func:`fresh_slots`), to :func:`table_from_blob` or :func:`fresh_table`.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.predictor_paper import PredictorConfig
from repro_torch.core import predictor
from repro_torch.core.model_table import Entry, ModelTable
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptState


def params_from_jax(np_params: dict, device) -> dict[str, torch.Tensor]:
    """A flat dict of arrays (numpy, or anything ``np.asarray`` takes) as
    tensors on ``device``, key for key."""
    return {k: torch.tensor(np.array(v), device=device) for k, v in np_params.items()}


def _tree(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return params_from_jax(tree, device)
    return OptState(*(params_from_jax(x, device) for x in tree))


def fresh_table(pcfg: PredictorConfig, device, n_slots: int = 8, fresh: dict | None = None) -> ModelTable:
    """An empty :class:`ModelTable` on ``device``.  A slot is initialised at
    first use from ``fresh[slot]`` (a flat dict of arrays) where ``fresh``
    has it, else by :func:`repro_torch.core.predictor.init`."""
    dev = resolve_device(device)
    fresh = fresh or {}
    init = lambda s: params_from_jax(fresh[s], dev) if s in fresh else predictor.init(s, pcfg, dev)
    return ModelTable(init, n_slots=n_slots)


def table_from_blob(blob: dict, pcfg: PredictorConfig, device, fresh: dict | None = None) -> ModelTable:
    """A :class:`ModelTable` on ``device`` from a host blob; slots the blob
    lacks are initialised fresh as :func:`fresh_table` says."""
    dev = resolve_device(device)
    table = fresh_table(pcfg, dev, int(blob["n_slots"]), fresh)
    for s, e in blob["slots"].items():
        table.slots[int(s)] = Entry(
            params=_tree(e["params"], dev),
            prev_params=_tree(e.get("prev_params"), dev),
            opt_state=_tree(e.get("opt_state"), dev),
            step=int(e["step"]),
            n_updates=int(e["n_updates"]),
            last_acc=float(e["last_acc"]),
        )
    return table


#: the ``.npz`` key prefixes of a slot's AdamW moments and LUCIR snapshot
#: (``slot<s>/opt/m/<param key>``, ``slot<s>/opt/v/<param key>``,
#: ``slot<s>/prev/<param key>``); no param key starts with them
NPZ_TREES = {"opt/m/": "m", "opt/v/": "v", "prev/": "prev_params"}


def _from_planes(a: np.ndarray) -> np.ndarray:
    """A float32 array stored as its four byte planes (uint8, shape
    ``(4, *shape)``, least significant byte first, as the export script
    writes it) back, bit for bit; any other array as it is."""
    if a.dtype != np.uint8:
        return a
    return np.ascontiguousarray(np.moveaxis(a, 0, -1)).view("<f4")[..., 0]


def blob_from_npz(path: str | Path) -> dict:
    """The host blob stored in an ``.npz`` of ``slot<s>/<param key>`` arrays
    plus ``slot<s>/{step,n_updates,last_acc}`` and ``n_slots``, and where a
    slot has them its moments and snapshot under ``NPZ_TREES``' prefixes
    (``opt_state`` an :class:`OptState` of numpy dicts, else ``None``); a
    float32 array may be stored as its byte planes (``_from_planes``)."""
    with np.load(path) as z:
        slots: dict[int, dict] = {}
        for key in z.files:
            if key == "n_slots":
                continue
            head, name = key.split("/", 1)
            e = slots.setdefault(int(head[len("slot"):]), {"params": {}})
            if name in ("step", "n_updates", "last_acc"):
                e[name] = z[key].item()
                continue
            pre = next((pre for pre in NPZ_TREES if name.startswith(pre)), None)
            if pre is None:
                e["params"][name] = _from_planes(z[key])
            else:
                e.setdefault(NPZ_TREES[pre], {})[name[len(pre):]] = _from_planes(z[key])
        for e in slots.values():
            m, v = e.pop("m", None), e.pop("v", None)
            if (m is None) != (v is None):
                raise ValueError(f"{path}: a slot has one AdamW moment without the other")
            e["opt_state"] = None if m is None else OptState(m=m, v=v)
            e.setdefault("prev_params", None)
        return {"n_slots": int(z["n_slots"]), "slots": slots}


def fresh_slots(path: str | Path) -> dict[int, dict]:
    """The initial params per slot stored in an ``.npz`` of
    ``slot<s>/<param key>`` arrays (``fresh=`` of :func:`table_from_blob`)."""
    return {s: e["params"] for s, e in blob_from_npz(path)["slots"].items()}
