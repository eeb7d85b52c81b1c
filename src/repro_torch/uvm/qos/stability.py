"""Registered QoS stability scorers (the ``stability`` registry kind; port
of ``repro.uvm.qos.stability``, numpy only).

A scorer maps one tenant's per-round pressure history — its thrash rate
per access, clipped to ``[0, 1]`` — to a stability score in ``[0, 1]``:
1 = perfectly stable (safe to lend elastic capacity to), 0 = thrashing.
:class:`repro_torch.uvm.qos.BudgetController` multiplies the score into the
tenant's elastic ``share`` weight, so unstable tenants' budgets shrink
toward their guaranteed floor while stable tenants absorb the slack.

Two builtins, both the shape of scroogevm's ``stability_assesser``, which
scores a VM's oversubscribability from a percentile of its observed usage
history:

* ``percentile`` — 1 minus the q-th percentile of the recent window: one
  bad round is forgiven until it becomes the tail of the distribution.
* ``gmr`` — 1 minus the geometric mean ratio of the window: sustained
  pressure compounds multiplicatively, single spikes wash out (the
  GMR-style alternative scroogevm exposes next to the percentile one).

An empty history scores 1.0: a tenant is presumed stable until observed
otherwise (its guaranteed floor protects the others meanwhile).
"""
from __future__ import annotations

import numpy as np

from repro_torch.uvm import registry as _registry


def percentile_scorer(q: float = 90.0, window: int = 16):
    """Scorer: ``1 - percentile_q(history[-window:])``, clipped to [0, 1]."""

    def score(history) -> float:
        h = np.clip(np.asarray(history, float)[-window:], 0.0, 1.0)
        if h.size == 0:
            return 1.0
        return float(np.clip(1.0 - np.percentile(h, q), 0.0, 1.0))

    return score


def gmr_scorer(window: int = 16, eps: float = 1e-6):
    """Scorer: ``1 - geomean(history[-window:])``, clipped to [0, 1]."""

    def score(history) -> float:
        h = np.clip(np.asarray(history, float)[-window:], 0.0, 1.0)
        if h.size == 0:
            return 1.0
        g = float(np.exp(np.log(h + eps).mean()) - eps)
        return float(np.clip(1.0 - g, 0.0, 1.0))

    return score


# Guarded for idempotence under importlib.reload.
if "percentile" not in _registry.stability_names():
    _registry.register_stability("percentile", percentile_scorer)
    _registry.register_stability("gmr", gmr_scorer)
