"""Plugin registries for predictor architectures and QoS stability scorers
(port of the predictor and stability tables of ``repro.uvm.registry``).

* **predictor builder(cfg)** returns ``(init_fn(seed, device) -> params,
  forward(params, batch) -> (logits, features))`` — the
  :func:`repro_torch.core.baselines_nn.make_model` contract.  Builtins:
  ``transformer``, ``lstm``, ``cnn``, ``mlp``; each name is a valid
  ``kind`` for ``Trainer`` / ``run_protocol``.
* **stability factory(**kw)** returns a scorer ``score(history) -> float in
  [0, 1]`` mapping one tenant's per-round pressure history (its thrash rate
  per access) to how oversubscribable it currently is (1 = stable, 0 =
  thrashing).  Builtins: ``percentile``, ``gmr``.  Used by
  :class:`repro_torch.uvm.qos.BudgetController`.

Names are single-owner: registering an existing name raises ``ValueError``.
:func:`scoped` restores both tables on exit.  The policy, prefetcher,
classifier and frequency-table tables are not ported yet (ROADMAP A4).
"""
from __future__ import annotations

import contextlib
from typing import Callable

_PREDICTORS: dict[str, Callable] = {}
_STABILITY: dict[str, Callable] = {}


def _claim(table: dict, name: str, kind: str) -> None:
    if not name or not isinstance(name, str):
        raise ValueError(f"{kind} name must be a non-empty string, got {name!r}")
    if name in table:
        raise ValueError(f"{kind} {name!r} is already registered")


def register_predictor(name: str, builder: Callable) -> None:
    """Register a predictor architecture: ``builder(cfg)`` returns
    ``(init_fn, forward)`` per :func:`repro_torch.core.baselines_nn.make_model`."""
    _claim(_PREDICTORS, name, "predictor")
    _PREDICTORS[name] = builder


def register_stability(name: str, factory: Callable) -> None:
    """Register a QoS stability scorer: ``factory(**kw)`` returns
    ``score(history) -> float`` in ``[0, 1]``."""
    _claim(_STABILITY, name, "stability")
    _STABILITY[name] = factory


def predictor_names() -> tuple[str, ...]:
    return tuple(_PREDICTORS)


def stability_names() -> tuple[str, ...]:
    return tuple(_STABILITY)


def predictor_builder(name: str) -> Callable:
    try:
        return _PREDICTORS[name]
    except KeyError:
        raise KeyError(f"unknown predictor kind {name!r}; registered: {sorted(_PREDICTORS)}") from None


def stability_factory(name: str) -> Callable:
    try:
        return _STABILITY[name]
    except KeyError:
        raise KeyError(f"unknown stability scorer {name!r}; registered: {sorted(_STABILITY)}") from None


@contextlib.contextmanager
def scoped():
    """Restore both registry tables on exit (throwaway registrations)."""
    saved = dict(_PREDICTORS), dict(_STABILITY)
    try:
        yield
    finally:
        _PREDICTORS.clear()
        _PREDICTORS.update(saved[0])
        _STABILITY.clear()
        _STABILITY.update(saved[1])
