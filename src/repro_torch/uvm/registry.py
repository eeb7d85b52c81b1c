"""Plugin registries for eviction policies, prefetchers, predictors,
classifiers, frequency tables and QoS stability scorers (port of
``repro.uvm.registry``).

The simulator's victim-key builders (``lru``/``random``/``belady``/``hpe``/
``learned``), its prefetchers (``demand``/``tree``, ``none`` an alias of
``demand``), the predictor architectures, the ``dfa`` classifier and the
``setassoc`` frequency table are all registered default entries of the
tables below.  A new strategy is a registration that rides the
simulator's event loop and its ``evict_select`` victim selection, with no
edit to :mod:`repro_torch.uvm.simulator`::

    from repro_torch.uvm.registry import register_policy

    def mru_keys(state, interval_now, t_now):
        # most-recently-used first: larger last_access = better victim
        return (-state.last_access,)

    register_policy("mru", mru_keys)
    S.run_batch(trace, [("mru", "tree", 1.25), ...])

Contracts:

* **policy key_fn(state, interval_now, t_now)** returns a tuple of 1-3
  int32 tensors shaped like ``state.last_access`` (on the state's device;
  ``interval_now`` and ``t_now`` are int32 device scalars): the
  lexicographic victim key, smallest evicted first.  Keys must be constant
  for the whole step (nothing an eviction changes may feed back into
  them), which is what lets one ``evict_select`` call take every victim
  of a step.
* **prefetcher mask_fn(resident, blk, valid, n_blocks)** returns a bool
  mask of blocks to migrate alongside a faulted block ``blk`` (a host int;
  it runs only on faulting steps, and ``resident`` already includes the
  demand block).  ``mask_fn=None`` is demand-only.
* **predictor builder(cfg)** returns ``(init_fn(seed, device) -> params,
  forward(params, batch) -> (logits, features))``, the
  :func:`repro_torch.core.baselines_nn.make_model` contract.
* **classifier factory()** returns a fresh stateful pattern classifier
  with ``classify(blocks, kernels) -> pattern_id`` and ``reset()``, the
  :class:`repro_torch.core.pattern.PatternClassifier` contract.  Builtin:
  ``dfa``.
* **freq-table factory(device=)** returns a fresh prediction-frequency
  engine on ``device`` with ``update(blocks)`` / ``lookup_many(blocks)`` /
  ``dense(n_blocks)`` / ``on_intervals(n)``, the
  :class:`repro_torch.core.policy.PredictionFrequencyTable` contract.
  Builtin: ``setassoc`` (the paper's 1024x16 table, through the
  ``freq_table`` kernels on the card).
* **stability factory(**kw)** returns a scorer ``score(history) -> float
  in [0, 1]`` over one tenant's per-round pressure history (1 = stable,
  0 = thrashing).  Builtins: ``percentile``, ``gmr``.

Registration order is identity: ids are assigned densely in registration
order, so the builtin ids (``lru`` 0 .. ``learned`` 4, ``demand`` 0,
``tree`` 1, ``none`` -> 0) equal the JAX package's.  A monotonic version
counter tracks policy and prefetcher registrations.

Names are single-owner: registering an existing name raises
``ValueError``.  :func:`scoped` restores every table on exit.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

__all__ = [
    "register_policy",
    "register_prefetcher",
    "register_predictor",
    "register_classifier",
    "register_freq_table",
    "register_stability",
    "policy_names",
    "prefetcher_names",
    "predictor_names",
    "classifier_names",
    "freq_table_names",
    "stability_names",
    "policy_branches",
    "prefetch_branches",
    "predictor_builder",
    "classifier_factory",
    "freq_table_factory",
    "stability_factory",
    "registry_version",
    "scoped",
    "POLICY_IDS",
    "PREFETCH_IDS",
]


class _PolicyEntry(NamedTuple):
    name: str
    pid: int
    key_fn: Callable  # (state, interval_now, t_now) -> tuple of int32 tensors


class _PrefetchEntry(NamedTuple):
    name: str
    pid: int
    mask_fn: Callable | None  # (resident, blk, valid, n_blocks) -> bool mask


_POLICIES: dict[str, _PolicyEntry] = {}
_PREFETCHERS: dict[str, _PrefetchEntry] = {}
_PREDICTORS: dict[str, Callable] = {}
_CLASSIFIERS: dict[str, Callable] = {}
_FREQ_TABLES: dict[str, Callable] = {}
_STABILITY: dict[str, Callable] = {}

# name -> dense id (aliases share the target's id).  These dict objects are
# stable: the simulator imports and holds them, so registrations made after
# import are visible everywhere.
POLICY_IDS: dict[str, int] = {}
PREFETCH_IDS: dict[str, int] = {}

_VERSION = [0]


def registry_version() -> int:
    """Monotonic counter bumped by every policy/prefetcher registration."""
    return _VERSION[0]


def _claim(table: dict, name: str, kind: str) -> None:
    if not name or not isinstance(name, str):
        raise ValueError(f"{kind} name must be a non-empty string, got {name!r}")
    if name in table:
        raise ValueError(f"{kind} {name!r} is already registered")


def register_policy(name: str, key_fn: Callable) -> None:
    """Register an eviction policy by its victim-key builder
    ``key_fn(state, interval_now, t_now)`` (1-3 int32 tensors shaped like
    ``state.last_access``; the lexicographically smallest evicts first)."""
    _claim(_POLICIES, name, "policy")
    entry = _PolicyEntry(name, len(_POLICIES), key_fn)
    _POLICIES[name] = entry
    POLICY_IDS[name] = entry.pid
    _VERSION[0] += 1


def register_prefetcher(name: str, mask_fn: Callable | None = None, *, alias_of: str | None = None) -> None:
    """Register a prefetcher by its migration-mask builder
    ``mask_fn(resident, blk, valid, n_blocks)`` (``None``: demand only).
    ``alias_of`` registers a second name for an existing entry (same id)."""
    _claim(_PREFETCHERS, name, "prefetcher")
    if alias_of is not None:
        if mask_fn is not None:
            raise ValueError("pass either mask_fn or alias_of, not both")
        if alias_of not in _PREFETCHERS:
            raise ValueError(f"alias_of target {alias_of!r} is not a registered prefetcher")
        target = _PREFETCHERS[alias_of]
        entry = _PrefetchEntry(name, target.pid, target.mask_fn)
    else:
        n_real = len({e.pid for e in _PREFETCHERS.values()})
        entry = _PrefetchEntry(name, n_real, mask_fn)
    _PREFETCHERS[name] = entry
    PREFETCH_IDS[name] = entry.pid
    _VERSION[0] += 1


def register_predictor(name: str, builder: Callable) -> None:
    """Register a predictor architecture: ``builder(cfg)`` returns
    ``(init_fn, forward)`` per :func:`repro_torch.core.baselines_nn.make_model`."""
    _claim(_PREDICTORS, name, "predictor")
    _PREDICTORS[name] = builder


def register_classifier(name: str, factory: Callable) -> None:
    """Register an access-pattern classifier by a zero-argument factory of
    a fresh stateful classifier (``classify(blocks, kernels)``, ``reset()``)."""
    _claim(_CLASSIFIERS, name, "classifier")
    _CLASSIFIERS[name] = factory


def register_freq_table(name: str, factory: Callable) -> None:
    """Register a prediction-frequency engine by a factory
    ``factory(device=...)`` of a fresh table on that device (``update``,
    ``lookup_many``, ``dense``, ``on_intervals``)."""
    _claim(_FREQ_TABLES, name, "freq-table")
    _FREQ_TABLES[name] = factory


def register_stability(name: str, factory: Callable) -> None:
    """Register a QoS stability scorer: ``factory(**kw)`` returns
    ``score(history) -> float`` in ``[0, 1]``."""
    _claim(_STABILITY, name, "stability")
    _STABILITY[name] = factory


def policy_names() -> tuple[str, ...]:
    return tuple(_POLICIES)


def prefetcher_names() -> tuple[str, ...]:
    return tuple(_PREFETCHERS)


def predictor_names() -> tuple[str, ...]:
    return tuple(_PREDICTORS)


def classifier_names() -> tuple[str, ...]:
    return tuple(_CLASSIFIERS)


def freq_table_names() -> tuple[str, ...]:
    return tuple(_FREQ_TABLES)


def stability_names() -> tuple[str, ...]:
    return tuple(_STABILITY)


def policy_branches() -> tuple[Callable, ...]:
    """Victim-key builders ordered by id."""
    return tuple(e.key_fn for e in sorted(_POLICIES.values(), key=lambda e: e.pid))


def prefetch_branches() -> tuple[Callable | None, ...]:
    """Mask builders ordered by id, one per distinct id (aliases collapse)."""
    by_id: dict[int, Callable | None] = {}
    for e in _PREFETCHERS.values():
        by_id.setdefault(e.pid, e.mask_fn)
    return tuple(by_id[i] for i in sorted(by_id))


def predictor_builder(name: str) -> Callable:
    try:
        return _PREDICTORS[name]
    except KeyError:
        raise KeyError(f"unknown predictor kind {name!r}; registered: {sorted(_PREDICTORS)}") from None


def classifier_factory(name: str) -> Callable:
    try:
        return _CLASSIFIERS[name]
    except KeyError:
        raise KeyError(f"unknown classifier {name!r}; registered: {sorted(_CLASSIFIERS)}") from None


def freq_table_factory(name: str) -> Callable:
    try:
        return _FREQ_TABLES[name]
    except KeyError:
        raise KeyError(f"unknown freq-table {name!r}; registered: {sorted(_FREQ_TABLES)}") from None


def stability_factory(name: str) -> Callable:
    try:
        return _STABILITY[name]
    except KeyError:
        raise KeyError(f"unknown stability scorer {name!r}; registered: {sorted(_STABILITY)}") from None


@contextlib.contextmanager
def scoped():
    """Restore every registry table on exit (throwaway registrations).  The
    version counter is not rolled back: it is monotonic, and restored
    tables count as a new state."""
    saved = (
        dict(_POLICIES), dict(_PREFETCHERS), dict(_PREDICTORS),
        dict(POLICY_IDS), dict(PREFETCH_IDS), _VERSION[0],
        dict(_CLASSIFIERS), dict(_FREQ_TABLES), dict(_STABILITY),
    )
    try:
        yield
    finally:
        for table, old in zip((_POLICIES, _PREFETCHERS, _PREDICTORS, POLICY_IDS, PREFETCH_IDS),
                              saved[:5]):
            table.clear()
            table.update(old)
        for table, old in zip((_CLASSIFIERS, _FREQ_TABLES, _STABILITY), saved[6:]):
            table.clear()
            table.update(old)
        if _VERSION[0] != saved[5]:
            _VERSION[0] += 1
