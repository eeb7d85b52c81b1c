"""`repro_torch.uvm.api` — the declarative experiment surface (port of
``repro.uvm.api``).

* **Specs** (:mod:`repro_torch.uvm.api.specs`) — frozen, JSON-serializable
  dataclasses (`WorkloadSpec`, `PolicySpec`, `PrefetchSpec`, `ModelSpec`,
  `CellSpec`, `ProtocolSpec`, `ExperimentSpec`, ...), each with a stable
  content-hash `.key` equal to the JAX package's.
* **Registries** (:mod:`repro_torch.uvm.registry`) — ``register_policy``,
  ``register_prefetcher``, ``register_predictor``, ``register_classifier``,
  ``register_freq_table``, ``register_stability``: the builtin strategies
  and components are default entries, and a new one is a registration that
  rides the simulator, the manager or the QoS controller.  Importing this
  package registers every builtin.
* **Session + run store** (:mod:`repro_torch.uvm.api.session`,
  :mod:`repro_torch.uvm.api.store`) — `Session` executes cells on one
  device and persists every result content-addressed under
  ``experiments/runs_torch/``.
* **CLI** — ``python -m repro_torch.uvm.cli {run,sweep,report,export,serve}``.
"""
from repro_torch.core import baselines_nn as _baselines_nn  # noqa: F401 — registers the predictor kinds
from repro_torch.uvm import simulator as _simulator  # noqa: F401 — registers the policies and prefetchers
from repro_torch.uvm.api.session import ALL_BENCH, FEATURED, Session
from repro_torch.uvm.api.specs import (
    CellSpec,
    DriftSpec,
    ExperimentSpec,
    ModelSpec,
    PolicySpec,
    PrefetchSpec,
    PretrainSpec,
    ProtocolSpec,
    QosSpec,
    QosTierSpec,
    TrainSpec,
    WorkloadSpec,
    spec_from_dict,
    spec_key,
)
from repro_torch.uvm.api.store import RunStore
from repro_torch.uvm.manager import core as _manager_core  # noqa: F401 — registers dfa and setassoc
from repro_torch.uvm.qos import stability as _stability  # noqa: F401 — registers the stability scorers
from repro_torch.uvm.registry import (
    classifier_names,
    freq_table_names,
    policy_names,
    predictor_names,
    prefetcher_names,
    register_classifier,
    register_freq_table,
    register_policy,
    register_predictor,
    register_prefetcher,
    register_stability,
    stability_names,
)

__all__ = [
    "WorkloadSpec", "DriftSpec", "PolicySpec", "PrefetchSpec", "TrainSpec",
    "PretrainSpec", "ModelSpec", "CellSpec", "ProtocolSpec", "ExperimentSpec",
    "QosSpec", "QosTierSpec",
    "spec_key", "spec_from_dict",
    "RunStore", "Session", "ALL_BENCH", "FEATURED",
    "register_policy", "register_prefetcher", "register_predictor",
    "register_classifier", "register_freq_table", "register_stability",
    "policy_names", "prefetcher_names", "predictor_names",
    "classifier_names", "freq_table_names", "stability_names",
]
