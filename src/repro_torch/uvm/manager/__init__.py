"""`repro_torch.uvm.manager` — the streaming oversubscription-management API
(port of ``repro.uvm.manager``): the single-workload manager and the
multi-tenant ``TenantMux`` with its QoS budgets.

Fault tolerance rides on top: :class:`HealthConfig` turns on the
degraded-mode state machine (fail-soft into rule-based actions),
``state()``/``restore()`` + :class:`SnapshotStore` checkpoint a live
manager or mux, and :class:`FaultInjector` replays seeded chaos
schedules."""
from repro_torch.uvm.manager.chaos import ChaosError, ChaosSchedule, FaultInjector
from repro_torch.uvm.manager.core import (
    HEALTH_STATES,
    INTERVAL_FAULTS,
    Actions,
    EvalRequest,
    FaultBatch,
    HealthConfig,
    ManagerConfig,
    Outcomes,
    OversubscriptionManager,
    TrainRequest,
    prefetch_mask,
    prefetch_warm,
)
from repro_torch.uvm.manager.multi import MuxActions, TenantMux
from repro_torch.uvm.manager.snapshot import STATE_VERSION, SnapshotStore
from repro_torch.uvm.manager.stream import OnlineFeatureStream

__all__ = [
    "HEALTH_STATES",
    "INTERVAL_FAULTS",
    "STATE_VERSION",
    "Actions",
    "ChaosError",
    "ChaosSchedule",
    "EvalRequest",
    "FaultBatch",
    "FaultInjector",
    "HealthConfig",
    "ManagerConfig",
    "MuxActions",
    "OnlineFeatureStream",
    "Outcomes",
    "OversubscriptionManager",
    "SnapshotStore",
    "TenantMux",
    "TrainRequest",
    "prefetch_mask",
    "prefetch_warm",
]
