"""`repro_torch.uvm.manager` — the streaming oversubscription-management API
(port of ``repro.uvm.manager``: the single-workload manager and the
multi-tenant ``TenantMux`` with its QoS budgets; the health machine,
snapshots and chaos injection are not ported yet)."""
from repro_torch.uvm.manager.core import (
    INTERVAL_FAULTS,
    Actions,
    EvalRequest,
    FaultBatch,
    ManagerConfig,
    Outcomes,
    OversubscriptionManager,
    TrainRequest,
    prefetch_mask,
    prefetch_warm,
)
from repro_torch.uvm.manager.multi import MuxActions, TenantMux
from repro_torch.uvm.manager.stream import OnlineFeatureStream

__all__ = [
    "INTERVAL_FAULTS",
    "Actions",
    "EvalRequest",
    "FaultBatch",
    "ManagerConfig",
    "MuxActions",
    "OnlineFeatureStream",
    "Outcomes",
    "OversubscriptionManager",
    "TenantMux",
    "TrainRequest",
    "prefetch_mask",
    "prefetch_warm",
]
