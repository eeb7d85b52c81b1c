"""`repro_torch.uvm.manager` — the streaming oversubscription-management API
(port of ``repro.uvm.manager``; ``TenantMux``, health, snapshots and chaos
injection are not ported yet)."""
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
from repro_torch.uvm.manager.stream import OnlineFeatureStream

__all__ = [
    "INTERVAL_FAULTS",
    "Actions",
    "EvalRequest",
    "FaultBatch",
    "ManagerConfig",
    "OnlineFeatureStream",
    "Outcomes",
    "OversubscriptionManager",
    "TrainRequest",
    "prefetch_mask",
    "prefetch_warm",
]
