"""Frozen experiment specs (port of ``repro.uvm.api.specs``).  Only the QoS
block is here so far: :class:`QosTierSpec` and :class:`QosSpec`, which
``run_ours(qos=)`` and ``mux_for(qos=)`` take.  The workload, model, cell
and protocol specs and their content keys are ROADMAP A5."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QosTierSpec:
    """One tenant's QoS contract in a spec: ``tenant`` names the workload
    (a :func:`repro_torch.uvm.trace.concurrent` part name, or a tenant id),
    ``floor`` its guaranteed fraction of device capacity, ``share`` its
    weight over the elastic pool the floors leave over."""

    tenant: str
    floor: float = 0.0
    share: float = 1.0


@dataclasses.dataclass(frozen=True)
class QosSpec:
    """The per-tenant capacity-partitioning block of a learned run: QoS
    tiers plus the :class:`~repro_torch.uvm.qos.BudgetController` knobs.
    ``stability`` names a registered stability scorer (``percentile`` /
    ``gmr``), ``interval`` how many feedback rounds pass between budget
    recomputes.  Tenants without a tier get the all-elastic default
    (floor 0, share 1)."""

    tiers: tuple[QosTierSpec, ...] = ()
    stability: str = "percentile"
    interval: int = 1

    def controller(self, capacity: int, n_blocks: int, tenant_names=()):
        """The :class:`~repro_torch.uvm.qos.BudgetController` this spec
        describes.  ``tenant_names`` maps integer tenant ids (a trace's
        ``tenant_names`` tuple) onto the spec's name-keyed tiers."""
        from repro_torch.uvm.qos import BudgetController, QosTier

        tiers: dict = {t.tenant: QosTier(t.floor, t.share) for t in self.tiers}
        for i, name in enumerate(tenant_names or ()):
            if name in tiers:
                tiers[i] = tiers[name]
        return BudgetController(capacity, n_blocks, tiers=tiers, stability=self.stability, interval=self.interval)
