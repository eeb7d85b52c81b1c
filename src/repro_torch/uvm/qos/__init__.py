"""`repro_torch.uvm.qos` — per-tenant capacity partitioning for the shared
device (port of ``repro.uvm.qos``).

The simulator evicts from one global capacity pool, so a thrashing tenant
can starve a well-behaved neighbour: the victim keys say nothing about who
owns a block.  Three pieces sit between the
:class:`~repro_torch.uvm.manager.TenantMux` and the simulator:

* **Budgeted eviction** — :meth:`BudgetController.evict_pref` compiles the
  current budgets and residency into the per-block int32 leading victim key
  (``repro_torch.uvm.simulator.run_segment(..., evict_pref=...)``, the
  ``evict_select`` kernel's fourth key): blocks of over-budget tenants
  carry ``-1`` and are exhausted before any under-budget tenant loses a
  page.  No budgets (``qos=None``) keeps the three-key program.
* **Elastic rebalancing** — :class:`BudgetController` recomputes budgets
  every ``interval`` rounds from observed per-tenant pressure (thrash per
  access), weighting each tenant's slice of the elastic pool by a
  registered ``stability`` scorer (:mod:`repro_torch.uvm.qos.stability`).
* **Tiers** — :class:`QosTier` (guaranteed ``floor`` fraction + elastic
  ``share`` weight) per tenant, surfaced as
  :class:`~repro_torch.uvm.api.specs.QosSpec` and ``qos=`` on
  :func:`repro_torch.uvm.runtime.run_ours`.

Block ownership is learned first-toucher from the observed fault stream;
:meth:`BudgetController.release` returns a departed tenant's claim to the
pool.  :meth:`BudgetController.state` / :meth:`BudgetController.restore`
snapshot the controller as host data; ``TenantMux.state`` carries it.
"""
from repro_torch.uvm.qos.budget import BudgetController, QosTier, parse_tier_flags
from repro_torch.uvm.qos import stability as stability  # noqa: F401  (registers builtins)

__all__ = ["BudgetController", "QosTier", "parse_tier_flags"]
