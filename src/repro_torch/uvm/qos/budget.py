"""The :class:`BudgetController`: elastic per-tenant capacity budgets (port
of ``repro.uvm.qos.budget``; host numpy, as in the JAX package).

Partition rule (scroogevm's tier0/tier1 split, per tenant instead of per
VM slice): every tenant is guaranteed ``floor * capacity`` blocks
outright; whatever capacity the floors leave over is the ELASTIC pool,
divided in proportion to ``share * stability`` where ``stability`` is a
registered scorer over the tenant's observed pressure history
(:mod:`repro_torch.uvm.qos.stability`).  A thrashing tenant's score decays
toward 0, its budget shrinks toward its floor, and the reclaimed blocks
flow to stable tenants — rebalanced every ``interval`` feedback rounds.

The budgets become EVICTION TIERS, not hard caps: nothing stops a tenant
migrating blocks past its budget, but :meth:`evict_pref` marks every
resident block of an over-budget tenant (and every resident block nobody
owns) with ``-1`` in the simulator's leading victim key, so the packed
lexicographic argmin exhausts those before ANY under-budget tenant's
block is even considered.  When every tenant is within budget the total
residency is at most ``sum(budgets) <= capacity`` and no eviction happens
at all — which is what makes the fairness guarantee composable with any
registered eviction policy's own keys.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.uvm import registry as _registry


@dataclasses.dataclass(frozen=True)
class QosTier:
    """One tenant's QoS contract: a guaranteed ``floor`` fraction of device
    capacity (never reclaimed, whatever the tenant does) plus an elastic
    ``share`` weight for the pool the floors leave over."""

    floor: float = 0.0
    share: float = 1.0

    def __post_init__(self):
        if not 0.0 <= self.floor <= 1.0:
            raise ValueError(f"tier floor must be in [0, 1], got {self.floor}")
        if self.share < 0.0:
            raise ValueError(f"tier share must be >= 0, got {self.share}")


def parse_tier_flags(items) -> dict[str, QosTier]:
    """Parse repeated ``--qos-tier TENANT:FLOOR[:SHARE]`` flag values."""
    tiers: dict[str, QosTier] = {}
    for item in items or ():
        parts = str(item).split(":")
        if not 2 <= len(parts) <= 3 or not parts[0]:
            raise ValueError(
                f"bad --qos-tier {item!r}; expected TENANT:FLOOR[:SHARE] (e.g. A:0.5:1.0)"
            )
        tiers[parts[0]] = QosTier(
            floor=float(parts[1]), share=float(parts[2]) if len(parts) == 3 else 1.0
        )
    return tiers


class BudgetController:
    """Recompute per-tenant block budgets from observed behaviour and
    compile them (plus current residency) into the simulator's leading
    victim key.

    ``capacity`` is the device capacity in blocks, ``n_blocks`` the
    (bucket-padded) simulator block-space width.  ``tiers`` maps tenant
    keys to :class:`QosTier`; unknown tenants get ``default_tier``.
    Tenants are admitted on first contact (:meth:`observe_blocks`) and
    block ownership is learned first-toucher from the demand stream;
    :meth:`release` hands a departed tenant's claim back to the pool.
    """

    def __init__(
        self,
        capacity: int,
        n_blocks: int,
        *,
        tiers: dict | None = None,
        default_tier: QosTier = QosTier(),
        stability: str = "percentile",
        interval: int = 1,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.n_blocks = int(n_blocks)
        self.tiers = dict(tiers or {})
        self.default_tier = default_tier
        self.stability = stability
        self.interval = max(int(interval), 1)
        self._scorer = _registry.stability_factory(stability)()
        self.block_owner = np.full(self.n_blocks, -1, np.int32)
        self._index: dict = {}  # tenant key -> dense owner index (never reused)
        self._tier: dict = {}  # tenant key -> QosTier
        self._hist: dict = {}  # tenant key -> [pressure per round]
        self.budgets: dict = {}  # tenant key -> blocks
        self.scores: dict = {}  # tenant key -> last stability score
        self._round = 0

    # -- admission / departure ----------------------------------------------

    @property
    def tenants(self) -> tuple:
        return tuple(self._tier)

    def admit(self, tenant) -> None:
        """Declare a tenant (idempotent; also implicit in observe_blocks)."""
        if tenant in self._tier:
            return
        if tenant not in self._index:
            self._index[tenant] = len(self._index)
        self._tier[tenant] = self.tiers.get(tenant, self.default_tier)
        self._hist[tenant] = []
        self._recompute()

    def release(self, tenant) -> None:
        """Forget a departed tenant: its blocks return to the unowned pool
        (= preferred victims) and its budget slice rebalances to the live
        tenants on the next recompute."""
        if tenant not in self._tier:
            return
        self.block_owner[self.block_owner == self._index[tenant]] = -1
        del self._tier[tenant]
        del self._hist[tenant]
        self.budgets.pop(tenant, None)
        self.scores.pop(tenant, None)
        self._recompute()

    # -- observation ---------------------------------------------------------

    def observe_blocks(self, tenant, blocks) -> None:
        """Claim the unowned blocks of one tenant's demand batch
        (first-toucher ownership; admits the tenant on first contact)."""
        self.admit(tenant)
        b = np.asarray(blocks, np.int64)
        b = b[(b >= 0) & (b < self.n_blocks)]
        unowned = b[self.block_owner[b] < 0]
        self.block_owner[unowned] = self._index[tenant]

    def observe_pressure(self, tenant, pressure: float) -> None:
        """Record one round's pressure sample (thrash rate per access in
        [0, 1] — the mux feeds ``was_evicted.mean()``)."""
        self.admit(tenant)
        self._hist[tenant].append(float(np.clip(pressure, 0.0, 1.0)))

    def step(self) -> None:
        """Close one feedback round; recompute budgets every ``interval``."""
        self._round += 1
        if self._round % self.interval == 0:
            self._recompute()

    # -- the elastic split ----------------------------------------------------

    def _recompute(self) -> None:
        keys = list(self._tier)
        if not keys:
            self.budgets = {}
            return
        floors = np.array([self._tier[k].floor for k in keys], float)
        if floors.sum() > 1.0:  # over-promised floors scale down pro rata
            floors = floors / floors.sum()
        guaranteed = np.floor(floors * self.capacity).astype(np.int64)
        elastic = int(self.capacity - guaranteed.sum())
        self.scores = {k: float(self._scorer(self._hist[k])) for k in keys}
        w = np.array([self._tier[k].share * self.scores[k] for k in keys], float)
        if w.sum() <= 0.0:
            w = np.ones(len(keys), float)  # nobody scores: split evenly
        ew = np.floor(elastic * w / w.sum()).astype(np.int64)
        self.budgets = {k: int(guaranteed[i] + ew[i]) for i, k in enumerate(keys)}

    # -- the simulator-facing artifact ----------------------------------------

    def evict_pref(self, resident) -> np.ndarray:
        """The per-block leading victim key for the CURRENT residency:
        ``-1`` (evict first) on resident blocks of over-budget tenants and
        on resident blocks nobody owns, ``0`` elsewhere.  Constant for one
        segment, like every other packed-priority key."""
        resident = np.asarray(resident, bool)[: self.n_blocks]
        pref = np.zeros(self.n_blocks, np.int32)
        if not self._tier:
            return pref
        owner = self.block_owner
        idx_budget = np.zeros(len(self._index), np.int64)
        for k, i in self._index.items():
            idx_budget[i] = self.budgets.get(k, 0)
        owned = owner >= 0
        counts = np.bincount(owner[resident & owned], minlength=len(self._index))
        over = counts > idx_budget
        pref[resident & owned & over[np.clip(owner, 0, None)]] = -1
        pref[resident & ~owned] = -1
        return pref

    # -- snapshot / restore ----------------------------------------------------

    def state(self) -> dict:
        """Host-side snapshot (the scorer is rebuilt by name on restore)."""
        return {
            "stability": self.stability,
            "interval": self.interval,
            "round": self._round,
            "block_owner": self.block_owner.copy(),
            "index": dict(self._index),
            "tiers": {k: (t.floor, t.share) for k, t in self._tier.items()},
            "hist": {k: list(v) for k, v in self._hist.items()},
        }

    def restore(self, state: dict) -> None:
        self.stability = state["stability"]
        self._scorer = _registry.stability_factory(self.stability)()
        self.interval = state["interval"]
        self._round = state["round"]
        self.block_owner = np.asarray(state["block_owner"], np.int32).copy()
        self._index = dict(state["index"])
        self._tier = {k: QosTier(f, s) for k, (f, s) in state["tiers"].items()}
        self._hist = {k: list(v) for k, v in state["hist"].items()}
        self._recompute()
