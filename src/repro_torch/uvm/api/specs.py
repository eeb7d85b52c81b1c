"""Frozen, JSON-serializable experiment specs with stable content-hash keys
(port of ``repro.uvm.api.specs``).

Every spec is an immutable dataclass whose canonical JSON (sorted keys,
no whitespace) is hashed into a 16-hex ``key`` — the content address the
run store files results under.  Two specs with equal fields have equal
keys in every process, and equal the JAX package's keys character for
character (class names, field names and values, ``SCHEMA``); any field
change (including nested specs) changes the key.  ``SCHEMA`` is folded
into the hash so that a semantic change to what a result MEANS can
invalidate every stored run at once.

Round trip: ``spec.to_dict()`` / ``spec.to_json()`` and
``spec_from_dict(kind, d)`` / ``SpecClass.from_dict(d)``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterator

from repro_torch.configs.predictor_paper import CONFIG_QUICK, PredictorConfig
from repro_torch.core.incremental import TrainConfig

SCHEMA = 3  # the JAX package's; bump both to invalidate every stored run
# SCHEMA 3: the QoS subsystem — ModelSpec grew a `qos` block
# (per-tenant tiers + budget controller knobs) and budgeted muxes release
# departed tenants' counters; a concurrent `ours` result now depends on
# the capacity-partitioning regime it ran under, so results stored under
# SCHEMA 2 no longer mean the same thing.
# SCHEMA 2: concurrent `ours` cells route through the TenantMux
# (per-tenant pipelines) instead of one merged-stream manager, and
# ModelSpec grew tenancy/re-classification fields — results stored under
# SCHEMA 1 no longer mean the same thing.
# (ModelSpec's health/latency_budget_ms came WITHOUT a schema bump:
# `ours` keys move — defaults are behavior-identical, old cells simply
# recompute — while rule-based cells keep their keys and stored results.)

#: corpus the paper's Section V-A pretraining draws from (5 benchmarks,
#: different inputs) — shared default of Session.pretrained / fig11 / table7
PRETRAIN_BENCHES = ("ATAX", "Backprop", "BICG", "Hotspot", "NW")


def spec_key(spec) -> str:
    """Stable 16-hex content hash of a spec (type name + schema + fields)."""
    payload = json.dumps(
        {"kind": type(spec).__name__, "schema": SCHEMA, "spec": dataclasses.asdict(spec)},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.md5(payload.encode()).hexdigest()[:16]


class _SpecBase:
    """Mixin: content key + JSON round trip for frozen spec dataclasses."""

    @property
    def key(self) -> str:
        return spec_key(self)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class DriftSpec(_SpecBase):
    """A drifting-workload recipe from the zoo (:mod:`repro_torch.uvm.zoo`).

    ``kind='phase'`` splices ``phases`` (benchmark or zoo-pattern names)
    into one stream, ``segment`` accesses each; ``switch='gradual'`` blends
    ``mix_window`` accesses around every boundary (``'abrupt'`` cuts hard).
    ``kind='churn'`` merges ``phases`` as tenants that JOIN after
    ``joins[i]`` merged accesses and LEAVE after ``spans[i]`` of their own
    (0/absent = full trace; empty ``joins`` auto-staggers)."""

    kind: str = "phase"  # phase | churn
    phases: tuple[str, ...] = ()
    segment: int = 1500  # accesses per phase (kind='phase')
    switch: str = "abrupt"  # abrupt | gradual
    mix_window: int = 0  # blended accesses per boundary (switch='gradual')
    joins: tuple[int, ...] = ()  # per-tenant admission offsets (kind='churn')
    spans: tuple[int, ...] = ()  # per-tenant access budgets (kind='churn')
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("phase", "churn"):
            raise ValueError(f"unknown drift kind {self.kind!r}; 'phase' or 'churn'")
        if self.switch not in ("abrupt", "gradual"):
            raise ValueError(f"unknown drift switch {self.switch!r}; 'abrupt' or 'gradual'")
        if len(self.phases) < 2:
            raise ValueError("a drift spec needs at least two phases/tenants")

    @classmethod
    def from_dict(cls, d: dict) -> "DriftSpec":
        return cls(
            kind=d.get("kind", "phase"), phases=tuple(d.get("phases", ())),
            segment=d.get("segment", 1500), switch=d.get("switch", "abrupt"),
            mix_window=d.get("mix_window", 0), joins=tuple(d.get("joins", ())),
            spans=tuple(d.get("spans", ())), seed=d.get("seed", 0),
        )


@dataclasses.dataclass(frozen=True)
class WorkloadSpec(_SpecBase):
    """A trace to drive: one benchmark generator, a concurrent merge, or a
    drifting zoo workload.

    ``tenants`` non-empty makes this a Section V-F multi-workload trace:
    each tenant benchmark is generated at (scale, cap) and merged at
    scheduler-slice granularity into disjoint page ranges
    (:func:`repro_torch.uvm.trace.concurrent` with ``slice_len``/``seed``).

    ``drift`` non-None builds the trace through the zoo instead
    (:func:`repro_torch.uvm.zoo.phase_trace` / :func:`~repro_torch.uvm.zoo.tenant_churn`
    at this spec's ``scale``, capped at ``cap``; churn merges reuse
    ``slice_len``); ``benchmark`` is then just the display label.
    (This field came WITHOUT a schema bump, like ModelSpec's health
    fields: the default is behavior-identical, old cells simply recompute.)
    """

    benchmark: str
    scale: float = 0.4
    cap: int = 6000  # max trace length (quick mode)
    tenants: tuple[str, ...] = ()
    slice_len: int = 256
    seed: int = 0  # concurrent-merge seed (unused for single-tenant)
    drift: DriftSpec | None = None

    @classmethod
    def concurrent(cls, tenants, *, scale: float = 0.4, cap: int = 6000,
                   slice_len: int = 256, seed: int = 0) -> "WorkloadSpec":
        tenants = tuple(tenants)
        return cls("+".join(tenants), scale, cap, tenants, slice_len, seed)

    @classmethod
    def drifting(cls, phases, *, kind: str = "phase", scale: float = 0.4,
                 cap: int = 6000, segment: int = 1500, switch: str = "abrupt",
                 mix_window: int = 0, joins=(), spans=(), slice_len: int = 256,
                 seed: int = 0) -> "WorkloadSpec":
        """A zoo workload: ``kind='phase'`` splices ``phases`` with the given
        switch style; ``kind='churn'`` merges them as joining/leaving
        tenants."""
        phases = tuple(phases)
        sep = "+" if kind == "churn" else ">"
        label = ("churn:" if kind == "churn" else "drift:") + sep.join(phases)
        drift = DriftSpec(kind=kind, phases=phases, segment=segment, switch=switch,
                          mix_window=mix_window, joins=tuple(joins), spans=tuple(spans),
                          seed=seed)
        return cls(label, scale, cap, slice_len=slice_len, drift=drift)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        return cls(
            benchmark=d["benchmark"], scale=d["scale"], cap=d["cap"],
            tenants=tuple(d.get("tenants", ())),
            slice_len=d.get("slice_len", 256), seed=d.get("seed", 0),
            drift=DriftSpec.from_dict(d["drift"]) if d.get("drift") else None,
        )


@dataclasses.dataclass(frozen=True)
class PolicySpec(_SpecBase):
    """An eviction policy by registered name (see registry.policy_names())."""

    name: str = "lru"

    @classmethod
    def from_dict(cls, d: dict) -> "PolicySpec":
        return cls(name=d["name"])


@dataclasses.dataclass(frozen=True)
class PrefetchSpec(_SpecBase):
    """A prefetcher by registered name (see registry.prefetcher_names())."""

    name: str = "tree"

    @classmethod
    def from_dict(cls, d: dict) -> "PrefetchSpec":
        return cls(name=d["name"])


@dataclasses.dataclass(frozen=True)
class TrainSpec(_SpecBase):
    """Frozen mirror of :class:`repro_torch.core.incremental.TrainConfig`."""

    group_size: int = 1024
    epochs: int = 2
    batch_size: int = 128
    lr: float = 3e-3
    seed: int = 0
    table_slots: int = 8

    def to_train_config(self) -> TrainConfig:
        return TrainConfig(**dataclasses.asdict(self))

    @classmethod
    def from_train_config(cls, tcfg: TrainConfig) -> "TrainSpec":
        return cls(**dataclasses.asdict(tcfg))

    @classmethod
    def from_dict(cls, d: dict) -> "TrainSpec":
        return cls(**d)


#: the paper-scale training schedule (Session.paper()'s default)
PAPER_TRAIN = TrainSpec(group_size=2048, epochs=3, batch_size=256)

#: the shared (trace scale, cap) presets behind every `--scale quick|paper`
#: flag (CLI, sim_perf) and the Session defaults / Session.paper()
SCALE_PRESETS = {"quick": (0.4, 6000), "paper": (1.0, 60_000)}


def parse_scale(scale_arg: str, cap_arg: int | None = None) -> tuple[float, int]:
    """Resolve a `--scale` flag ('quick'/'paper'/float string) + optional
    `--cap` override to (scale, cap) — the one parser every CLI shares."""
    if scale_arg in SCALE_PRESETS:
        scale, cap = SCALE_PRESETS[scale_arg]
    else:
        scale, cap = float(scale_arg), SCALE_PRESETS["quick"][1]
    return scale, (cap_arg if cap_arg is not None else cap)


@dataclasses.dataclass(frozen=True)
class PretrainSpec(_SpecBase):
    """Section V-A offline pretraining recipe: a corpus of benchmark runs
    with different inputs (``seed0 + i``) feeding ``pretrain_table``."""

    benchmarks: tuple[str, ...] = PRETRAIN_BENCHES
    scale: float = 0.24
    seed0: int = 777
    max_rounds: int = 2

    @classmethod
    def from_dict(cls, d: dict) -> "PretrainSpec":
        return cls(
            benchmarks=tuple(d.get("benchmarks", PRETRAIN_BENCHES)),
            scale=d["scale"], seed0=d["seed0"], max_rounds=d["max_rounds"],
        )


@dataclasses.dataclass(frozen=True)
class QosTierSpec(_SpecBase):
    """One tenant's QoS contract in a spec: ``tenant`` names the workload
    (a :func:`repro_torch.uvm.trace.concurrent` part name, or a serve-session
    tenant id), ``floor`` its guaranteed fraction of device capacity,
    ``share`` its weight over the elastic pool the floors leave over."""

    tenant: str
    floor: float = 0.0
    share: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "QosTierSpec":
        return cls(tenant=d["tenant"], floor=d.get("floor", 0.0),
                   share=d.get("share", 1.0))


@dataclasses.dataclass(frozen=True)
class QosSpec(_SpecBase):
    """The per-tenant capacity-partitioning block of a learned run: QoS
    tiers plus the :class:`~repro_torch.uvm.qos.BudgetController` knobs.
    ``stability`` names a registered stability scorer (``percentile`` /
    ``gmr``), ``interval`` how many feedback rounds pass between budget
    recomputes.  Tenants without a tier get the all-elastic default
    (floor 0, share 1)."""

    tiers: tuple[QosTierSpec, ...] = ()
    stability: str = "percentile"
    interval: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "QosSpec":
        return cls(
            tiers=tuple(QosTierSpec.from_dict(t) for t in d.get("tiers", ())),
            stability=d.get("stability", "percentile"),
            interval=d.get("interval", 1),
        )

    def controller(self, capacity: int, n_blocks: int, tenant_names=()):
        """Build the :class:`~repro_torch.uvm.qos.BudgetController` this spec
        describes.  ``tenant_names`` maps integer tenant ids (a trace's
        ``tenant_names`` tuple) onto the spec's name-keyed tiers so the
        same spec serves both trace-driven and streaming paths."""
        from repro_torch.uvm.qos import BudgetController, QosTier

        tiers: dict = {t.tenant: QosTier(t.floor, t.share) for t in self.tiers}
        for i, name in enumerate(tenant_names or ()):
            if name in tiers:
                tiers[i] = tiers[name]
        return BudgetController(
            capacity, n_blocks, tiers=tiers,
            stability=self.stability, interval=self.interval,
        )


#: how a concurrent (tenant-tagged) workload is managed by an `ours` cell
TENANCIES = ("mux", "mux-shared", "merged")


@dataclasses.dataclass(frozen=True)
class ModelSpec(_SpecBase):
    """Everything that determines a learned run besides the workload:
    predictor architecture (a registered ``kind``), its config, the
    training schedule, the Eq. 3 ablation switches, and the optional
    Section V-A pretraining recipe.

    ``tenancy`` picks the multi-tenant treatment of concurrent workloads
    (ignored for single-tenant ones): ``mux`` (default) demultiplexes into
    per-tenant pipelines with isolated frequency tables, ``mux-shared``
    shares ONE frequency table across tenants (the paper's single 18KB
    SRAM budget), ``merged`` is the pre-mux single-manager baseline.
    ``reclass_interval``/``reclass_hysteresis`` are the streaming periodic
    re-classification knobs (0 = classify every observed batch).

    ``health``/``latency_budget_ms`` opt the run into the degraded-mode
    health state machine (:class:`repro_torch.uvm.manager.HealthConfig`):
    dispatch failures and non-finite model outputs fall back to rule-based
    actions instead of raising.  Off by default — the goldens pin the
    legacy fail-hard path bit for bit.

    ``qos`` opts a ``mux`` run into per-tenant capacity partitioning
    (:class:`QosSpec` → a :class:`~repro_torch.uvm.qos.BudgetController`);
    ``None`` (default) is the legacy shared pool, pinned by the goldens."""

    kind: str = "transformer"
    predictor: PredictorConfig = CONFIG_QUICK
    train: TrainSpec = TrainSpec()
    use_thrash_term: bool = True
    use_lucir: bool = True
    pretrain: PretrainSpec | None = None
    tenancy: str = "mux"
    reclass_interval: int = 0
    reclass_hysteresis: int = 2
    health: bool = False
    latency_budget_ms: float = 0.0
    qos: QosSpec | None = None

    def __post_init__(self):
        if self.tenancy not in TENANCIES:
            raise ValueError(f"unknown tenancy {self.tenancy!r}; one of {TENANCIES}")

    @classmethod
    def from_dict(cls, d: dict) -> "ModelSpec":
        return cls(
            kind=d["kind"],
            predictor=PredictorConfig(**d["predictor"]),
            train=TrainSpec.from_dict(d["train"]),
            use_thrash_term=d["use_thrash_term"],
            use_lucir=d["use_lucir"],
            pretrain=PretrainSpec.from_dict(d["pretrain"]) if d.get("pretrain") else None,
            tenancy=d.get("tenancy", "mux"),
            reclass_interval=d.get("reclass_interval", 0),
            reclass_hysteresis=d.get("reclass_hysteresis", 2),
            health=d.get("health", False),
            latency_budget_ms=d.get("latency_budget_ms", 0.0),
            qos=QosSpec.from_dict(d["qos"]) if d.get("qos") else None,
        )

    def health_config(self):
        """The manager-side :class:`~repro_torch.uvm.manager.HealthConfig` this
        spec asks for (``None`` when the health machine is off)."""
        if not self.health:
            return None
        from repro_torch.uvm.manager import HealthConfig

        return HealthConfig(latency_budget_ms=self.latency_budget_ms)


@dataclasses.dataclass(frozen=True)
class CellSpec(_SpecBase):
    """One experiment cell: a workload under one management strategy.

    ``strategy`` picks the engine:
      * ``sim``       — rule-based (policy, prefetch) through the simulator
      * ``ours``      — the paper's learned runtime (``model`` required)
      * ``uvmsmart``  — the UVMSmart adaptive baseline
    """

    workload: WorkloadSpec
    strategy: str = "sim"
    policy: PolicySpec = PolicySpec("lru")
    prefetch: PrefetchSpec = PrefetchSpec("tree")
    oversubscription: float = 1.25
    model: ModelSpec | None = None
    seed: int = 0

    def __post_init__(self):
        if self.strategy not in ("sim", "ours", "uvmsmart"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.strategy == "ours" and self.model is None:
            raise ValueError("strategy 'ours' needs a ModelSpec")

    @classmethod
    def from_dict(cls, d: dict) -> "CellSpec":
        return cls(
            workload=WorkloadSpec.from_dict(d["workload"]),
            strategy=d["strategy"],
            policy=PolicySpec.from_dict(d["policy"]),
            prefetch=PrefetchSpec.from_dict(d["prefetch"]),
            oversubscription=d["oversubscription"],
            model=ModelSpec.from_dict(d["model"]) if d.get("model") else None,
            seed=d.get("seed", 0),
        )


@dataclasses.dataclass(frozen=True)
class ProtocolSpec(_SpecBase):
    """A prediction-accuracy protocol run (Figs. 4/6/10/11, Table VII).

    ``prior`` is the chain context: the benchmark names whose ``ours``
    protocol runs already fine-tuned the shared pretrained table before
    this one (fig11 reuses ONE table across its featured benchmarks, so a
    link's result depends on the links before it — the content hash must
    too). Empty for independent runs."""

    workload: WorkloadSpec
    mode: str = "online_single"  # online_single | online_multi | ours | offline
    model: ModelSpec = ModelSpec()
    prior: tuple[str, ...] = ()

    def __post_init__(self):
        if self.mode not in ("online_single", "online_multi", "ours", "offline"):
            raise ValueError(f"unknown protocol mode {self.mode!r}")

    @classmethod
    def from_dict(cls, d: dict) -> "ProtocolSpec":
        return cls(
            workload=WorkloadSpec.from_dict(d["workload"]),
            mode=d["mode"],
            model=ModelSpec.from_dict(d["model"]),
            prior=tuple(d.get("prior", ())),
        )


@dataclasses.dataclass(frozen=True)
class ExperimentSpec(_SpecBase):
    """A named cross product of cells: workloads x policies x prefetchers x
    oversubscription levels (for ``strategy='sim'``), or workloads x
    oversubscriptions (for ``ours`` / ``uvmsmart``, which have no
    policy/prefetch axis). ``extra_cells`` appends arbitrary cells."""

    name: str = "experiment"
    workloads: tuple[WorkloadSpec, ...] = ()
    strategy: str = "sim"
    policies: tuple[PolicySpec, ...] = (PolicySpec("lru"),)
    prefetchers: tuple[PrefetchSpec, ...] = (PrefetchSpec("tree"),)
    oversubscriptions: tuple[float, ...] = (1.25,)
    model: ModelSpec | None = None
    seed: int = 0
    extra_cells: tuple[CellSpec, ...] = ()

    def cells(self) -> list[CellSpec]:
        out: list[CellSpec] = []
        for w in self.workloads:
            for os_ in self.oversubscriptions:
                if self.strategy == "sim":
                    out += [
                        CellSpec(w, "sim", pol, pf, os_, None, self.seed)
                        for pol in self.policies for pf in self.prefetchers
                    ]
                else:
                    out.append(CellSpec(
                        w, self.strategy, PolicySpec("learned" if self.strategy == "ours" else "adaptive"),
                        PrefetchSpec("none" if self.strategy == "ours" else "adaptive"),
                        os_, self.model, self.seed,
                    ))
        return out + list(self.extra_cells)

    def __iter__(self) -> Iterator[CellSpec]:
        return iter(self.cells())

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        return cls(
            name=d.get("name", "experiment"),
            workloads=tuple(WorkloadSpec.from_dict(w) for w in d.get("workloads", ())),
            strategy=d.get("strategy", "sim"),
            policies=tuple(PolicySpec.from_dict(p) for p in d.get("policies", ({"name": "lru"},))),
            prefetchers=tuple(PrefetchSpec.from_dict(p) for p in d.get("prefetchers", ({"name": "tree"},))),
            oversubscriptions=tuple(d.get("oversubscriptions", (1.25,))),
            model=ModelSpec.from_dict(d["model"]) if d.get("model") else None,
            seed=d.get("seed", 0),
            extra_cells=tuple(CellSpec.from_dict(c) for c in d.get("extra_cells", ())),
        )


_SPEC_KINDS = {
    cls.__name__: cls
    for cls in (DriftSpec, WorkloadSpec, PolicySpec, PrefetchSpec, TrainSpec,
                PretrainSpec, QosTierSpec, QosSpec, ModelSpec, CellSpec,
                ProtocolSpec, ExperimentSpec)
}


def spec_from_dict(kind: str, d: dict):
    """Reconstruct any spec from (class name, to_dict() payload)."""
    return _SPEC_KINDS[kind].from_dict(d)
