"""Trainable-layer selection schedules (paper §3.2, Fig. 3).

A numpy-only copy of ``repro.core.schedule`` (the whole module), value-
identical: the port's server loop and cost books iterate the same
``RoundSpec`` lists as the reference.

The FedPart training run is a sequence of communication rounds; each round is
either a full-network-update (FNU) round or a partial round training exactly
one layer group.  The canonical schedule is::

    [warm-up FNU x W] then C cycles of:
        for group in order(1..M): [partial(group) x R/L]
        [bridge FNU x B]            # paper inserts 5 between cycles

Bridges only separate cycles, so a run has ``W + C*M*(R/L) + (C-1)*B``
rounds (``total_rounds``).  Orders: ``sequential`` (shallow->deep, the
default), ``reverse``, ``random`` (reshuffled every cycle) — Table 7's three
variants.

Example — the paper's default shape at toy scale::

    >>> sched = FedPartSchedule(num_groups=3, warmup_rounds=1,
    ...                         rounds_per_layer=2, cycles=2, bridge_rounds=1)
    >>> [(r.phase, r.group) for r in sched.rounds()[:4]]
    [('warmup', -1), ('partial', 0), ('partial', 0), ('partial', 1)]
    >>> sched.total_rounds == 1 + 2 * 3 * 2 + 1 * 1
    True

Every consumer — ``fl.server.run_federated``, the mesh trainer in
``launch.fedtrain``, the cost ledger in ``core.costs`` — iterates the same
``RoundSpec`` list, so schedule semantics live in exactly one place (see
docs/ARCHITECTURE.md).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Literal, Sequence

import numpy as np

Phase = Literal["warmup", "partial", "bridge"]
Order = Literal["sequential", "reverse", "random"]

FULL_NETWORK = -1  # sentinel group id meaning "all groups trainable"


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    """What round ``index`` trains: one group, or the full network."""

    index: int
    phase: Phase
    cycle: int            # -1 during warm-up
    group: int            # FULL_NETWORK for FNU rounds

    @property
    def is_full(self) -> bool:
        return self.group == FULL_NETWORK


@dataclasses.dataclass(frozen=True)
class FedPartSchedule:
    """Round-by-round plan for a FedPart run.

    Degenerate corners are well-defined: ``cycles=0`` yields only the warm-up
    (no partial rounds, no bridges), ``warmup_rounds=0`` starts partial
    immediately, and ``order="random"`` is deterministic under a fixed
    ``seed`` (one fresh permutation per cycle from a single generator).

    >>> FedPartSchedule(num_groups=4, warmup_rounds=2, cycles=0).total_rounds
    2
    >>> s = FedPartSchedule(num_groups=3, warmup_rounds=0, rounds_per_layer=1)
    >>> [r.group for r in s.rounds()]
    [0, 1, 2]
    """

    num_groups: int
    warmup_rounds: int = 5
    rounds_per_layer: int = 2          # "R/L" in the paper (2 R/L default)
    cycles: int = 1                    # "C" in the paper's tables
    bridge_rounds: int = 5             # FNU rounds inserted between cycles
    order: Order = "sequential"
    seed: int = 0

    def rounds(self) -> list[RoundSpec]:
        """Materialise the full ``RoundSpec`` list, indices 0..total-1."""
        rng = np.random.default_rng(self.seed)
        specs: list[RoundSpec] = []
        idx = 0
        for _ in range(self.warmup_rounds):
            specs.append(RoundSpec(idx, "warmup", -1, FULL_NETWORK))
            idx += 1
        for c in range(self.cycles):
            groups = self._cycle_order(c, rng)
            for g in groups:
                for _ in range(self.rounds_per_layer):
                    specs.append(RoundSpec(idx, "partial", c, int(g)))
                    idx += 1
            if c != self.cycles - 1:
                for _ in range(self.bridge_rounds):
                    specs.append(RoundSpec(idx, "bridge", c, FULL_NETWORK))
                    idx += 1
        return specs

    def _cycle_order(self, cycle: int, rng: np.random.Generator) -> Sequence[int]:
        base = np.arange(self.num_groups)
        if self.order == "sequential":
            return base
        if self.order == "reverse":
            return base[::-1]
        if self.order == "random":
            return rng.permutation(base)
        raise ValueError(f"unknown order {self.order!r}")

    def __iter__(self) -> Iterator[RoundSpec]:
        return iter(self.rounds())

    @property
    def total_rounds(self) -> int:
        """``W + C*M*(R/L) + (C-1)*B`` — the paper's round budget with
        bridges only *between* cycles (none after the last)."""
        per_cycle = self.num_groups * self.rounds_per_layer
        bridges = self.bridge_rounds * max(self.cycles - 1, 0)
        return self.warmup_rounds + self.cycles * per_cycle + bridges


@dataclasses.dataclass(frozen=True)
class ScheduleIndex:
    """``RoundSpec``-by-*server-version* lookup for asynchronous runtimes.

    Synchronous training identifies "round" with "position in the schedule";
    an asynchronous server does not — client completions arrive continuously
    and the schedule must advance on **server aggregations** (version bumps),
    never on client completions.  ``ScheduleIndex`` makes that rule
    well-defined: version ``v`` (the number of aggregations the server has
    committed) maps to ``specs[v]``, and dispatches issued while the server
    sits at version ``v`` train the group of ``specs[v]`` regardless of how
    many stale cohorts are still in flight.  Versions past the end clamp to
    the final spec so late dispatches (drained after the last planned
    aggregation) stay well-defined.

    A server controller (docs/CONTROL.md) may *override* the group a future
    version trains (``override_group``): the override keeps the base spec's
    ``index`` — so eval cadence and history numbering are untouched — and
    only redirects which subtree the version's dispatches train.  With no
    overrides registered, lookups are exactly the static schedule.

    >>> idx = ScheduleIndex.from_rounds(
    ...     FedPartSchedule(num_groups=2, warmup_rounds=1,
    ...                     rounds_per_layer=1).rounds())
    >>> (idx.for_version(0).phase, idx.for_version(1).group)
    ('warmup', 0)
    >>> idx.for_version(99).group == idx.for_version(len(idx) - 1).group
    True
    >>> idx.staleness(completed_at_version=3, dispatched_at_version=1)
    2
    >>> spec = idx.override_group(2, 0)    # repeat group 0 at version 2
    >>> (idx.for_version(2).group, idx.for_version(2).index)
    (0, 2)
    >>> spec.phase
    'partial'
    """

    specs: tuple[RoundSpec, ...]
    # Controller-installed per-version redirects (version -> spec).  Excluded
    # from eq/hash: two indices over the same schedule stay interchangeable
    # keys regardless of what a controller did to one of them.
    overrides: dict[int, RoundSpec] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @classmethod
    def from_rounds(cls, rounds: Sequence[RoundSpec]) -> "ScheduleIndex":
        specs = tuple(rounds)
        if not specs:
            raise ValueError("ScheduleIndex needs at least one RoundSpec")
        return cls(specs=specs)

    def for_version(self, version: int) -> RoundSpec:
        """The spec governing dispatches while the server is at ``version``."""
        if version < 0:
            raise ValueError(f"server version must be >= 0, got {version}")
        if version in self.overrides:
            return self.overrides[version]
        return self.specs[min(version, len(self.specs) - 1)]

    def override_group(self, version: int, group: int) -> RoundSpec:
        """Pin the layer group trained at ``version`` (controller actuator).

        The override inherits the base spec's ``index`` and ``cycle`` —
        history numbering, eval cadence, and the run's round budget are
        unchanged — and takes ``phase="partial"`` for a real group (or the
        base phase when re-pinning a full-network round).  Returns the
        installed spec."""
        base = self.specs[min(version, len(self.specs) - 1)]
        spec = RoundSpec(index=base.index,
                         phase="partial" if group >= 0 else base.phase,
                         cycle=base.cycle, group=int(group))
        self.overrides[version] = spec
        return spec

    @staticmethod
    def staleness(completed_at_version: int, dispatched_at_version: int) -> int:
        """Server versions the model advanced while the update was in flight."""
        return max(completed_at_version - dispatched_at_version, 0)

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self) -> Iterator[RoundSpec]:
        return iter(self.specs)


PLAN_KINDS = ("homogeneous", "nested", "random")


def round_base_mask(spec: RoundSpec, num_groups: int) -> np.ndarray:
    """The homogeneous round mask for ``spec``: all groups on FNU rounds,
    one-hot ``spec.group`` otherwise.  The single source of truth both for
    ``PlanAssigner.base_mask`` and for the engines' homogeneous-plan
    collapse check (``fl.batched.resolve_plan``)."""
    mask = np.zeros(num_groups, dtype=bool)
    if spec.is_full:
        mask[:] = True
    else:
        mask[spec.group] = True
    return mask


@dataclasses.dataclass(frozen=True)
class PlanAssigner:
    """Capacity tiers -> per-client *layer plans* (heterogeneity axis).

    The base ``FedPartSchedule`` names one group per round for the whole
    cohort.  Real fleets are capacity-heterogeneous (FedPLT, arXiv:2605.02337):
    a phone-class client cannot train the deepest blocks a workstation can.
    ``PlanAssigner`` lifts the round's single ``RoundSpec`` entry into a
    **per-client group bitmask** — ``assign`` returns a ``(clients, M)`` bool
    array saying which layer groups each client trains this round.  Clients
    are mapped onto ``capacity_tiers`` (fractions of the model a tier can
    hold, shallow-first) round-robin by client id, so tier membership is
    stable across rounds and engines.

    Three plan kinds:

    * ``"homogeneous"`` — every client trains exactly the scheduled group
      (all groups on FNU rounds): today's behaviour, tiers ignored.
      ``assign`` returns ``None`` so every consumer can keep its legacy
      (bit-identical) path.
    * ``"nested"`` — FedPLT-style *prefixes*: a tier with capacity ``c``
      owns the shallowest ``ceil(c * M)`` groups.  FNU rounds train the
      whole prefix; a partial round scheduled for group ``g`` trains
      ``min(g, prefix - 1)`` — capable clients follow the schedule, weak
      clients keep refining the deepest group they can hold, and deep groups
      are averaged over only the clients that actually trained them.
    * ``"random"`` — seeded per-(round, client) subsets: each client draws
      ``ceil(c * M)`` distinct groups from its own deterministic stream
      (``seed``, round index, client id), modelling fleets where per-round
      trainability is arbitrary (memory pressure, partial checkpoints).

    Every client always trains at least one group, so dispatches are never
    vacuous; a *group* nobody picked is still well-defined at aggregation
    time (the global stays frozen verbatim — see ``core.aggregation``).

    >>> pa = PlanAssigner(num_groups=4, kind="nested",
    ...                   capacity_tiers=(0.5, 1.0))
    >>> pa.prefix_len(0), pa.prefix_len(1)    # tier 0 -> 2 groups, tier 1 -> 4
    (2, 4)
    >>> plan = pa.assign(RoundSpec(0, "partial", 0, 3), [0, 1])
    >>> plan.astype(int).tolist()             # client 0 clamps 3 -> 1
    [[0, 1, 0, 0], [0, 0, 0, 1]]
    >>> pa.assign(RoundSpec(0, "warmup", -1, FULL_NETWORK),
    ...           [0, 1]).astype(int).tolist()
    [[1, 1, 0, 0], [1, 1, 1, 1]]
    >>> PlanAssigner(num_groups=4).assign(
    ...     RoundSpec(0, "partial", 0, 2), [0, 1]) is None   # homogeneous
    True
    """

    num_groups: int
    kind: str = "homogeneous"
    capacity_tiers: tuple[float, ...] = (1.0,)
    seed: int = 0

    def __post_init__(self):
        if self.kind not in PLAN_KINDS:
            raise ValueError(
                f"unknown plan kind {self.kind!r}; expected one of {PLAN_KINDS}")
        if self.num_groups < 1:
            raise ValueError(f"num_groups must be >= 1, got {self.num_groups}")
        tiers = tuple(float(c) for c in self.capacity_tiers) or (1.0,)
        if any(not (0.0 < c <= 1.0) for c in tiers):
            raise ValueError(
                f"capacity tiers must lie in (0, 1], got {tiers}")
        object.__setattr__(self, "capacity_tiers", tiers)

    # -- tier bookkeeping ---------------------------------------------------

    def tier_of(self, client_id: int) -> int:
        """Stable round-robin tier assignment by client id."""
        return int(client_id) % len(self.capacity_tiers)

    def capacity_of(self, client_id: int) -> float:
        return self.capacity_tiers[self.tier_of(client_id)]

    def prefix_len(self, client_id: int, boost: int = 0) -> int:
        """Groups a client can hold: ``ceil(capacity * M)``, at least 1.

        ``boost`` extends the prefix by that many extra groups (clamped to
        ``M``) — the PlanAssignmentController's actuator (docs/CONTROL.md):
        a positive boost recruits every tier for deeper groups than its
        capacity alone would assign.  0 (the default, and every static run)
        is the capacity-honest assignment, bit-for-bit."""
        c = self.capacity_of(client_id)
        base = max(1, min(self.num_groups, int(np.ceil(c * self.num_groups))))
        if boost:
            base = max(1, min(self.num_groups, base + int(boost)))
        return base

    # -- plan construction --------------------------------------------------

    def base_mask(self, spec: RoundSpec) -> np.ndarray:
        """The homogeneous round mask: all groups on FNU, one-hot otherwise."""
        return round_base_mask(spec, self.num_groups)

    def assign(self, spec: RoundSpec, client_ids: Sequence[int],
               boost: int = 0) -> np.ndarray | None:
        """Per-client plan for ``spec``: ``(len(client_ids), num_groups)``
        bool bitmask, or ``None`` for the homogeneous kind (consumers keep
        their legacy single-group path, bit-for-bit).  ``boost`` extends
        every client's prefix/subset size by that many groups (see
        ``prefix_len``; 0 = capacity-honest, the static default)."""
        if self.kind == "homogeneous":
            return None
        plan = np.zeros((len(client_ids), self.num_groups), dtype=bool)
        if self.kind == "nested":
            for i, ci in enumerate(client_ids):
                pre = self.prefix_len(ci, boost)
                if spec.is_full:
                    plan[i, :pre] = True
                else:
                    plan[i, min(spec.group, pre - 1)] = True
            return plan
        # "random": one deterministic stream per (seed, round, client) so a
        # client's draw is independent of cohort composition and engine.
        for i, ci in enumerate(client_ids):
            k = self.prefix_len(ci, boost)
            rng = np.random.default_rng(
                (self.seed, int(spec.index), int(ci)))
            plan[i, rng.choice(self.num_groups, size=k, replace=False)] = True
        return plan


@dataclasses.dataclass(frozen=True)
class FNUSchedule:
    """Baseline: every round trains the full network (FedAvg et al.)."""

    total: int

    def rounds(self) -> list[RoundSpec]:
        return [RoundSpec(i, "warmup", -1, FULL_NETWORK) for i in range(self.total)]

    def __iter__(self) -> Iterator[RoundSpec]:
        return iter(self.rounds())

    @property
    def total_rounds(self) -> int:
        return self.total


def matched_fnu(schedule: FedPartSchedule) -> FNUSchedule:
    """FNU baseline with the same number of communication rounds."""
    return FNUSchedule(total=schedule.total_rounds)
