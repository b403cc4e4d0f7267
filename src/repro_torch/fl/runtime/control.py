"""Adaptive server control loop for the async runtime (pure-Python copy of
``repro.fl.runtime.control``, decision for decision; docs/CONTROL.md).

Every knob the async runtime exposes — ``buffer_k``, ``staleness_exponent``,
``max_inflight_cohorts``, the layer-group schedule — is static config by
default, while ``core.telemetry.Timeline`` already records the quantities
the partial-participation literature says a server should react to:
staleness moments, effective participation, occupancy/overlap, per-group
loss progress.  This module closes that loop.

The seam is deliberately small:

* a :class:`ServerController` observes a merge-aligned
  ``core.telemetry.TimelineWindow`` **between merges** and returns a
  :class:`PolicyAdjustment` — the actuators are the in-flight cohort
  target, the FedBuff merge goal K, a layer-group override for the *next*
  server version (``core.schedule.ScheduleIndex.override_group``), the
  dispatch cohort size, and the plan-prefix boost
  (``PlanAssigner.assign(boost=...)``);
* ``runtime/engine.py`` applies the adjustment right after the version bump
  and before the post-merge dispatch, and books a ``"control"`` timeline
  event so every decision is auditable;
* decisions are **virtual-event-only**: a controller sees windowed virtual
  timestamps, staleness counts, and merge losses — never wall-clock, device
  counts, or submesh state — so adaptive runs reproduce event-for-event on
  any machine, exactly like the static runtime.

``FLRunConfig(controller="static")`` — the default — builds *no* controller
(``make_controller`` returns ``None``) and the engine's hot path contains no
control branches at all: static is structurally absent, the same way
``compression="none"`` is, and bit-identical to the pre-controller runtime.

Three concrete controllers compose into the ``"adaptive"`` bundle:

* :class:`AdaptiveInflightController` — hill-climbs
  ``max_inflight_cohorts`` on the windowed occupancy of the configured
  slots: grow while the slots stay busy (overlap keeps paying), shrink when
  they sit idle (the fleet can't feed them).
* :class:`StalenessBufferController` — tracks the windowed discounted
  mixing coefficient ``E[(1+s)^-a]`` and moves the FedBuff goal K to keep
  it above a floor: a larger K means fewer version bumps per flight, hence
  less staleness; with slack it shrinks K back for faster virtual progress.
* :class:`ProgressGroupController` — repeats the just-trained layer group
  while its windowed merge-loss delta keeps improving (bounded consecutive
  repeats), instead of marching the fixed FedPart cycle; FNU rounds always
  follow the schedule.  Composes with per-client plans: the override
  changes the ``RoundSpec`` that ``PlanAssigner.assign`` sees, nothing else.

Two more join the bundle when their knobs are set (the participation axis,
ROADMAP item 4 — docs/CONTROL.md):

* :class:`ParticipationController`
  (``controller_participation_target > 0``) — holds a windowed
  effective-participation target by moving the dispatch cohort size within
  ``controller_cohort_bounds``; under biased cohort selection it tracks the
  inverse-inclusion-probability estimate, i.e. *debiased* coverage.
* :class:`PlanAssignmentController` (``controller_plan_boost_max > 0``,
  non-homogeneous plans) — grows every capacity tier's plan prefix by a
  bounded boost while deep layer groups show stalled windowed
  ``group_progress``, and decays it once they recover.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Protocol, Sequence

from repro_torch.core.schedule import PlanAssigner
from repro_torch.core.telemetry import TimelineWindow

if TYPE_CHECKING:  # engine.py owns the FLRunConfig import cycle
    from repro_torch.fl.server import FLRunConfig

CONTROLLERS = ("static", "adaptive")


@dataclasses.dataclass
class PolicyAdjustment:
    """What a controller wants changed, all fields optional (None = keep).

    ``group_override`` targets the *next* server version (the one the
    triggering merge just advanced to); the engine clamps/validates and
    applies it through ``ScheduleIndex.override_group``.  ``cohort_size``
    re-targets the dispatch cohort (clamped to
    ``controller_cohort_bounds``); ``plan_boost`` extends every capacity
    tier's plan prefix by that many extra groups (clamped to
    ``[0, controller_plan_boost_max]``, ``PlanAssigner.assign``)."""

    max_inflight: int | None = None
    buffer_k: int | None = None
    group_override: int | None = None
    cohort_size: int | None = None
    plan_boost: int | None = None
    note: str = ""

    def __bool__(self) -> bool:
        return (self.max_inflight is not None or self.buffer_k is not None
                or self.group_override is not None
                or self.cohort_size is not None
                or self.plan_boost is not None)

    def merged(self, other: "PolicyAdjustment") -> "PolicyAdjustment":
        """Right-biased field-wise merge (later controllers win)."""
        return PolicyAdjustment(
            max_inflight=(other.max_inflight if other.max_inflight is not None
                          else self.max_inflight),
            buffer_k=(other.buffer_k if other.buffer_k is not None
                      else self.buffer_k),
            group_override=(other.group_override
                            if other.group_override is not None
                            else self.group_override),
            cohort_size=(other.cohort_size if other.cohort_size is not None
                         else self.cohort_size),
            plan_boost=(other.plan_boost if other.plan_boost is not None
                        else self.plan_boost),
            note="; ".join(n for n in (self.note, other.note) if n),
        )


class ServerController(Protocol):
    """The control seam: observe a merge-aligned window, adjust knobs."""

    def observe(self, window: TimelineWindow) -> PolicyAdjustment:
        """Called between merges (after the version bump, before the
        post-merge dispatch) with ``Timeline.window(controller_window)``.
        Must be a pure function of the window plus the controller's own
        state — virtual-event-only, never host state."""
        ...


@dataclasses.dataclass
class AdaptiveInflightController:
    """Hill-climb the in-flight cohort target on windowed slot occupancy.

    ``utilisation = span_seconds / (current * duration)`` measures how busy
    the ``current`` in-flight slots were over the window (1.0 = every slot
    flying the whole time).  Busy slots (>= ``grow_at``) mean overlap is
    paying and another slot likely would too; idle slots (< ``shrink_at``)
    mean the fleet can't feed the ones we have.  One step per observation,
    clamped to ``bounds``."""

    bounds: tuple[int, int]
    current: int
    grow_at: float = 0.6
    shrink_at: float = 0.2

    def __post_init__(self):
        lo, hi = self.bounds
        if not (1 <= lo <= hi):
            raise ValueError(f"inflight bounds must satisfy 1 <= lo <= hi, "
                             f"got {self.bounds}")
        self.current = min(max(self.current, lo), hi)

    def observe(self, window: TimelineWindow) -> PolicyAdjustment:
        lo, hi = self.bounds
        if window.duration <= 0.0:
            return PolicyAdjustment()
        util = window.span_seconds() / (self.current * window.duration)
        if util >= self.grow_at and self.current < hi:
            self.current += 1
            return PolicyAdjustment(
                max_inflight=self.current,
                note=f"inflight->{self.current} (util={util:.2f})")
        if util < self.shrink_at and self.current > lo:
            self.current -= 1
            return PolicyAdjustment(
                max_inflight=self.current,
                note=f"inflight->{self.current} (util={util:.2f})")
        return PolicyAdjustment()


@dataclasses.dataclass
class StalenessBufferController:
    """Keep the windowed discounted mixing coefficient above a floor by
    moving the FedBuff merge goal K.

    The merge mixes the buffered average into the model with coefficient
    ``m = E_w[(1+s)^-a]`` (docs/ASYNC.md); when the window's unweighted
    estimate ``TimelineWindow.discounted_mix(a)`` falls below ``mix_floor``
    the model has stopped moving, so K grows — a bigger buffer commits
    fewer versions per flight, which *lowers* future staleness.  With
    ``slack`` of headroom K shrinks back for faster virtual progress.
    A no-op when ``exponent == 0`` (the discount never bites)."""

    exponent: float
    bounds: tuple[int, int]
    current: int
    mix_floor: float = 0.5
    slack: float = 0.15

    def __post_init__(self):
        lo, hi = self.bounds
        if not (1 <= lo <= hi):
            raise ValueError(f"buffer bounds must satisfy 1 <= lo <= hi, "
                             f"got {self.bounds}")
        self.current = min(max(self.current, lo), hi)

    def observe(self, window: TimelineWindow) -> PolicyAdjustment:
        if self.exponent == 0.0 or not window.of_kind("complete"):
            return PolicyAdjustment()
        lo, hi = self.bounds
        mix = window.discounted_mix(self.exponent)
        if mix < self.mix_floor and self.current < hi:
            self.current += 1
            return PolicyAdjustment(
                buffer_k=self.current,
                note=f"buffer_k->{self.current} (mix={mix:.2f})")
        if mix >= self.mix_floor + self.slack and self.current > lo:
            self.current -= 1
            return PolicyAdjustment(
                buffer_k=self.current,
                note=f"buffer_k->{self.current} (mix={mix:.2f})")
        return PolicyAdjustment()


@dataclasses.dataclass
class ProgressGroupController:
    """Repeat a partial layer group while its merges keep paying off.

    After a merge of group ``g`` (>= 0), the next version repeats ``g``
    when the windowed evidence shows improvement — the group's own
    ``TimelineWindow.group_progress`` delta when the window holds >= 2 of
    its merges, else the last consecutive merge-loss delta — bounded by
    ``max_repeats`` consecutive overrides so the schedule always resumes.
    Full-network merges reset the streak and always follow the schedule."""

    max_repeats: int
    min_delta: float = 0.0
    _streak_group: int = dataclasses.field(default=-1, repr=False)
    _streak: int = dataclasses.field(default=0, repr=False)

    def observe(self, window: TimelineWindow) -> PolicyAdjustment:
        merges = window.of_kind("merge")
        if self.max_repeats <= 0 or len(merges) < 2:
            return PolicyAdjustment()
        last = merges[-1]
        group = int(last.get("group", -1))
        if group < 0:
            self._streak_group, self._streak = -1, 0
            return PolicyAdjustment()
        same = [e for e in merges if int(e.get("group", -1)) == group]
        delta = (window.group_progress()[group] if len(same) >= 2
                 else float(merges[-2]["loss"]) - float(last["loss"]))
        if group != self._streak_group:
            self._streak_group, self._streak = group, 0
        if delta > self.min_delta and self._streak < self.max_repeats:
            self._streak += 1
            return PolicyAdjustment(
                group_override=group,
                note=f"repeat group {group} (delta={delta:.4f})")
        self._streak = 0
        return PolicyAdjustment()


@dataclasses.dataclass
class ParticipationController:
    """Hold a windowed ``effective_participation`` target by moving the
    dispatch cohort size within bounds — the adaptive *participation rate*
    knob (ROADMAP item 4).

    ``TimelineWindow.effective_participation`` is the fraction of the fleet
    that delivered inside the window (Sen et al.'s effective-participation
    rate); under biased cohort selection (``debiased=True``) the
    inverse-inclusion-probability estimate is used instead, so the target
    tracks the *debiased* coverage of the objective rather than raw
    arrivals.  Below ``target`` (with ``slack`` deadband) the cohort grows
    by a quarter step; above it shrinks — larger cohorts raise coverage at
    the price of per-merge staleness, which the buffer/inflight controllers
    then rebalance.  One step per observation, clamped to ``bounds``;
    silent while nothing has been delivered."""

    target: float
    bounds: tuple[int, int]
    current: int
    num_clients: int
    debiased: bool = False
    slack: float = 0.1

    def __post_init__(self):
        lo, hi = self.bounds
        if not (1 <= lo <= hi):
            raise ValueError(f"cohort bounds must satisfy 1 <= lo <= hi, "
                             f"got {self.bounds}")
        if not 0.0 < self.target <= 1.0:
            raise ValueError(f"participation target must be in (0, 1], "
                             f"got {self.target}")
        if self.num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, "
                             f"got {self.num_clients}")
        self.current = min(max(self.current, lo), hi)

    def observe(self, window: TimelineWindow) -> PolicyAdjustment:
        if not window.of_kind("complete"):
            return PolicyAdjustment()
        lo, hi = self.bounds
        ep = window.effective_participation(
            self.num_clients, inverse_probability=self.debiased)
        step = max(1, self.current // 4)
        if ep < self.target * (1.0 - self.slack) and self.current < hi:
            self.current = min(self.current + step, hi)
            return PolicyAdjustment(
                cohort_size=self.current,
                note=f"cohort->{self.current} (ep={ep:.2f})")
        if ep > self.target * (1.0 + self.slack) and self.current > lo:
            self.current = max(self.current - step, lo)
            return PolicyAdjustment(
                cohort_size=self.current,
                note=f"cohort->{self.current} (ep={ep:.2f})")
        return PolicyAdjustment()


@dataclasses.dataclass
class PlanAssignmentController:
    """Shift capacity-tier plan assignment toward stalled layer groups —
    the adaptive *plan assignment* knob (ROADMAP item 4).

    Under a nested/random plan, a tier of capacity ``c`` trains only its
    ``ceil(c*M)``-group prefix, so deep groups see updates from capable
    tiers only.  When the window shows a deep group stalled — merged >= 2
    times with ``group_progress <= min_delta`` while sitting beyond the
    weakest tier's base prefix (``>= min_prefix``, i.e. coverage-limited) —
    the boost grows by one: every tier's prefix extends by one extra group
    (``PlanAssigner.assign(boost=...)``), recruiting more trainers for the
    deep end.  The boost decays back toward 0 once no group is stalled, so
    the fleet returns to its capacity-honest assignment.  Bounded by
    ``max_boost``; observes per-tier delivery shares
    (``TimelineWindow.tier_participation``) purely for its audit note."""

    num_tiers: int
    min_prefix: int
    max_boost: int
    min_delta: float = 0.0
    current: int = 0

    def __post_init__(self):
        if self.num_tiers < 1:
            raise ValueError(f"num_tiers must be >= 1, got {self.num_tiers}")
        if self.max_boost < 0:
            raise ValueError(f"max_boost must be >= 0, got {self.max_boost}")
        self.current = min(max(self.current, 0), self.max_boost)

    def observe(self, window: TimelineWindow) -> PolicyAdjustment:
        if self.max_boost <= 0:
            return PolicyAdjustment()
        counts: dict[int, int] = {}
        for e in window.of_kind("merge"):
            g = int(e.get("group", -1))
            counts[g] = counts.get(g, 0) + 1
        progress = window.group_progress()
        stalled = [g for g, delta in progress.items()
                   if g >= 0 and counts.get(g, 0) >= 2
                   and delta <= self.min_delta]
        deep = [g for g in stalled if g >= self.min_prefix]
        if deep and self.current < self.max_boost:
            self.current += 1
            shares = window.tier_participation(self.num_tiers)
            return PolicyAdjustment(
                plan_boost=self.current,
                note=f"plan_boost->{self.current} (stalled "
                     f"{sorted(deep)}, tiers "
                     f"{[round(s, 2) for s in shares]})")
        if not stalled and self.current > 0:
            self.current -= 1
            return PolicyAdjustment(
                plan_boost=self.current,
                note=f"plan_boost->{self.current} (recovered)")
        return PolicyAdjustment()


@dataclasses.dataclass
class CompositeController:
    """Run sub-controllers in order; their (disjoint) adjustments merge."""

    parts: Sequence[ServerController]

    def observe(self, window: TimelineWindow) -> PolicyAdjustment:
        adj = PolicyAdjustment()
        for part in self.parts:
            adj = adj.merged(part.observe(window))
        return adj


def make_controller(run_cfg: "FLRunConfig", *, num_clients: int = 0,
                    num_groups: int = 0,
                    cohort_size: int = 0) -> ServerController | None:
    """Build the configured controller, or ``None`` for ``"static"``.

    ``None`` is the structural-absence contract: the engine installs no
    observation hook at all, so the default config cannot perturb the
    static trajectories (pinned in tests/test_async_runtime.py).

    The adaptive bundle always carries the three base controllers; the two
    participation knobs join only when their configs turn them on:
    :class:`ParticipationController` with
    ``controller_participation_target > 0`` (needs ``num_clients``, which
    the engine passes), :class:`PlanAssignmentController` with
    ``controller_plan_boost_max > 0`` under a non-homogeneous plan (needs
    ``num_groups``).  ``cohort_size`` seeds the participation controller's
    starting point (the engine passes its resolved dispatch target)."""
    if run_cfg.controller == "static":
        return None
    if run_cfg.controller != "adaptive":
        raise ValueError(f"unknown controller {run_cfg.controller!r}; "
                         f"expected one of {CONTROLLERS}")
    if run_cfg.controller_window < 1:
        raise ValueError("controller_window must be >= 1, got "
                         f"{run_cfg.controller_window}")
    inflight_lo, inflight_hi = run_cfg.controller_inflight_bounds
    start = min(max(run_cfg.max_inflight_cohorts, inflight_lo), inflight_hi)
    buf_lo, buf_hi = run_cfg.controller_buffer_bounds
    parts: list[ServerController] = [
        AdaptiveInflightController(
            bounds=(inflight_lo, inflight_hi), current=start),
        StalenessBufferController(
            exponent=run_cfg.staleness_exponent,
            bounds=(buf_lo, buf_hi),
            current=run_cfg.buffer_k if run_cfg.buffer_k > 0 else buf_lo,
            mix_floor=run_cfg.controller_mix_floor),
        ProgressGroupController(max_repeats=run_cfg.controller_max_repeats),
    ]
    if run_cfg.controller_participation_target > 0.0:
        if num_clients < 1:
            raise ValueError(
                "controller_participation_target > 0 needs num_clients — "
                "the engine passes the fleet size")
        c_lo, c_hi = run_cfg.controller_cohort_bounds
        parts.append(ParticipationController(
            target=run_cfg.controller_participation_target,
            bounds=(c_lo, c_hi),
            current=cohort_size if cohort_size > 0 else c_lo,
            num_clients=num_clients,
            debiased=run_cfg.participation_sampling == "biased"))
    if (run_cfg.controller_plan_boost_max > 0
            and run_cfg.plan != "homogeneous" and num_groups >= 1):
        assigner = PlanAssigner(
            num_groups=num_groups, kind=run_cfg.plan,
            capacity_tiers=tuple(run_cfg.capacity_tiers), seed=run_cfg.seed)
        min_prefix = min(assigner.prefix_len(ci)
                         for ci in range(len(assigner.capacity_tiers)))
        parts.append(PlanAssignmentController(
            num_tiers=len(assigner.capacity_tiers), min_prefix=min_prefix,
            max_boost=run_cfg.controller_plan_boost_max))
    return CompositeController(parts=tuple(parts))
