"""Training telemetry (port of ``repro.core.telemetry``): update step sizes
(Fig. 1), the async runtime's virtual-clock ``Timeline`` with the windowed
reducers its server controllers observe, and the Monte-Carlo estimate of
the mask-uniformity constant k (Appendix G).

Only ``update_step_size`` and ``estimate_k`` touch tensors; the timeline is
pure host arithmetic on the reference's event dicts, so a port run's
timeline can be held to the reference's event for event.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.partition import Partition
from repro_torch.tree import PyTree, tree_leaves, tree_paths


# ---------------------------------------------------------------------------
# Update step sizes (Fig. 1)
# ---------------------------------------------------------------------------

def update_step_size(prev: PyTree, new: PyTree) -> float:
    """Global L2 norm of the parameter update ||w_{t+1} - w_t||, summed in
    f32 leaf by leaf in tree order (the reference's reduction order)."""
    sq = torch.zeros((), dtype=torch.float32)
    for a, b in zip(tree_leaves(prev), tree_leaves(new)):
        sq = sq + torch.sum((b.float() - a.float()) ** 2).to(sq.device)
    return float(torch.sqrt(sq))


@dataclasses.dataclass
class StepSizeTracker:
    """Records ||dw|| per local iteration plus round-boundary markers.

    Reproduces Fig. 1: under FNU the step size spikes right after each server
    averaging (layer mismatch); under FedPart the spikes shrink.
    """

    sizes: list[float] = dataclasses.field(default_factory=list)
    boundaries: list[int] = dataclasses.field(default_factory=list)

    def record(self, prev: PyTree, new: PyTree) -> None:
        self.sizes.append(update_step_size(prev, new))

    def mark_round_boundary(self) -> None:
        self.boundaries.append(len(self.sizes))

    def post_aggregation_spike(self, window: int = 3) -> float:
        """Mean ratio of step size just after vs. just before each boundary
        (> 1: averaging disturbed the model)."""
        ratios = []
        for b in self.boundaries:
            if b - window < 0 or b + window > len(self.sizes):
                continue
            before = np.mean(self.sizes[b - window : b])
            after = np.mean(self.sizes[b : b + window])
            if before > 0:
                ratios.append(after / before)
        return float(np.mean(ratios)) if ratios else float("nan")


# ---------------------------------------------------------------------------
# Virtual-time timeline (async runtime): time-to-accuracy as first-class output
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Timeline:
    """Event log of a federated run against the *virtual* clock.

    The async runtime (``repro_torch.fl.runtime``) books every dispatch, client
    completion/drop, server merge, and evaluation here with its simulated
    timestamp, so time-to-accuracy curves — the quantity the async literature
    optimises — come out of a run as first-class data instead of being
    re-derived from round counts.

    Events are dicts with at least ``{"t", "kind"}`` where ``t`` is in
    **virtual seconds** (``core.costs.VirtualTimeModel`` units — only ratios
    between configs are meaningful).  Per kind:

    * ``"dispatch"`` — ``{"version", "group", "clients", "t_end"}``: a cohort
      sampled while the server sat at ``version``; ``t_end`` is its last
      member's completion time (the cohort's *span* is ``[t, t_end]``).
    * ``"complete"`` / ``"drop"`` — ``{"client", "comp_flops", ...}``; a
      completion adds ``staleness`` (server versions committed since its
      dispatch) and the delivered ``comm_bytes``; drops burn compute but
      deliver nothing upstream.
    * ``"merge"`` — ``{"version", "group", "loss", "merged",
      "staleness_mean", "staleness_max"}``: server aggregation number
      ``version`` (0-based merge index) committed the buffer; ``group`` is
      the layer group its schedule entry trained (-1 = full network).
    * ``"eval"`` — ``{"version", "acc"}`` on the eval cadence.
    * ``"control"`` — a server controller's knob adjustment
      (docs/CONTROL.md), recorded at the merge that triggered it.
    * ``"wait"`` — ``{"until", "rejected"}``: every sampled candidate was
      unavailable, so the server booked a deterministic retry at ``until``
      instead of training anyone (docs/ASYNC.md).

    >>> tl = Timeline()
    >>> tl.record(0.5, "eval", version=0, acc=0.25)
    >>> tl.record(1.5, "eval", version=1, acc=0.75)
    >>> tl.total_seconds
    1.5
    >>> tl.time_to_accuracy(0.5)
    1.5
    >>> [e["acc"] for e in tl.of_kind("eval")]
    [0.25, 0.75]
    """

    events: list[dict] = dataclasses.field(default_factory=list)

    def record(self, t: float, kind: str, **fields) -> None:
        """Append one event at virtual time ``t`` (events are kept in the
        order they were recorded, which is causal order for the runtime)."""
        self.events.append({"t": float(t), "kind": kind, **fields})

    def of_kind(self, kind: str) -> list[dict]:
        """All events of ``kind``, in recorded (causal) order."""
        return [e for e in self.events if e["kind"] == kind]

    def window(self, last_merges: int = 1) -> "TimelineWindow":
        """The merge-aligned observation window over the last ``last_merges``
        server aggregations — the :class:`TimelineWindow` a
        ``ServerController`` observes between merges (docs/CONTROL.md).

        The window ends at the most recent merge event and reaches back
        ``last_merges`` merges: its events are everything recorded *after*
        the boundary merge (exclusive) through the end of the log, so the
        trailing eval of the final merge is included.  ``t_start`` is the
        boundary merge's timestamp (0.0 when the window spans the whole
        run); ``t_end`` is the final merge's.  With no merges recorded yet
        the window is empty (``t_start == t_end == 0.0``).

        >>> tl = Timeline()
        >>> tl.record(1.0, "merge", version=0, group=0, loss=2.0)
        >>> tl.record(3.0, "merge", version=1, group=1, loss=1.0)
        >>> w = tl.window(1)
        >>> (w.t_start, w.t_end, len(w.events))
        (1.0, 3.0, 1)
        >>> tl.window(5).t_start      # clamps to the start of the run
        0.0
        >>> Timeline().window().duration
        0.0
        """
        if last_merges < 1:
            raise ValueError(f"last_merges must be >= 1, got {last_merges}")
        pos = [i for i, e in enumerate(self.events) if e["kind"] == "merge"]
        if not pos:
            return TimelineWindow(t_start=0.0, t_end=0.0, events=[])
        t_end = self.events[pos[-1]]["t"]
        if len(pos) > last_merges:
            boundary = pos[-1 - last_merges]
            return TimelineWindow(t_start=self.events[boundary]["t"],
                                  t_end=t_end,
                                  events=self.events[boundary + 1:])
        return TimelineWindow(t_start=0.0, t_end=t_end,
                              events=list(self.events))

    @property
    def total_seconds(self) -> float:
        return max((e["t"] for e in self.events), default=0.0)

    @property
    def delivered_comm_bytes(self) -> int:
        """Upstream bytes of updates that actually reached the server."""
        return int(sum(e.get("comm_bytes", 0) for e in self.of_kind("complete")))

    @property
    def spent_comp_flops(self) -> float:
        """Local-training FLOPs spent, including dropped clients' wasted work."""
        return float(sum(e.get("comp_flops", 0.0)
                         for e in self.of_kind("complete") + self.of_kind("drop")))

    def cohort_spans(self) -> list[tuple[int, float, float]]:
        """``(submesh, dispatch_t, last_completion_t)`` per dispatched cohort
        (host-parallel runtime: dispatch events carry their submesh binding
        and booked span; ``-1`` = unbound)."""
        return [(int(e.get("submesh", -1)), e["t"], e["t_end"])
                for e in self.of_kind("dispatch") if "t_end" in e]

    def overlap_seconds(self) -> float:
        """Virtual time with >=2 cohorts concurrently in flight — the
        quantity ``max_inflight_cohorts > 1`` exists to create."""
        from repro_torch.core.costs import overlap_of_spans

        return overlap_of_spans([(s, e) for _, s, e in self.cohort_spans()])

    def accuracy_curve(self) -> list[tuple[float, float]]:
        """``(virtual_seconds, accuracy)`` per evaluation, time-ordered."""
        return [(e["t"], e["acc"]) for e in sorted(self.of_kind("eval"),
                                                   key=lambda e: e["t"])]

    def time_to_accuracy(self, threshold: float) -> float:
        """First virtual time the eval accuracy reaches ``threshold``
        (``inf`` if it never does) — the sweep metric in async_bench."""
        for t, acc in self.accuracy_curve():
            if acc >= threshold:
                return t
        return float("inf")


@dataclasses.dataclass
class TimelineWindow:
    """A merge-aligned slice of a :class:`Timeline` with the windowed
    reducers a server controller observes (docs/CONTROL.md).

    Built by :meth:`Timeline.window`.  ``t_start`` / ``t_end`` are virtual
    seconds (the boundary merge's and final merge's timestamps); ``events``
    are the raw event dicts recorded after the boundary merge.  All reducers
    are pure functions of ``events`` — virtual-event-only, so anything
    decided from them is host- and device-count independent.

    >>> tl = Timeline()
    >>> tl.record(0.0, "dispatch", version=0, group=0, clients=[0, 1],
    ...           t_end=2.0)
    >>> tl.record(1.0, "complete", client=0, staleness=0, comm_bytes=8,
    ...           comp_flops=4.0)
    >>> tl.record(2.0, "complete", client=1, staleness=2, comm_bytes=8,
    ...           comp_flops=4.0)
    >>> tl.record(2.0, "merge", version=0, group=0, loss=2.0)
    >>> w = tl.window()
    >>> w.duration
    2.0
    >>> w.staleness_moments()
    (1.0, 2.0)
    >>> w.effective_participation(4)
    0.5
    >>> w.span_seconds()
    2.0
    """

    t_start: float
    t_end: float
    events: list[dict]

    def of_kind(self, kind: str) -> list[dict]:
        return [e for e in self.events if e["kind"] == kind]

    @property
    def duration(self) -> float:
        """Window length in virtual seconds (0.0 for an empty window)."""
        return max(self.t_end - self.t_start, 0.0)

    @property
    def merges(self) -> int:
        """Server aggregations inside the window (<= the requested span)."""
        return len(self.of_kind("merge"))

    def staleness_moments(self) -> tuple[float, float]:
        """First and second moments ``(E[s], E[s^2])`` of the staleness of
        the window's delivered updates — the quantities the
        partial-participation convergence bounds track.  ``(0.0, 0.0)``
        when nothing was delivered.

        >>> TimelineWindow(0.0, 0.0, []).staleness_moments()
        (0.0, 0.0)
        """
        s = [float(e.get("staleness", 0)) for e in self.of_kind("complete")]
        if not s:
            return (0.0, 0.0)
        return (float(np.mean(s)), float(np.mean(np.square(s))))

    def discounted_mix(self, exponent: float) -> float:
        """Mean polynomial staleness discount ``E[(1+s)^-a]`` over the
        window's deliveries — an unweighted estimate of the merge's mixing
        coefficient ``m`` (docs/ASYNC.md).  1.0 when nothing was delivered
        (no evidence the discount is biting) or when ``exponent == 0``.

        >>> w = TimelineWindow(0.0, 1.0, [
        ...     {"t": 0.5, "kind": "complete", "client": 0, "staleness": 0},
        ...     {"t": 1.0, "kind": "complete", "client": 1, "staleness": 3},
        ... ])
        >>> w.discounted_mix(1.0)
        0.625
        >>> w.discounted_mix(0.0)
        1.0
        """
        if exponent == 0.0:
            return 1.0
        s = [float(e.get("staleness", 0)) for e in self.of_kind("complete")]
        if not s:
            return 1.0
        return float(np.mean([(1.0 + x) ** (-exponent) for x in s]))

    def effective_participation(self, num_clients: int, *,
                                inverse_probability: bool = False) -> float:
        """Fraction of the fleet that *delivered* an update inside the
        window — distinct completing clients over ``num_clients`` (the
        effective-participation rate of Sen et al.).  Drops don't count.

        With ``inverse_probability=True`` each distinct client counts
        ``1 / inclusion_prob`` (its complete events' recorded inclusion
        probability, 1.0 when absent) — the Horvitz–Thompson estimate of
        the fleet coverage an availability-*biased* cohort sampler is
        achieving (docs/ASYNC.md): a delivered low-duty client stands in
        for the rarely-on slice of the fleet it was sampled from.  Clipped
        to 1.0; identical to the plain rate when every prob is 1.0.

        >>> w = TimelineWindow(0.0, 1.0, [
        ...     {"t": 0.5, "kind": "complete", "client": 0,
        ...      "inclusion_prob": 0.25},
        ...     {"t": 1.0, "kind": "complete", "client": 1,
        ...      "inclusion_prob": 1.0},
        ... ])
        >>> w.effective_participation(8)
        0.25
        >>> w.effective_participation(8, inverse_probability=True)
        0.625
        """
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        seen: dict[int, float] = {}
        for e in self.of_kind("complete"):
            seen[e["client"]] = float(e.get("inclusion_prob", 1.0))
        if not inverse_probability:
            return len(seen) / num_clients
        est = sum(1.0 / max(p, 1.0 / num_clients) for p in seen.values())
        return min(est / num_clients, 1.0)

    def inclusion_moments(self) -> tuple[float, float]:
        """``(mean, min)`` of the inclusion probabilities recorded on the
        window's deliveries (``(1.0, 1.0)`` when nothing was delivered or
        nothing recorded one) — how skewed the arrivals the merge had to
        debias actually were.

        >>> TimelineWindow(0.0, 0.0, []).inclusion_moments()
        (1.0, 1.0)
        """
        probs = [float(e.get("inclusion_prob", 1.0))
                 for e in self.of_kind("complete")]
        if not probs:
            return (1.0, 1.0)
        return (float(np.mean(probs)), float(min(probs)))

    def tier_participation(self, num_tiers: int) -> list[float]:
        """Per capacity tier, the share of the window's deliveries that
        came from that tier (``tier`` on complete events; falls back to
        ``client % num_tiers``, the ``PlanAssigner.tier_of`` convention).
        All zeros when nothing was delivered — the plan-assignment
        controller's per-tier coverage signal.

        >>> w = TimelineWindow(0.0, 1.0, [
        ...     {"t": 0.5, "kind": "complete", "client": 0, "tier": 0},
        ...     {"t": 0.7, "kind": "complete", "client": 1, "tier": 1},
        ...     {"t": 1.0, "kind": "complete", "client": 2, "tier": 0},
        ... ])
        >>> w.tier_participation(2)
        [0.6666666666666666, 0.3333333333333333]
        """
        if num_tiers < 1:
            raise ValueError(f"num_tiers must be >= 1, got {num_tiers}")
        counts = [0] * num_tiers
        total = 0
        for e in self.of_kind("complete"):
            tier = int(e.get("tier", int(e.get("client", 0)) % num_tiers))
            counts[tier % num_tiers] += 1
            total += 1
        if total == 0:
            return [0.0] * num_tiers
        return [c / total for c in counts]

    def _spans(self) -> list[tuple[float, float]]:
        """Cohort spans dispatched inside the window, clipped to it."""
        spans = []
        for e in self.of_kind("dispatch"):
            if "t_end" not in e:
                continue
            s, t = max(e["t"], self.t_start), min(e["t_end"], self.t_end)
            if t > s:
                spans.append((s, t))
        return spans

    def span_seconds(self) -> float:
        """Total in-window flight seconds of the window's cohorts (each
        dispatch's ``[t, t_end]`` span clipped to the window, summed).
        Divided by ``max_inflight * duration`` this is the occupancy of the
        configured in-flight slots — the adaptive-inflight controller's
        utilisation signal."""
        return float(sum(t - s for s, t in self._spans()))

    def overlap_seconds(self) -> float:
        """Virtual seconds with >= 2 of the window's cohorts concurrently in
        flight (clipped to the window) — the windowed form of
        :meth:`Timeline.overlap_seconds`."""
        from repro_torch.core.costs import overlap_of_spans

        return overlap_of_spans(self._spans())

    def group_progress(self) -> dict[int, float]:
        """Per layer group, the windowed merge-loss improvement: first minus
        last merge loss for that group (positive = the group's merges are
        still paying off; 0.0 for a group merged once).  Keys are the merge
        events' ``group`` fields (-1 = full network).

        >>> w = TimelineWindow(0.0, 3.0, [
        ...     {"t": 1.0, "kind": "merge", "version": 0, "group": 2,
        ...      "loss": 2.0},
        ...     {"t": 2.0, "kind": "merge", "version": 1, "group": 2,
        ...      "loss": 1.5},
        ...     {"t": 3.0, "kind": "merge", "version": 2, "group": -1,
        ...      "loss": 1.4},
        ... ])
        >>> w.group_progress()
        {2: 0.5, -1: 0.0}
        """
        losses: dict[int, list[float]] = {}
        for e in self.of_kind("merge"):
            losses.setdefault(int(e.get("group", -1)), []).append(
                float(e["loss"]))
        return {g: ls[0] - ls[-1] for g, ls in losses.items()}


# ---------------------------------------------------------------------------
# Monte-Carlo estimate of k (Assumption 3 / Appendix G)
# ---------------------------------------------------------------------------

def estimate_k(
    per_sample_grads: Sequence[PyTree],
    partition: Partition,
    params_template: PyTree,
    *,
    masks: str = "random",
    num_masks: int = 32,
    seed: int = 0,
) -> float:
    """k = max_S E||S*(g - g_bar)|| / min_S E||S*(g - g_bar)|| (Assumption 3).

    ``masks="random"``: random masks of density 1/M over the flat parameter
    vector (the paper's Monte-Carlo setting); ``masks="groups"``: the
    structured layer-group masks FedPart uses."""
    n = len(per_sample_grads)
    leaves = [tree_leaves(g) for g in per_sample_grads]
    mean_leaves = [sum(x.float() for x in col) / n for col in zip(*leaves)]
    centred_leaves = [[a.float() - b for a, b in zip(ls, mean_leaves)] for ls in leaves]
    m = partition.num_groups

    if masks == "groups":
        paths = [p for p, _ in tree_paths(per_sample_grads[0])]
        norms = np.zeros(m, dtype=np.float64)
        for cl in centred_leaves:
            for gi in range(m):
                sq = torch.zeros((), dtype=torch.float32)
                for p, x in zip(paths, cl):
                    if partition.group_of(p) == gi:
                        sq = sq + torch.sum(x ** 2)
                norms[gi] += float(torch.sqrt(sq))
        norms /= n
        norms = norms[norms > 0]
        return float(norms.max() / norms.min()) if norms.size else float("nan")

    flats = [np.concatenate([x.detach().cpu().numpy().ravel() for x in cl])
             for cl in centred_leaves]
    dim = flats[0].shape[0]
    rng = np.random.default_rng(seed)
    norms = []
    for _ in range(num_masks):
        mask = rng.random(dim) < (1.0 / m)
        norms.append(np.mean([np.linalg.norm(f[mask]) for f in flats]))
    norms = np.asarray(norms)
    norms = norms[norms > 0]
    return float(norms.max() / norms.min()) if norms.size else float("nan")
