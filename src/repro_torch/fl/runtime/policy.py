"""Server aggregation policies for the async runtime (port of
``repro.fl.runtime.policy``: the same weights, scales and mixing
coefficients, computed in numpy exactly as the reference does; the leaves
mix in f32 and cast back to their dtype).

A policy decides **when** buffered client updates are merged into the global
model and **how much** each one counts.  Two are provided:

* ``SyncFedAvgPolicy`` ("sync") — the oracle: a barrier per cohort.  Merge
  only once nothing is left in flight, i.e. classic synchronous FedAvg
  expressed as an event-driven policy.  With a perfect fleet this reproduces
  ``run_federated``'s synchronous loop exactly (the degenerate-config
  equivalence pinned in tests/test_async_runtime.py).
* ``FedBuffPolicy`` ("fedbuff") — buffered asynchronous aggregation (Nguyen
  et al., FedBuff): merge as soon as ``buffer_goal`` (K) updates have
  arrived, without waiting for stragglers.  Updates dispatched against an
  older server version are discounted by the polynomial staleness weight
  ``(1 + staleness)^(-staleness_exponent)`` (Xie et al., FedAsync's poly
  strategy); exponent 0 recovers plain sample-size weighting.

The FedPart interplay is the part the literature doesn't cover: each update
carries only its dispatch-time *transmitted subtree* (the scheduled layer
group, BN running moments already dropped), and the schedule advances on
server versions, so a buffer can hold updates for **different** layer groups.
``merge`` therefore averages per group and splices each averaged subtree into
the *current* global model — a stale update for group ``g`` merges against
today's frozen context, never against the model it was trained from.  The
averaging path reuses ``core.aggregation`` (``tree_mean_stacked`` + splice),
i.e. exactly the synchronous engines' aggregation arithmetic.

Updates may arrive compressed (``ClientUpdate.encoding``, ``core.compress``):
the runtime decompresses at resolution, so every policy here is agnostic —
staleness scales and merges apply to decompressed values, and the encoded
wire size only matters to the cost books (``comm_bytes``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import aggregation, masking
from repro_torch.core.partition import Partition
from repro_torch.tree import PyTree, tree_map

POLICIES = ("sync", "fedbuff")


@dataclasses.dataclass
class ClientUpdate:
    """One client's delivered contribution, as the server buffer sees it."""

    client_id: int
    version: int            # server version at dispatch (staleness anchor)
    group: int              # layer group trained (FULL_NETWORK on FNU rounds)
    subtree: PyTree         # transmitted subtree, BN running moments dropped
    weight: float           # sample-size weight (len of the client dataset)
    loss: float
    dispatched_t: float     # virtual dispatch time
    completed_t: float = float("nan")
    comp_flops: float = 0.0  # local-training FLOPs this dispatch burned
    comm_bytes: int = 0      # upstream bytes of the transmitted subtree
    # Per-client layer plans: the exact group set this client trained (None
    # = the homogeneous path, where ``group`` alone describes the subtree).
    # The subtree then holds the *union* of the trained groups and the merge
    # splices per (client, group).
    groups: tuple[int, ...] | None = None
    # Transmission compression (core.compress): the wire format this update
    # travelled in ("int8" | "onebit" | "topk"; None = exact).  ``subtree``
    # always holds the *decompressed* server view — the merge and staleness
    # discounting below are value-level and never see codes — while
    # ``comm_bytes`` books the *encoded* size (docs/COMPRESSION.md).
    encoding: str | None = None
    # Availability-biased cohort selection (docs/ASYNC.md): the client's
    # stationary inclusion probability at dispatch.  The merge divides the
    # sample-size weight by it (Horvitz–Thompson,
    # ``core.aggregation.debias_weights``) so skewed arrivals leave the
    # global objective unbiased; 1.0 — the blind sampler's value — is the
    # exact identity, keeping uniform runs bit-for-bit.
    inclusion_prob: float = 1.0

    def staleness(self, current_version: int) -> int:
        return max(current_version - self.version, 0)


@dataclasses.dataclass
class AggregationPolicy:
    """Base: polynomial staleness weighting + per-group splice merging."""

    partition: Partition
    staleness_exponent: float = 0.0
    # K; 0 = whatever the last cohort's size was.  Deliberately a plain
    # mutable field: it is the staleness-aware controller's actuator
    # (runtime.control, docs/CONTROL.md), re-targeted between merges —
    # should_merge always reads the *current* goal.
    buffer_goal: int = 0

    name = "base"

    def staleness_scale(self, staleness: int) -> float:
        """``(1 + s)^(-a)`` — 1.0 for fresh updates, monotone decreasing."""
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        if self.staleness_exponent == 0.0:
            return 1.0
        return float((1.0 + staleness) ** (-self.staleness_exponent))

    def goal(self, cohort_size: int) -> int:
        return self.buffer_goal if self.buffer_goal > 0 else cohort_size

    def should_merge(self, buffered: int, pending: int, cohort_size: int) -> bool:
        """Called after every delivery/drop.  ``pending`` counts updates still
        in flight that *will* be delivered (drops excluded)."""
        raise NotImplementedError

    def merge(
        self,
        global_params: PyTree,
        updates: Sequence[ClientUpdate],
        version: int,
    ) -> tuple[PyTree, dict]:
        """Merge buffered updates into the current global model.

        Updates are grouped by trained layer group (buffer order preserved).
        Per group, staleness enters twice, following FedAsync's polynomial
        strategy generalised to buffers:

        * **within** the buffer, each update's sample-size weight — first
          divided by its ``inclusion_prob`` (Horvitz–Thompson debiasing of
          availability-biased cohorts, ``core.aggregation.debias_weights``;
          exactly the identity at the default 1.0) — is scaled by
          ``(1+s)^-a`` before averaging (staler contributions count less
          against fresher ones);
        * **against** the current model, the averaged subtree is mixed in
          with coefficient ``m = sum(w*scale)/sum(w)`` — the sample-weighted
          mean staleness scale — so a buffer of stale updates moves the
          global model less: ``(1-m)*current + m*averaged``.

        With exponent 0 every scale is exactly 1.0, ``m == 1.0``, and the
        merge reduces to the synchronous splice (the degenerate-config
        equivalence).  The splice always lands on the *current* frozen
        context — a stale group-``g`` update never resurrects the model it
        was trained from.  When a FULL_NETWORK update shares the buffer with
        partial-group updates, the full tree merges **first** and the
        targeted subtrees splice on top, so a partial update is never wiped
        by a later full splice and the result is independent of arrival
        order; each group's mixing context is the progressively-merged
        model, not a pre-merge snapshot.

        Updates carrying a per-client layer plan (``u.groups`` set,
        docs/HETEROGENEITY.md) are unbundled into one contribution per
        **(client, group)**: each trained group's slice of the update's
        subtree joins that group's average with the *update's own* staleness
        scale, so a buffer can mix plan and homogeneous updates for the same
        group and every group's denominator sums exactly the weights of the
        clients that trained it.  Returns ``(new_params, info)`` with the
        merge telemetry (mean loss, staleness stats, per-group counts)."""
        if not updates:
            raise ValueError("merge called with an empty buffer")
        # Contributions per group: FULL_NETWORK (whole-tree) updates first,
        # then partial groups ascending — order-independent, and targeted
        # subtrees win where they overlap the full splice.  (Partial groups
        # are disjoint by construction.)
        by_group: dict[int, list[tuple[ClientUpdate, PyTree]]] = {}
        for u in updates:
            if u.groups is None:
                by_group.setdefault(u.group, []).append((u, u.subtree))
            else:
                for g in u.groups:
                    by_group.setdefault(int(g), []).append(
                        (u, masking.select(u.subtree, self.partition, int(g))))

        params = global_params
        for group in sorted(by_group, key=lambda g: (g >= 0, g)):
            contribs = by_group[group]
            w = np.array([u.weight for u, _ in contribs], dtype=np.float32)
            # Inverse-inclusion-probability debiasing (docs/ASYNC.md): a
            # no-op returning `w` itself when every prob is 1.0 (blind
            # sampling / uniform availability — the bit-exact contract).
            w = aggregation.debias_weights(
                w, np.array([u.inclusion_prob for u, _ in contribs],
                            dtype=np.float64))
            scale = np.array(
                [self.staleness_scale(u.staleness(version))
                 for u, _ in contribs],
                dtype=np.float32,
            )
            if float((w * scale).sum()) <= 0.0:
                raise ValueError(
                    f"group {group} merge weights must sum to a positive value"
                )
            stacked = masking.stack_trees([sub for _, sub in contribs])
            averaged = aggregation.tree_mean_stacked(stacked, w * scale)
            m = float((w * scale).sum() / w.sum())
            if m < 1.0:
                current = aggregation.drop_local_stats(
                    params if group < 0
                    else masking.select(params, self.partition, group))
                averaged = tree_map(
                    lambda c, a: ((1.0 - m) * c.float() + m * a.float()).to(a.dtype),
                    current, averaged)
            params = masking.tree_update(params, averaged)

        stalenesses = [u.staleness(version) for u in updates]
        info = {
            "loss": float(np.mean([u.loss for u in updates])),
            "merged": len(updates),
            "staleness_mean": float(np.mean(stalenesses)),
            "staleness_max": int(max(stalenesses)),
            "groups": {int(g): len(ups) for g, ups in by_group.items()},
        }
        return params, info


@dataclasses.dataclass
class SyncFedAvgPolicy(AggregationPolicy):
    """Barrier per cohort: merge only once nothing deliverable is in flight."""

    name = "sync"

    def should_merge(self, buffered: int, pending: int, cohort_size: int) -> bool:
        return buffered > 0 and pending == 0


@dataclasses.dataclass
class FedBuffPolicy(AggregationPolicy):
    """Buffered async aggregation: merge at K updates, stragglers be damned.

    The ``pending == 0`` clause is the starvation guard: when drops/stragglers
    leave the buffer short of K with nothing in flight, merge what arrived
    rather than deadlock."""

    name = "fedbuff"

    def should_merge(self, buffered: int, pending: int, cohort_size: int) -> bool:
        if buffered <= 0:
            return False
        return buffered >= self.goal(cohort_size) or pending == 0


def make_policy(
    name: str,
    partition: Partition,
    *,
    staleness_exponent: float = 0.0,
    buffer_goal: int = 0,
) -> AggregationPolicy:
    """Build an aggregation policy by name (``"sync"`` | ``"fedbuff"``)."""
    if name == "sync":
        return SyncFedAvgPolicy(partition=partition,
                                staleness_exponent=staleness_exponent,
                                buffer_goal=buffer_goal)
    if name == "fedbuff":
        return FedBuffPolicy(partition=partition,
                             staleness_exponent=staleness_exponent,
                             buffer_goal=buffer_goal)
    raise ValueError(f"unknown policy {name!r}; expected one of {POLICIES}")
