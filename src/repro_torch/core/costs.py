"""Communication / computation cost model, paper §3.4 Eq. 5–6 (port of
``repro.core.costs``).

Communication is exact: bytes of the parameters transmitted per round
(upstream, per client — the paper's "Comm." metric), dense f32 or, with a
compression config, the encoded wire format.  Computation uses the
standard fwd/bwd decomposition under two bookkeepings: ``"paper"`` (Eq. 6, a
partial round training group *i* pays full forward plus ``(i+1)/M`` of a full
backward) and ``"truncated"`` (the activation-gradient chain over the suffix
plus group *i*'s weight gradient).  Both books are pure functions of the
schedule and the tree's shapes, so they equal the reference's exactly.

Beside the paper's books: ``plan_step_flops`` (a client training a set of
groups), the masked-Adam step book (``adam_step_bytes`` /
``adam_step_flops``), and the async runtime's virtual clock
(``VirtualTimeModel``) with its occupancy ledger (``SubmeshOccupancy``) and
span helpers.  All pure host arithmetic, float64 as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import compress
from repro_torch.core.partition import Partition, group_param_bytes
from repro_torch.core.schedule import RoundSpec


@dataclasses.dataclass(frozen=True)
class CommReport:
    per_round_bytes: np.ndarray     # upstream bytes per client per round
    total_bytes: int
    fnu_total_bytes: int

    @property
    def ratio_to_fnu(self) -> float:
        return self.total_bytes / max(self.fnu_total_bytes, 1)


def comm_cost(
    params,
    partition: Partition,
    rounds: Sequence[RoundSpec],
    compression=None,
) -> CommReport:
    """Upstream bytes per client per round.

    With ``compression`` (a ``core.compress.CompressionConfig``) the
    per-group bytes are the encoded wire sizes (payload + per-block scales
    + top-k indices, ``compress.group_encoded_bytes``); ``fnu_total_bytes``
    stays the dense-f32 FNU baseline, so ``ratio_to_fnu`` reports the
    combined partial-round x compression saving."""
    group_bytes = group_param_bytes(params, partition)
    fnu_full = int(group_bytes.sum())
    if compression is not None:
        group_bytes = compress.group_encoded_bytes(params, partition, compression)
    full = int(group_bytes.sum())
    per_round = np.array(
        [full if r.is_full else int(group_bytes[r.group]) for r in rounds],
        dtype=np.int64,
    )
    return CommReport(
        per_round_bytes=per_round,
        total_bytes=int(per_round.sum()),
        fnu_total_bytes=fnu_full * len(rounds),
    )


@dataclasses.dataclass(frozen=True)
class CompReport:
    per_round_flops: np.ndarray     # per client per local step, forward+backward
    total_flops: int
    fnu_total_flops: int

    @property
    def ratio_to_fnu(self) -> float:
        return self.total_flops / max(self.fnu_total_flops, 1)


def _norm_group_fwd(partition: Partition, group_fwd_flops: Sequence[float] | None):
    if group_fwd_flops is None:
        return np.ones(partition.num_groups, dtype=np.float64)
    arr = np.asarray(group_fwd_flops, dtype=np.float64)
    if arr.shape != (partition.num_groups,):
        raise ValueError(f"group_fwd_flops shape {arr.shape} != "
                         f"({partition.num_groups},)")
    return arr


def comp_cost(
    partition: Partition,
    rounds: Sequence[RoundSpec],
    group_fwd_flops: Sequence[float] | None = None,
    bwd_fwd_ratio: float = 2.0,
    bookkeeping: str = "truncated",
) -> CompReport:
    """FLOPs per round under the chosen bookkeeping ("paper" or "truncated")."""
    fwd = _norm_group_fwd(partition, group_fwd_flops)
    m = partition.num_groups
    full_fwd = float(fwd.sum())
    full_bwd = bwd_fwd_ratio * full_fwd
    full_round = full_fwd + full_bwd

    def partial_round(g: int) -> float:
        if bookkeeping == "paper":
            frac = (g + 1) / m
            return full_fwd + frac * full_bwd
        if bookkeeping == "truncated":
            act_chain = float(fwd[g:].sum())
            weight_grad = float(fwd[g])
            return full_fwd + act_chain + weight_grad
        raise ValueError(f"unknown bookkeeping {bookkeeping!r}")

    per_round = np.array(
        [full_round if r.is_full else partial_round(r.group) for r in rounds],
        dtype=np.float64,
    )
    return CompReport(
        per_round_flops=per_round,
        total_flops=int(per_round.sum()),
        fnu_total_flops=int(full_round * len(rounds)),
    )


def plan_step_flops(
    partition: Partition,
    groups: Sequence[int],
    group_fwd_flops: Sequence[float] | None = None,
    bwd_fwd_ratio: float = 2.0,
) -> float:
    """Per-step FLOPs of a client training a *set* of groups, truncated
    bookkeeping: full forward, the activation-gradient chain down to the
    shallowest trained group, weight gradients of exactly the trained
    groups.  Every group: the FNU step; ``{g}``: ``comp_cost``'s partial
    round for ``g``."""
    fwd = _norm_group_fwd(partition, group_fwd_flops)
    sel = sorted({int(g) for g in groups})
    if not sel:
        raise ValueError("a plan step needs at least one trained group")
    full_fwd = float(fwd.sum())
    if len(sel) == partition.num_groups:
        return full_fwd + bwd_fwd_ratio * full_fwd
    act_chain = float(fwd[sel[0]:].sum())
    weight_grads = float(fwd[sel].sum())
    return full_fwd + act_chain + weight_grads


# -- the masked-Adam step's traffic book --------------------------------------

F32_BYTES = 4
#: fused kernel: p, g, m, v read and p, m, v written, one pass each
FUSED_ADAM_PASSES = 7
#: unfused element-wise form: m, v, m-hat, v-hat and p each a separate
#: read-modify-write (3 + 3 + 2 + 2 + 4 passes)
UNFUSED_ADAM_PASSES = 14
#: per trained param: 2 EMAs (4), bias corrections (2), sqrt + eps + div (3),
#: lr scale and subtract (2), mask select (1)
ADAM_FLOPS_PER_PARAM = 12


def adam_step_bytes(n_params: int, *, fused: bool,
                    trained_fraction: float = 1.0) -> int:
    """Memory bytes of one masked-Adam step over ``n_params`` f32 params: the
    fused kernel reads every block once and writes back only trained
    blocks; the unfused form reads and writes everything."""
    if not 0.0 <= trained_fraction <= 1.0:
        raise ValueError(f"trained_fraction must be in [0,1], got {trained_fraction}")
    passes = (4.0 + 3.0 * trained_fraction) if fused else float(UNFUSED_ADAM_PASSES)
    return int(F32_BYTES * passes * n_params)


def adam_step_flops(n_params: int, trained_fraction: float = 1.0) -> int:
    """Arithmetic of the same step: trained blocks only."""
    return int(ADAM_FLOPS_PER_PARAM * n_params * trained_fraction)


def fused_adam_traffic_ratio(trained_fraction: float = 1.0) -> float:
    """Unfused / fused bytes: the upper bound on the fused kernel's speed-up
    where the step is memory-bound."""
    return UNFUSED_ADAM_PASSES / (4.0 + 3.0 * trained_fraction)


# -- virtual time (async runtime) ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class VirtualTimeModel:
    """The async runtime's virtual clock: a dispatched client round lasts
    its local compute (scaled by the client's speed) plus the transmitted
    subtree's transfer down and up plus a fixed latency, times the
    dispatch's jitter.  Only ratios between configurations mean anything;
    the defaults put a test-scale round at O(0.1-1) virtual seconds."""

    flops_per_second: float = 1e6
    bytes_per_second: float = 1e6
    base_latency_s: float = 0.0

    def comp_seconds(self, flops: float, speed: float = 1.0) -> float:
        if speed <= 0.0:
            raise ValueError(f"client speed multiplier must be > 0, got {speed}")
        return float(flops) / (self.flops_per_second * speed)

    def comm_seconds(self, nbytes: float) -> float:
        return float(nbytes) / self.bytes_per_second

    def round_seconds(self, flops: float, nbytes: float, *, speed: float = 1.0,
                      jitter: float = 1.0) -> float:
        """One client's dispatch-to-completion duration."""
        if jitter <= 0.0:
            raise ValueError(f"latency jitter multiplier must be > 0, got {jitter}")
        base = (self.comp_seconds(flops, speed) + 2.0 * self.comm_seconds(nbytes)
                + self.base_latency_s)
        return base * jitter

    def occupancy(self) -> "SubmeshOccupancy":
        """A fresh occupancy book for one run."""
        return SubmeshOccupancy()


def overlap_of_spans(spans: Sequence[tuple[float, float]]) -> float:
    """Total time during which >= 2 of the ``(start, end)`` spans are active
    (closes sort before opens at ties, so back-to-back spans do not
    count)."""
    edges: list[tuple[float, int]] = []
    for s, e in spans:
        edges += [(s, 1), (e, -1)]
    edges.sort()
    total, depth, last = 0.0, 0, 0.0
    for t, d in edges:
        if depth >= 2:
            total += t - last
        depth += d
        last = t
    return total


def max_concurrency_of_spans(spans: Sequence[tuple[float, float]]) -> int:
    """Peak number of simultaneously active ``(start, end)`` spans."""
    edges: list[tuple[float, int]] = []
    for s, e in spans:
        edges += [(s, 1), (e, -1)]
    edges.sort()
    depth = peak = 0
    for _, d in edges:
        depth += d
        peak = max(peak, depth)
    return peak


@dataclasses.dataclass
class SubmeshOccupancy:
    """Virtual-time occupancy ledger of the async runtime: per slot
    (``launch.mesh.Submesh`` index; ``-1`` = unbound), the span each cohort
    occupied from dispatch to its last member's completion."""

    spans: list[tuple[int, float, float]] = dataclasses.field(default_factory=list)

    def book(self, submesh: int, start: float, end: float) -> None:
        if end < start:
            raise ValueError(f"occupancy span ends before it starts: [{start}, {end}]")
        self.spans.append((int(submesh), float(start), float(end)))

    def _merged(self, spans) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for s, e in sorted((s, e) for _, s, e in spans):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_seconds(self, submesh: int | None = None) -> float:
        """Union length of the (optionally one slot's) occupied spans."""
        spans = (self.spans if submesh is None
                 else [sp for sp in self.spans if sp[0] == submesh])
        return sum(e - s for s, e in self._merged(spans))

    def overlap_seconds(self) -> float:
        return overlap_of_spans([(s, e) for _, s, e in self.spans])

    def max_concurrency(self) -> int:
        return max_concurrency_of_spans([(s, e) for _, s, e in self.spans])

    def summary(self) -> dict:
        """The roll-up the runtime records as the ``"occupancy"`` event."""
        meshes = sorted({s for s, _, _ in self.spans})
        return {
            "cohorts": len(self.spans),
            "submeshes": len(meshes),
            "busy_seconds": {int(m): self.busy_seconds(m) for m in meshes},
            "overlap_seconds": self.overlap_seconds(),
            "max_concurrency": self.max_concurrency(),
        }


def paper_asymptotic_comp_ratio(bwd_fwd_ratio: float = 2.0) -> float:
    """Eq. 6's closed form: (M·D_f + (M+1)/2·D_b) / (M·(D_f+D_b)) -> 2/3."""
    return (1.0 + bwd_fwd_ratio / 2.0) / (1.0 + bwd_fwd_ratio)


def comm_asymptotic_ratio(num_groups: int) -> float:
    """Eq. 5: partial rounds move 1/M of the FNU bytes (uniform groups)."""
    return 1.0 / num_groups
