"""Communication / computation cost model, paper §3.4 Eq. 5–6 (port of
``repro.core.costs``: ``comm_cost`` and ``comp_cost``).

Communication is exact: bytes of the parameters transmitted per round
(upstream, per client — the paper's "Comm." metric), dense f32 or, with a
compression config, the encoded wire format.  Computation uses the
standard fwd/bwd decomposition under two bookkeepings: ``"paper"`` (Eq. 6, a
partial round training group *i* pays full forward plus ``(i+1)/M`` of a full
backward) and ``"truncated"`` (the activation-gradient chain over the suffix
plus group *i*'s weight gradient).  Both books are pure functions of the
schedule and the tree's shapes, so they equal the reference's exactly.
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
