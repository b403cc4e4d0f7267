"""Client-simulation engines (port of ``repro.fl.batched``: the sequential
oracle).

``SequentialEngine`` trains the round's clients one at a time through
``LocalTrainer`` and aggregates on the device: the full tree on FNU rounds,
the trainable group's subtree on partial rounds, BN running moments never.
The batched engines (``vmap``, ``shard_map``) and heterogeneous per-client
layer plans are not ported yet and are refused loudly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import aggregation, masking
from repro_torch.core.partition import Partition
from repro_torch.core.schedule import RoundSpec, round_base_mask
from repro_torch.data.pipeline import ClientDataset
from repro_torch.fl.algorithms import AlgoConfig
from repro_torch.fl.client import LocalTrainer
from repro_torch.optim.partial import guard_fused_config
from repro_torch.tree import PyTree

ENGINES = ("sequential",)


def resolve_plan(plan, spec: RoundSpec, num_groups: int):
    """Normalise a per-client layer plan (``core.schedule.PlanAssigner``):
    ``None`` when no plan was given or every row equals the round's
    homogeneous mask, else the validated ``(clients, M)`` bool array."""
    if plan is None:
        return None
    p = np.asarray(plan, dtype=bool)
    if p.ndim != 2 or p.shape[1] != num_groups:
        raise ValueError(
            f"plan shape {p.shape} does not match {num_groups} layer groups")
    if not p.any(axis=1).all():
        raise ValueError("every client's plan must train at least one group")
    if (p == round_base_mask(spec, num_groups)[None, :]).all():
        return None
    return p


@dataclasses.dataclass
class SequentialEngine:
    """Reference oracle: one client at a time, aggregation after the loop."""

    trainer: LocalTrainer
    partition: Partition
    algo: AlgoConfig
    fused_adam: bool = False
    name: str = "sequential"

    def __post_init__(self):
        if self.fused_adam:
            guard_fused_config(self.trainer.adam)

    def run_round(
        self,
        params: PyTree,
        spec: RoundSpec,
        datasets: Sequence[ClientDataset],
        *,
        seeds: Sequence[int],
        weights: Sequence[float],
        epochs: int,
        batch_size: int,
        prev_params: Sequence[PyTree | None] | None = None,
        plan=None,
    ) -> tuple[PyTree, list[float], list[PyTree] | None]:
        if resolve_plan(plan, spec, self.partition.num_groups) is not None:
            raise NotImplementedError(
                "heterogeneous per-client layer plans need the plan paths "
                "(aggregate_plan, plan steps), not ported yet (ROADMAP "
                "Queue 1 item 9)")
        keep_locals = self.algo.name == "moon"
        uploads, losses, new_locals = [], [], ([] if keep_locals else None)
        for i, (ds, seed) in enumerate(zip(datasets, seeds)):
            local, loss = self.trainer.run_local_round(
                params, spec.group, ds, epochs=epochs, batch_size=batch_size,
                seed=seed,
                prev_params=prev_params[i] if prev_params is not None else None,
                fused=self.fused_adam)
            losses.append(loss)
            if keep_locals:
                new_locals.append(local)     # MOON keeps the TRUE local model
            uploads.append(local if spec.is_full
                           else masking.select(local, self.partition, spec.group))
        if spec.is_full:
            new_params = aggregation.aggregate_full(params, uploads, weights)
        else:
            new_params = aggregation.aggregate_partial(params, uploads, weights)
        return new_params, losses, new_locals


def make_engine(name: str, *, trainer: LocalTrainer, partition: Partition,
                algo: AlgoConfig, fused_adam: bool = False) -> SequentialEngine:
    """Build a client-simulation engine by name (``"sequential"`` only)."""
    if name == "sequential":
        return SequentialEngine(trainer=trainer, partition=partition,
                                algo=algo, fused_adam=fused_adam)
    if name in ("vmap", "shard_map"):
        raise NotImplementedError(
            f"engine={name!r} is not ported yet (ROADMAP Queue 1 item "
            f"{9 if name == 'vmap' else 13}); use engine='sequential'")
    raise ValueError(f"unknown engine {name!r}; expected one of {ENGINES}")
