"""Client-simulation engines (port of ``repro.fl.batched``): the sequential
oracle and the vmap engine.

* ``SequentialEngine`` trains the round's clients one at a time through
  ``LocalTrainer.run_local_round`` and aggregates on the device: the full
  tree on FNU rounds, the trainable group's subtree on partial rounds, each
  group over its own trainers under a heterogeneous per-client layer plan;
  BN running moments never.
* ``VmapEngine`` stacks each bucket of clients along a leading client axis
  (``data.pipeline.bucket_plans``: one bucket per effective batch width,
  ragged step counts padded at the tail and masked via ``step_valid``) and
  trains the bucket together (``LocalTrainer.run_cohort_round``): per local
  step, one ``torch.func.vmap`` gradient over the clients and, with
  ``fused_adam``, one launch of the cohort masked-Adam kernel for the whole
  bucket.  The round ends in one stacked aggregation
  (``core.aggregation.*_stacked``).

Transmission compression (``core.compress``): an engine built with
``compression=`` (a ``CompressionConfig``; ``None`` = off, the uncompressed
paths untouched) replaces each client's transmitted leaves by
``global + Q(update + residual)`` right before aggregation — the sequential
engine per client, the vmap engine once for the whole cohort's stacked
trees.  Error-feedback residuals are kept per real client id (``run_round``
then needs ``client_ids=``) in the engine's ``ClientStateStore`` under
``"ef"`` (``run_federated`` passes the run's).  MOON keeps the uncompressed
local models.

Beside ``run_round`` (train and aggregate), both engines expose the async
runtime's backend (``fl.runtime``): ``run_local_async`` trains one cohort
against the global params it is given and returns its stacked local models
and its ``(K,)`` losses without aggregating and without syncing the host
(the vmap engine leaves the losses on the device; the runtime reads them
when the cohort resolves); ``run_local`` is its blocking form.
``cohort_pool`` gives the vmap engine's slots for concurrent cohorts
(``launch.mesh.SubmeshPool``, one per visible device), and
``run_local_async(submesh=...)`` places a cohort on its slot's device.
``VmapEngine.run_round`` is ``run_local_async`` plus the aggregation.  No
CUDA streams are used: a cohort's launches go to the current stream of its
slot's device, where ``MaskedAdamCohort`` binds its kernel.

The reference's ``jit`` buffer donation has no counterpart: the port
updates its packed buffers in place and never writes the global params, so
there is nothing to donate.  The shard_map engine (ROADMAP Queue 1 item
13) is not ported and raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import aggregation, compress, masking
from repro_torch.core.partition import Partition
from repro_torch.core.schedule import RoundSpec, round_base_mask
from repro_torch.data.pipeline import ClientDataset, bucket_plans
from repro_torch.fl.algorithms import AlgoConfig
from repro_torch.fl.client import LocalTrainer
from repro_torch.fl.population import ClientStateStore
from repro_torch.launch.mesh import SubmeshPool, visible_devices
from repro_torch.optim.partial import guard_fused_config
from repro_torch.tree import PyTree, tree_leaves, tree_map

ENGINES = ("sequential", "vmap")


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


class _CompressionState:
    """Per-client error-feedback residuals and the compression epilogue
    shared by the engines; inert when ``self.compression is None``.
    Residuals are keyed by the real client id in ``self.state_store``
    (kind ``"ef"``), so error feedback telescopes across rounds whatever
    the cohort."""

    def _require_client_ids(self, client_ids, num: int) -> list[int] | None:
        if self.compression is None:
            return None
        if client_ids is None:
            raise ValueError(
                "compression needs client_ids= on run_round: error-feedback "
                "residuals persist per real client across rounds")
        ids = [int(c) for c in client_ids]
        if len(ids) != num:
            raise ValueError(f"{len(ids)} client_ids for {num} client datasets")
        return ids

    def _residual_for(self, cid: int, params: PyTree) -> PyTree:
        res = self.state_store.get("ef", cid)
        return res if res is not None else compress.init_residual(params)

    def _transmit(self, params: PyTree, local: PyTree, ids: Sequence[int], *,
                  groups=None, plan: np.ndarray | None = None,
                  stacked: bool = False) -> PyTree:
        """The compression epilogue: the tree aggregation consumes in place
        of ``local`` (one client's, or with ``stacked`` the cohort's in
        ``ids`` order), with every client's residual read and written back.
        ``groups`` (``None`` = all) selects the transmitted groups
        structurally; ``plan`` (stacked only) gives each client's
        group bits."""
        if stacked:
            res = masking.stack_trees([self._residual_for(c, params) for c in ids])
        else:
            res = self._residual_for(ids[0], params)
        if plan is None:
            tx, new_res = compress.transmit_tree(
                params, local, res, self.compression, partition=self.partition,
                groups=groups, stacked=stacked)
        else:
            tx, new_res = compress.transmit_tree_plan(
                params, local, res, plan, self.compression,
                partition=self.partition, stacked=stacked)
        if stacked:
            # a copy each, so no client's residual holds the cohort's buffer
            for i, c in enumerate(ids):
                self.state_store.put("ef", c, tree_map(lambda x, i=i: x[i].clone(),
                                                       new_res))
        else:
            self.state_store.put("ef", ids[0], new_res)
        return tx


@dataclasses.dataclass
class SequentialEngine(_CompressionState):
    """Reference oracle: one client at a time, aggregation after the loop."""

    trainer: LocalTrainer
    partition: Partition
    algo: AlgoConfig
    fused_adam: bool = False
    compression: compress.CompressionConfig | None = None
    state_store: ClientStateStore = dataclasses.field(
        default_factory=ClientStateStore)       # EF residuals ("ef")
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
        tracker=None,
        plan=None,
        client_ids: Sequence[int] | None = None,
    ) -> tuple[PyTree, list[float], list[PyTree] | None]:
        """Train the round's clients one at a time and aggregate;
        ``tracker`` (a ``core.telemetry.StepSizeTracker``) records the
        first client's step sizes."""
        plan = resolve_plan(plan, spec, self.partition.num_groups)
        ids = self._require_client_ids(client_ids, len(datasets))
        keep_locals = self.algo.name == "moon"
        uploads, losses, new_locals = [], [], ([] if keep_locals else None)
        for i, (ds, seed) in enumerate(zip(datasets, seeds)):
            groups_i = (tuple(int(g) for g in np.flatnonzero(plan[i]))
                        if plan is not None else None)
            local, loss = self.trainer.run_local_round(
                params, spec.group, ds, epochs=epochs, batch_size=batch_size,
                seed=seed,
                prev_params=prev_params[i] if prev_params is not None else None,
                step_tracker=tracker if i == 0 else None,
                groups=groups_i, fused=self.fused_adam)
            losses.append(loss)
            if keep_locals:
                new_locals.append(local)     # MOON keeps the TRUE local model
            send = local
            if self.compression is not None:
                send = self._transmit(
                    params, local, [ids[i]],
                    groups=(groups_i if plan is not None
                            else None if spec.is_full else (spec.group,)))
            if plan is not None:
                uploads.append(masking.select(send, self.partition, groups_i))
            elif spec.is_full:
                uploads.append(send)
            else:
                uploads.append(masking.select(send, self.partition, spec.group))
        if plan is not None:
            new_params = aggregation.aggregate_plan(params, uploads, self.partition,
                                                    plan, weights)
        elif spec.is_full:
            new_params = aggregation.aggregate_full(params, uploads, weights)
        else:
            new_params = aggregation.aggregate_partial(params, uploads, weights)
        return new_params, losses, new_locals

    def run_local(
        self,
        params: PyTree,
        spec: RoundSpec,
        datasets: Sequence[ClientDataset],
        *,
        seeds: Sequence[int],
        epochs: int,
        batch_size: int,
        prev_params: Sequence[PyTree | None] | None = None,
        plan=None,
    ) -> tuple[PyTree, list[float]]:
        """Cohort training without aggregation: the one-client loop, the
        locals stacked along a leading client axis."""
        plan = resolve_plan(plan, spec, self.partition.num_groups)
        locals_, losses = [], []
        for i, (ds, seed) in enumerate(zip(datasets, seeds)):
            local, loss = self.trainer.run_local_round(
                params, spec.group, ds, epochs=epochs, batch_size=batch_size,
                seed=seed,
                prev_params=prev_params[i] if prev_params is not None else None,
                groups=(tuple(int(g) for g in np.flatnonzero(plan[i]))
                        if plan is not None else None),
                fused=self.fused_adam)
            locals_.append(local)
            losses.append(loss)
        return masking.stack_trees(locals_), losses

    def cohort_pool(self, max_inflight: int, device_type: str = "cuda"):
        """No slots: the one-client loop trains on the params' device (the
        runtime's concurrency stays virtual)."""
        return None

    def run_local_async(
        self,
        params: PyTree,
        spec: RoundSpec,
        datasets: Sequence[ClientDataset],
        *,
        seeds: Sequence[int],
        epochs: int,
        batch_size: int,
        prev_params: Sequence[PyTree | None] | None = None,
        submesh=None,
        plan=None,
    ) -> tuple[PyTree, torch.Tensor]:
        """``run_local`` under the runtime's cohort contract: the losses as a
        ``(K,)`` f32 tensor (on the host: each client's loss is already a
        float here)."""
        if submesh is not None:
            raise ValueError("the sequential engine has no submesh binding")
        stacked, losses = self.run_local(
            params, spec, datasets, seeds=seeds, epochs=epochs,
            batch_size=batch_size, prev_params=prev_params, plan=plan)
        return stacked, torch.tensor(losses, dtype=torch.float32)


@dataclasses.dataclass
class _BatchedEngineBase(_CompressionState):
    """The pad-and-mask local-round plumbing of the stacked engines: bucket
    the round's clients (``_buckets``), gather each bucket's batches on the
    device, stack MOON's previous local models, and put the per-bucket
    outputs back into the round's client order (``_gather_order``)."""

    trainer: LocalTrainer
    partition: Partition
    algo: AlgoConfig
    fused_adam: bool = False
    compression: compress.CompressionConfig | None = None
    state_store: ClientStateStore = dataclasses.field(
        default_factory=ClientStateStore)       # EF residuals ("ef")

    def __post_init__(self):
        if self.fused_adam:
            guard_fused_config(self.trainer.adam)

    def _guard_round(self, weights: Sequence[float], tracker) -> None:
        if tracker is not None:
            raise ValueError(
                "per-step step-size tracking needs engine='sequential' (the "
                f"{self.name} engine never materialises per-step params)")
        # the stacked aggregation does not value-check device weights (that
        # would sync); check the host's here, as tree_mean does for the oracle
        if float(sum(weights)) <= 0.0:
            raise ValueError(
                f"client weights must sum to a positive value, got {sum(weights)}")

    @staticmethod
    def _bucket_gmask(plan: np.ndarray, members: tuple[int, ...]) -> np.ndarray:
        """This bucket's rows of the cohort plan, ``(clients, M)`` bool."""
        return plan[list(members)]

    def _buckets(self, params: PyTree, datasets: Sequence[ClientDataset], *,
                 batch_size: int, epochs: int, seeds: Sequence[int],
                 prev_params: Sequence[PyTree | None] | None, use_prev: bool):
        """Yield ``(members, inputs, labels, step_valid, prev_arg)`` per
        batch-width bucket: ``inputs`` / ``labels`` the ``(clients, steps,
        bs, ...)`` batches gathered on the params' device, ``prev_arg`` the
        stacked MOON previous local models (the global model where a client
        has none) or ``None``."""
        device = tree_leaves(params)[0].device
        for members, plans, valid in bucket_plans(datasets, batch_size, epochs,
                                                  seeds):
            xs, ys = [], []
            for m, plan in zip(members, plans):
                idx = torch.as_tensor(plan, device=device)
                xs.append(torch.as_tensor(datasets[m].inputs, device=device)[idx])
                ys.append(torch.as_tensor(np.asarray(datasets[m].labels, np.int64),
                                          device=device)[idx])
            prev_arg = None
            if use_prev:
                prev_arg = masking.stack_trees([
                    prev_params[m] if prev_params is not None
                    and prev_params[m] is not None else params for m in members])
            yield members, torch.stack(xs), torch.stack(ys), valid, prev_arg

    @staticmethod
    def _gather_order(parts: list[tuple[tuple[int, ...], PyTree, torch.Tensor]],
                      num: int) -> tuple[PyTree, torch.Tensor]:
        """Concatenate per-bucket ``(members, stacked locals, losses)`` back
        into the round's picked-client order."""
        if len(parts) == 1 and parts[0][0] == tuple(range(num)):
            return parts[0][1], parts[0][2]
        order = np.concatenate([np.asarray(m) for m, _, _ in parts])
        inv = torch.as_tensor(np.argsort(order), device=parts[0][2].device)
        stacked = tree_map(lambda *xs: torch.cat(xs, dim=0)[inv],
                           *[t for _, t, _ in parts])
        return stacked, torch.cat([lo for _, _, lo in parts])[inv]

    # -- cohort execution (the async runtime's backend) ----------------------

    def cohort_pool(self, max_inflight: int, device_type: str = "cuda"):
        """Width-1 slots for concurrent cohorts, one per visible device of
        ``device_type`` up to ``max_inflight``; ``None`` for one cohort at a
        time (cohorts then stay on the params' device)."""
        if max_inflight <= 1:
            return None
        num = min(max_inflight, len(visible_devices(device_type)))
        return SubmeshPool(num, devices=num, width=1, device_type=device_type)

    @staticmethod
    def _place_cohort_args(params: PyTree, prev_params, submesh):
        """The cohort's global params and MOON previous models on the slot's
        device (no copy where they already are)."""
        if submesh is None:
            return params, prev_params
        dev = submesh.device
        params = tree_map(lambda a: a.to(dev), params)
        if prev_params is not None:
            prev_params = [None if p is None else tree_map(lambda a: a.to(dev), p)
                           for p in prev_params]
        return params, prev_params

    def run_local_async(
        self,
        params: PyTree,
        spec: RoundSpec,
        datasets: Sequence[ClientDataset],
        *,
        seeds: Sequence[int],
        epochs: int,
        batch_size: int,
        prev_params: Sequence[PyTree | None] | None = None,
        submesh=None,
        plan=None,
    ) -> tuple[PyTree, torch.Tensor]:
        """Train one cohort against ``params`` without aggregating: returns
        ``(stacked locals, (K,) losses)`` in ``datasets`` order, both on the
        device and nothing read back, so the host may launch further
        cohorts first.  ``submesh`` (from ``cohort_pool``) runs the cohort
        on its slot's device."""
        plan = resolve_plan(plan, spec, self.partition.num_groups)
        use_prev = self.algo.name == "moon"
        params, prev_params = self._place_cohort_args(params, prev_params, submesh)
        dev = tree_leaves(params)[0].device
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        parts = []
        with ctx:
            for members, xs, ys, valid, prev_arg in self._buckets(
                    params, datasets, batch_size=batch_size, epochs=epochs,
                    seeds=seeds, prev_params=prev_params, use_prev=use_prev):
                stacked, losses = self.trainer.run_cohort_round(
                    params, xs, ys, valid, group=spec.group,
                    plan_rows=None if plan is None else self._bucket_gmask(plan, members),
                    prev_params=prev_arg, fused=self.fused_adam)
                parts.append((members, stacked, losses))
        return self._gather_order(parts, len(datasets))

    def run_local(
        self,
        params: PyTree,
        spec: RoundSpec,
        datasets: Sequence[ClientDataset],
        *,
        seeds: Sequence[int],
        epochs: int,
        batch_size: int,
        prev_params: Sequence[PyTree | None] | None = None,
        plan=None,
    ) -> tuple[PyTree, list[float]]:
        """Blocking ``run_local_async``: the losses read back as floats."""
        stacked, losses_dev = self.run_local_async(
            params, spec, datasets, seeds=seeds, epochs=epochs,
            batch_size=batch_size, prev_params=prev_params, plan=plan)
        return stacked, losses_dev.tolist()


@dataclasses.dataclass
class VmapEngine(_BatchedEngineBase):
    """Batched engine: each bucket's clients train together (one vmapped
    gradient and, fused, one cohort-kernel launch per local step), then one
    stacked aggregation on the device."""

    name: str = "vmap"

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
        tracker=None,
        plan=None,
        client_ids: Sequence[int] | None = None,
    ) -> tuple[PyTree, list[float], list[PyTree] | None]:
        """``run_local_async`` plus one stacked aggregation on the device;
        the losses are read back here, once per round."""
        self._guard_round(weights, tracker)
        plan = resolve_plan(plan, spec, self.partition.num_groups)
        ids = self._require_client_ids(client_ids, len(datasets))
        use_prev = self.algo.name == "moon"
        num = len(datasets)
        stacked, losses_dev = self.run_local_async(
            params, spec, datasets, seeds=seeds, epochs=epochs,
            batch_size=batch_size, prev_params=prev_params, plan=plan)
        agg_in = stacked                 # MOON keeps the TRUE locals below
        if self.compression is not None:
            agg_in = self._transmit(
                params, stacked, ids, plan=plan, stacked=True,
                groups=None if plan is not None or spec.is_full else (spec.group,))
        if plan is not None:
            new_params = aggregation.aggregate_plan_stacked(
                params, agg_in, self.partition, plan, weights)
        elif spec.is_full:
            new_params = aggregation.aggregate_full_stacked(params, agg_in, weights)
        else:
            new_params = aggregation.aggregate_partial_stacked(
                params, agg_in, self.partition, spec.group, weights)
        # MOON keeps each TRUE local model: a copy, so no client's entry holds
        # the whole bucket's buffer alive
        new_locals = ([tree_map(torch.clone, t) for t in masking.unstack_tree(stacked, num)]
                      if use_prev else None)
        return new_params, losses_dev.tolist(), new_locals


def make_engine(name: str, *, trainer: LocalTrainer, partition: Partition,
                algo: AlgoConfig, fused_adam: bool = False,
                compression: compress.CompressionConfig | None = None,
                state_store: ClientStateStore | None = None):
    """Build a client-simulation engine by name (``"sequential"`` or
    ``"vmap"``); without ``state_store`` it keeps its residuals in an
    unbounded store of its own."""
    kw = dict(trainer=trainer, partition=partition, algo=algo,
              fused_adam=fused_adam, compression=compression,
              state_store=ClientStateStore() if state_store is None else state_store)
    if name == "sequential":
        return SequentialEngine(**kw)
    if name == "vmap":
        return VmapEngine(**kw)
    if name == "shard_map":
        raise NotImplementedError(
            "engine='shard_map' is not ported yet (ROADMAP Queue 1 item 13); "
            "use engine='sequential' or 'vmap'")
    raise ValueError(f"unknown engine {name!r}; expected one of {ENGINES}")
