"""Client-simulation engines (port of ``repro.fl.batched``): the sequential
oracle, the vmap engine and the multi-device shard_map engine.

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
* ``ShardMapEngine`` shards each bucket's client axis over the ranks of a
  ``torch.distributed`` client mesh (``launch.mesh.make_client_mesh``; one
  process per device): each rank trains its share as the vmap engine
  does, reduces it to its weighted transmitted update, and one
  ``all_reduce`` per bucket sums the ranks' updates (the reference's
  ``psum``), so only the round's transmitted subtree crosses ranks.

Transmission compression (``core.compress``): an engine built with
``compression=`` (a ``CompressionConfig``; ``None`` = off, the uncompressed
paths untouched) replaces each client's transmitted leaves by
``global + Q(update + residual)`` right before aggregation — the sequential
engine per client, the vmap engine once for the whole cohort's stacked
trees, the shard_map engine once per rank's share, before its all-reduce
(so only compressed values cross ranks).  Error-feedback residuals are
kept per real client id (``run_round`` then needs ``client_ids=``) in the
engine's ``ClientStateStore`` under ``"ef"`` (``run_federated`` passes the
run's).  MOON keeps the uncompressed local models.

Beside ``run_round`` (train and aggregate), every engine exposes the async
runtime's backend (``fl.runtime``): ``run_local_async`` trains one cohort
against the global params it is given and returns its stacked local models
and its ``(K,)`` losses without aggregating and without syncing the host
(the vmap engine leaves the losses on the device; the runtime reads them
when the cohort resolves); ``run_local`` is its blocking form.
``cohort_pool`` gives the vmap engine's slots for concurrent cohorts
(``launch.mesh.SubmeshPool``, one per visible device; the shard_map
engine's ``RankPool``, one per rank), and ``run_local_async(submesh=...)``
places a cohort on its slot.
``VmapEngine.run_round`` is ``run_local_async`` plus the aggregation.  No
CUDA streams are used: a cohort's launches go to the current stream of its
slot's device, where ``MaskedAdamCohort`` binds its kernel.

The reference's ``jit`` buffer donation has no counterpart: the port
updates its packed buffers in place and never writes the global params, so
there is nothing to donate.

Profiler ranges (``torch.profiler.record_function``): ``fl.client``'s
``FL_BATCHES`` around each bucket's batches (closed before the bucket is
yielded), and ``FL_AGGREGATE`` around each engine's transmit, aggregation
and splice into the global params.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import ClassVar, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import aggregation, compress, masking
from repro_torch.core.partition import Partition
from repro_torch.core.schedule import RoundSpec, round_base_mask
from repro_torch.data.pipeline import ClientDataset, bucket_plans
from repro_torch.fl.algorithms import AlgoConfig
from repro_torch.fl.client import FL_BATCHES, FUSED_BLOCK_ROWS, LocalTrainer
from repro_torch.fl.population import ClientStateStore
from repro_torch.kernels.masked_adam import ops as madam_ops
from repro_torch.launch.mesh import (CLIENT_AXIS, RankPool, SubmeshPool,  # noqa: F401
                                     make_client_mesh, visible_devices)
from repro_torch.optim.partial import guard_fused_config
from repro_torch.tree import (PyTree, tree_from_paths, tree_leaves, tree_map,
                              tree_map_with_path, tree_paths)

ENGINES = ("sequential", "vmap", "shard_map")

# profiler label of a round's aggregation
FL_AGGREGATE = "fl.aggregate"     # transmit, FedAvg, the splice into the global params


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
                with record_function(FL_AGGREGATE):
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
        with record_function(FL_AGGREGATE):
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

    def _buckets(self, params: PyTree, datasets: Sequence[ClientDataset], *,
                 batch_size: int, epochs: int, seeds: Sequence[int],
                 prev_params: Sequence[PyTree | None] | None, use_prev: bool,
                 pad_clients_to: int = 1, shard: tuple[int, int] = (0, 1)):
        """Yield ``(members, inputs, labels, step_valid, prev_arg)`` per
        batch-width bucket.  The bucket's client axis is padded to a
        multiple of ``pad_clients_to`` (``data.pipeline.bucket_plans``) and
        ``shard = (rank, ranks)`` keeps the rank's contiguous share of it:
        rows ``rank * n`` to ``(rank + 1) * n`` for ``n`` rows a rank;
        ``members`` are the bucket's real clients.  ``inputs`` / ``labels``
        are the rows' ``(clients, steps, bs, ...)`` batches gathered on the
        params' device, ``prev_arg`` the rows' stacked MOON previous local
        models (the global model for a client with none and for a padding
        client) or ``None``."""
        device = tree_leaves(params)[0].device
        rank, ranks = shard

        def gather(members, plans, valid):
            per = len(plans) // ranks
            rows = range(rank * per, (rank + 1) * per)
            src = [members[r] if r < len(members) else members[0] for r in rows]
            xs, ys = [], []
            for m, r in zip(src, rows):
                idx = torch.as_tensor(plans[r], device=device)
                xs.append(torch.as_tensor(datasets[m].inputs, device=device)[idx])
                ys.append(torch.as_tensor(np.asarray(datasets[m].labels, np.int64),
                                          device=device)[idx])
            prev_arg = None
            if use_prev:
                prev_arg = masking.stack_trees([
                    prev_params[m] if r < len(members) and prev_params is not None
                    and prev_params[m] is not None else params
                    for m, r in zip(src, rows)])
            return (members, torch.stack(xs), torch.stack(ys),
                    valid[rows.start:rows.stop], prev_arg)

        # a range never stays open across a yield; the first bucket's range
        # also holds every bucket's batch plans
        with record_function(FL_BATCHES):
            buckets = bucket_plans(datasets, batch_size, epochs, seeds,
                                   pad_clients_to=pad_clients_to)
            batches = gather(*buckets[0]) if buckets else None
        for i in range(len(buckets)):
            if i:
                with record_function(FL_BATCHES):
                    batches = gather(*buckets[i])
            yield batches

    def _cohort_parts(self, params: PyTree, spec: RoundSpec,
                      datasets: Sequence[ClientDataset], *, seeds: Sequence[int],
                      epochs: int, batch_size: int,
                      prev_params: Sequence[PyTree | None] | None, plan,
                      pad_clients_to: int = 1, shard: tuple[int, int] = (0, 1)):
        """Train each bucket's ``rows`` together (``LocalTrainer.
        run_cohort_round``: fused, one cohort-kernel launch per local step);
        yields ``(members, rows, stacked locals, losses)`` per bucket, the
        outputs over ``rows`` (``plan`` already resolved; a padding row's
        plan trains nothing)."""
        use_prev = self.algo.name == "moon"
        dev = tree_leaves(params)[0].device
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            for members, xs, ys, valid, prev_arg in self._buckets(
                    params, datasets, batch_size=batch_size, epochs=epochs,
                    seeds=seeds, prev_params=prev_params, use_prev=use_prev,
                    pad_clients_to=pad_clients_to, shard=shard):
                rows = range(shard[0] * len(xs), (shard[0] + 1) * len(xs))
                gm = None
                if plan is not None:
                    gm = np.zeros((len(rows), plan.shape[1]), dtype=bool)
                    real = [r for r in rows if r < len(members)]
                    gm[:len(real)] = plan[[members[r] for r in real]]
                stacked, losses = self.trainer.run_cohort_round(
                    params, xs, ys, valid, group=spec.group, plan_rows=gm,
                    prev_params=prev_arg, fused=self.fused_adam)
                yield members, rows, stacked, losses

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
        params, prev_params = self._place_cohort_args(params, prev_params, submesh)
        parts = [(members, stacked, losses) for members, _, stacked, losses in
                 self._cohort_parts(params, spec, datasets, seeds=seeds, epochs=epochs,
                                    batch_size=batch_size, prev_params=prev_params,
                                    plan=plan)]
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
    ) -> tuple[PyTree, torch.Tensor, list[PyTree] | None]:
        """``run_local_async`` plus one stacked aggregation on the device;
        the (clients,) losses stay on the device (``run_federated`` reads a
        call's rounds back at once)."""
        self._guard_round(weights, tracker)
        plan = resolve_plan(plan, spec, self.partition.num_groups)
        ids = self._require_client_ids(client_ids, len(datasets))
        use_prev = self.algo.name == "moon"
        num = len(datasets)
        stacked, losses_dev = self.run_local_async(
            params, spec, datasets, seeds=seeds, epochs=epochs,
            batch_size=batch_size, prev_params=prev_params, plan=plan)
        with record_function(FL_AGGREGATE):
            agg_in = stacked             # MOON keeps the TRUE locals below
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
        return new_params, losses_dev, new_locals


def _transmitted_rows(params: PyTree, partition: Partition, groups,
                      block_rows: int = FUSED_BLOCK_ROWS) -> np.ndarray:
    """Packed-row indices of the round's transmitted blocks: the blocks of
    ``groups``' leaves minus BN running moments, in ``madam_ops.pack``
    layout (the subtree the tree epilogue selects and ``drop_local_stats``-es)."""
    bm = madam_ops.block_mask_for_group(params, partition, groups, block_rows,
                                        exclude=aggregation.is_local_stat)
    blocks = np.flatnonzero(bm)
    return (blocks[:, None] * block_rows + np.arange(block_rows)[None, :]).reshape(-1)


def _plan_rows(params: PyTree, partition: Partition,
               block_rows: int = FUSED_BLOCK_ROWS) -> tuple[np.ndarray, np.ndarray]:
    """(rows, per-row group ids) for plan rounds: every non-stat block
    travels (any client may have trained it), each row weighted by its
    group's per-client weight."""
    gids = madam_ops.block_group_ids(params, partition, block_rows,
                                     exclude=aggregation.is_local_stat)
    blocks = np.flatnonzero(gids >= 0)
    rows = (blocks[:, None] * block_rows + np.arange(block_rows)[None, :]).reshape(-1)
    return rows, np.repeat(gids[blocks], block_rows)


def _flat_rows(tree: PyTree, lead: int) -> tuple[torch.Tensor, list]:
    """The leaves of ``tree`` (each with a leading axis of ``lead``, all of
    one dtype) as one ``(lead, n)`` buffer, and the layout ``_unflat_rows``
    needs: one collective for the tree instead of one per leaf."""
    items = tree_paths(tree)
    if len({leaf.dtype for _, leaf in items}) > 1:
        raise ValueError("a tree crossing ranks must have one dtype, got "
                         f"{sorted({str(leaf.dtype) for _, leaf in items})}")
    buf = torch.cat([leaf.reshape(lead, -1) for _, leaf in items], dim=1)
    return buf, [(path, tuple(leaf.shape[1:])) for path, leaf in items]


def _unflat_rows(buf: torch.Tensor, layout: list) -> PyTree:
    pieces = buf.split([math.prod(shape) for _, shape in layout], dim=1)
    return tree_from_paths((path, piece.reshape((buf.shape[0],) + shape))
                           for (path, shape), piece in zip(layout, pieces))


@dataclasses.dataclass
class ShardMapEngine(_BatchedEngineBase):
    """Multi-device engine: each bucket's client axis sharded over the ranks
    of a one-dimensional ``"clients"`` mesh (``launch.mesh.make_client_mesh``;
    one process per device, NCCL on the card, gloo on the CPU).

    Every rank runs the same server loop on the same seeds and holds the
    global params; ``run_round`` pads each bucket to a multiple of the
    world size (padding clients: the first member's data, never a valid
    step, zero weight) and each rank trains its contiguous share of it
    through ``LocalTrainer.run_cohort_round`` (fused: one cohort-kernel
    launch per local step).  Each rank reduces its share to the round's
    weight-scaled transmitted update, and one ``all_reduce`` per bucket sums
    the ranks' updates — the reference's ``psum``.  Only the transmitted
    subtree crosses ranks: the trainable group's leaves, BN running moments
    never; fused, the packed transmitted rows alone (``_transmitted_rows``;
    ``_plan_rows`` under a per-client plan), one ``(rows, 128)`` f32 buffer.
    Under compression each rank compresses its clients' updates before the
    reduction, so only compressed values travel, and the per-leaf form
    reduces.  The buckets' sums are spliced into the global params the same
    way on every rank, so the ranks' params stay bit-identical.  The
    losses, MOON's local models and the new error-feedback residuals are
    ``all_gather``-ed, so every rank holds every client's, whichever rank
    trains it next round.

    The async runtime's backend: ``run_local_async`` shards a cohort over
    every rank and gathers its locals; with a slot of ``cohort_pool`` (a
    ``launch.mesh.RankPool``) the slot's rank trains the whole cohort and
    ``broadcast``s it.

    ``ShardMapEngine.traffic`` records each ``run_round``'s collectives
    (calls and bytes of the update's ``all_reduce`` and of the
    ``all_gather``-s); the caller resets it."""

    name: str = "shard_map"
    devices: int = 0                # mesh size: 0 = every rank
    device_type: str = "cuda"       # "cuda": an NCCL group, "cpu": a gloo one
    traffic: ClassVar[list[dict]] = []

    def __post_init__(self):
        super().__post_init__()
        self.mesh = make_client_mesh(self.devices, self.device_type)
        self.group = self.mesh.get_group()
        self.rank = self.mesh.get_local_rank()
        self._rows: dict = {}

    @property
    def num_devices(self) -> int:
        return self.mesh.size()

    # -- collectives --------------------------------------------------------

    def _check_device(self, params: PyTree) -> torch.device:
        dev = tree_leaves(params)[0].device
        if dev.type != self.device_type:
            raise ValueError(f"the {self.device_type} client mesh cannot reduce "
                             f"tensors on {dev}")
        return dev

    def _all_reduce(self, t: torch.Tensor, rec: dict) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        rec["all_reduce_calls"] += 1
        rec["all_reduce_bytes"] += t.numel() * t.element_size()
        return t

    def _all_reduce_tree(self, update: PyTree, rec: dict) -> PyTree:
        """``_all_reduce`` of an f32 tree as one flat buffer."""
        buf, layout = _flat_rows(tree_map(lambda x: x[None], update), 1)
        return tree_map(lambda x: x[0], _unflat_rows(self._all_reduce(buf, rec), layout))

    def _all_gather(self, t: torch.Tensor, rec: dict | None) -> torch.Tensor:
        """Every rank's ``t`` concatenated along the leading axis, in rank
        order: the bucket's rows in order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.num_devices)]
        dist.all_gather(out, t, group=self.group)
        if rec is not None:
            rec["all_gather_calls"] += 1
            rec["all_gather_bytes"] += t.numel() * t.element_size() * len(out)
        return torch.cat(out)

    def _all_gather_tree(self, stacked: PyTree, rec: dict | None) -> PyTree:
        buf, layout = _flat_rows(stacked, tree_leaves(stacked)[0].shape[0])
        return _unflat_rows(self._all_gather(buf, rec), layout)

    def _rows_for(self, params: PyTree, group) -> torch.Tensor:
        """The fused epilogue's row index on the params' device: the
        transmitted rows of ``group`` (``-1``: every group), or the plan
        rows for ``group="plan"``; built once per (group, device)."""
        dev = tree_leaves(params)[0].device
        key = (group, str(dev))
        if key not in self._rows:
            if group == "plan":
                rows, gids = _plan_rows(params, self.partition)
                self._rows[key] = (torch.as_tensor(rows, device=dev),
                                   torch.as_tensor(gids, device=dev))
            else:
                sel = tuple(range(self.partition.num_groups)) if group < 0 else group
                self._rows[key] = torch.as_tensor(
                    _transmitted_rows(params, self.partition, sel), device=dev)
        return self._rows[key]

    # -- the per-rank epilogue and the splice ---------------------------------

    def _epilogue(self, params: PyTree, stacked: PyTree, group: int, plan, w,
                  packed_form: bool):
        """The rank's weight-scaled sum of its clients' transmitted update:
        ``w`` is ``(clients,)`` (homogeneous) or ``(clients, M)`` per-group
        weights (plan), zero for padding clients.  ``packed_form``: the
        ``(rows, 128)`` packed transmitted rows, else a tree."""
        if packed_form:
            packed, _ = madam_ops.pack_stacked(stacked, FUSED_BLOCK_ROWS)
            if plan is None:
                return torch.tensordot(w, packed[:, self._rows_for(params, group)], dims=1)
            rows, gids = self._rows_for(params, "plan")
            return torch.einsum("ct,ctl->tl", w[:, gids], packed[:, rows])
        if plan is None:
            sub = stacked if group < 0 else masking.select(stacked, self.partition, group)
            return tree_map(lambda x: torch.tensordot(w, x.float(), dims=1),
                            aggregation.drop_local_stats(sub))
        return tree_map_with_path(
            lambda path, x: torch.tensordot(w[:, self.partition.group_of(path)],
                                            x.float(), dims=1),
            aggregation.drop_local_stats(stacked))

    def _splice(self, params: PyTree, summed, group: int, trained, packed_form: bool):
        """Write the summed update into the global params: fused, scatter
        the rows into ``madam_ops.pack(params)`` and unpack (untransmitted
        leaves round-trip bit-exact); a group nobody trained (``trained``,
        plan rounds) keeps the global bit-identical."""
        if packed_form:
            pg, meta = madam_ops.pack(params, FUSED_BLOCK_ROWS)
            if trained is None:
                pg[self._rows_for(params, group)] = summed
            else:
                rows, gids = self._rows_for(params, "plan")
                keep = torch.as_tensor(trained, device=pg.device)[gids][:, None]
                pg[rows] = torch.where(keep, summed, pg[rows])
            return madam_ops.unpack(pg, meta)
        if trained is None:
            ref = params if group < 0 else masking.select(params, self.partition, group)
            averaged = tree_map(lambda s, r: s.to(r.dtype), summed,
                                aggregation.drop_local_stats(ref))
        else:
            averaged = tree_map_with_path(
                lambda path, s, r: (s.to(r.dtype) if trained[self.partition.group_of(path)]
                                    else r),
                summed, aggregation.drop_local_stats(params))
        return masking.tree_update(params, averaged)

    # -- round execution ---------------------------------------------------

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
        """Train the rank's share of every bucket, reduce it, ``all_reduce``
        one update per bucket and splice their sum; the losses (and MOON's
        locals) come back in the round's client order on every rank."""
        self._guard_round(weights, tracker)
        plan = resolve_plan(plan, spec, self.partition.num_groups)
        ids = self._require_client_ids(client_ids, len(datasets))
        dev = self._check_device(params)
        use_prev = self.algo.name == "moon"
        cfg = self.compression
        packed_form = self.fused_adam and cfg is None
        w = np.asarray(weights, dtype=np.float32)
        if plan is None:
            w_cohort, trained = w / w.sum(), None
        else:
            # per-group participant denominators over the whole cohort
            denom = aggregation.plan_group_denominators(plan, w)
            w_cohort = (w[:, None] * plan.astype(np.float32)
                        / np.where(denom > 0, denom, 1.0)[None, :])
            trained = denom > 0
        rec = {"group": spec.group, "all_reduce_calls": 0, "all_reduce_bytes": 0,
               "all_gather_calls": 0, "all_gather_bytes": 0}
        updates, parts = [], []
        for members, rows, stacked, losses in self._cohort_parts(
                params, spec, datasets, seeds=seeds, epochs=epochs,
                batch_size=batch_size, prev_params=prev_params, plan=plan,
                pad_clients_to=self.num_devices, shard=(self.rank, self.num_devices)):
            real = [members[r] for r in rows if r < len(members)]
            wb = np.zeros((len(rows),) + w_cohort.shape[1:], dtype=np.float32)
            wb[:len(real)] = w_cohort[real]
            with record_function(FL_AGGREGATE):
                send = stacked               # MOON keeps the TRUE locals
                if cfg is not None:
                    res = masking.stack_trees(
                        [self._residual_for(ids[m], params) for m in real]
                        + [compress.init_residual(params)] * (len(rows) - len(real)))
                    if plan is None:
                        send, new_res = compress.transmit_tree(
                            params, stacked, res, cfg, partition=self.partition,
                            groups=None if spec.is_full else (spec.group,), stacked=True)
                    else:
                        gm = np.zeros((len(rows), plan.shape[1]), dtype=bool)
                        gm[:len(real)] = plan[real]
                        send, new_res = compress.transmit_tree_plan(
                            params, stacked, res, gm, cfg, partition=self.partition,
                            stacked=True)
                    new_res = self._all_gather_tree(new_res, rec)
                    for i, m in enumerate(members):
                        self.state_store.put("ef", ids[m],
                                             tree_map(lambda x, i=i: x[i].clone(), new_res))
                update = self._epilogue(params, send, spec.group, plan,
                                        torch.as_tensor(wb, device=dev), packed_form)
                updates.append(self._all_reduce(update, rec) if packed_form
                               else self._all_reduce_tree(update, rec))
            n = len(members)
            gathered = self._all_gather_tree(stacked, rec) if use_prev else {}
            parts.append((members, tree_map(lambda x: x[:n], gathered),
                          self._all_gather(losses, rec)[:n]))
        with record_function(FL_AGGREGATE):
            summed = (sum(updates) if packed_form
                      else tree_map(lambda *xs: sum(xs), *updates))
            new_params = self._splice(params, summed, spec.group, trained, packed_form)
        locals_, losses = self._gather_order(parts, len(datasets))
        new_locals = ([tree_map(torch.clone, t)
                       for t in masking.unstack_tree(locals_, len(datasets))]
                      if use_prev else None)
        ShardMapEngine.traffic.append(rec)
        return new_params, losses.tolist(), new_locals

    # -- cohort execution (the async runtime's backend) ----------------------

    def cohort_pool(self, max_inflight: int, device_type: str = "cuda"):
        """Width-1 rank slots, at most ``min(max_inflight, ranks)``; ``None``
        for one cohort at a time (sharded over every rank)."""
        if max_inflight <= 1:
            return None
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.device_type == "cuda" else torch.device("cpu"))
        return RankPool(max_inflight, self.mesh, dev)

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
        """Train one cohort without aggregating; every rank returns the
        cohort's stacked locals and ``(K,)`` losses in ``datasets`` order.
        Without ``submesh`` the cohort is sharded over every rank and
        gathered; with one (a ``RankPool`` slot) its rank trains it whole
        and broadcasts it."""
        plan = resolve_plan(plan, spec, self.partition.num_groups)
        self._check_device(params)
        kw = dict(seeds=seeds, epochs=epochs, batch_size=batch_size,
                  prev_params=prev_params, plan=plan)
        if submesh is None:
            parts = []
            for members, _, stacked, losses in self._cohort_parts(
                    params, spec, datasets, **kw, pad_clients_to=self.num_devices,
                    shard=(self.rank, self.num_devices)):
                n = len(members)
                parts.append((members,
                              tree_map(lambda x: x[:n], self._all_gather_tree(stacked, None)),
                              self._all_gather(losses, None)[:n]))
            return self._gather_order(parts, len(datasets))
        src, num = submesh.ranks[0], len(datasets)
        if self.rank == src:
            parts = [(members, stacked, losses) for members, _, stacked, losses in
                     self._cohort_parts(params, spec, datasets, **kw)]
            stacked, losses = self._gather_order(parts, num)
        else:
            stacked = tree_map(lambda p: torch.empty((num,) + tuple(p.shape),
                                                     dtype=p.dtype, device=p.device),
                               params)
            losses = torch.empty(num, dtype=torch.float32,
                                 device=tree_leaves(params)[0].device)
        buf, layout = _flat_rows(stacked, num)
        losses = losses.contiguous()
        for t in (buf, losses):
            dist.broadcast(t, src=src, group=self.group)
        return _unflat_rows(buf, layout), losses


def make_engine(name: str, *, trainer: LocalTrainer, partition: Partition,
                algo: AlgoConfig, sim_devices: int = 0, fused_adam: bool = False,
                compression: compress.CompressionConfig | None = None,
                state_store: ClientStateStore | None = None,
                device_type: str = "cuda"):
    """Build a client-simulation engine by name (``"sequential"``,
    ``"vmap"`` or ``"shard_map"``); without ``state_store`` it keeps its
    residuals in an unbounded store of its own.  ``sim_devices`` and
    ``device_type`` size and place the shard_map engine's client mesh
    (0 = every rank of the process group; ``"cuda"``: NCCL, ``"cpu"``:
    gloo) and are ignored by the other engines."""
    kw = dict(trainer=trainer, partition=partition, algo=algo,
              fused_adam=fused_adam, compression=compression,
              state_store=ClientStateStore() if state_store is None else state_store)
    if name == "sequential":
        return SequentialEngine(**kw)
    if name == "vmap":
        return VmapEngine(**kw)
    if name == "shard_map":
        return ShardMapEngine(**kw, devices=sim_devices, device_type=device_type)
    raise ValueError(f"unknown engine {name!r}; expected one of {ENGINES}")
