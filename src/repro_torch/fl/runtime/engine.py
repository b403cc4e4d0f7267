"""Event-driven asynchronous federated runtime on a virtual clock (port of
``repro.fl.runtime.engine``).

``run_federated_async`` replaces the synchronous barrier with a
discrete-event simulation:

1. **Dispatch.**  While the server sits at version ``v`` it samples a cohort
   of idle, available clients and trains them as one stacked batch through
   the run's engine (``engine.run_local_async``), every member on the group
   scheduled for version ``v`` (``core.schedule.ScheduleIndex``; under a
   per-client plan, its own group set) against the version-``v`` model.  Up
   to ``max_inflight_cohorts`` cohorts fly at once, each launched on a free
   slot of ``engine.cohort_pool`` (``launch.mesh.SubmeshPool``; on the
   shard_map engine a ``RankPool``, one rank a slot); with no free slot the
   launch queues while the dispatch is still booked at its virtual time.
2. **Flight.**  Each member's completion is booked on the virtual clock:
   local compute scaled by the client's speed, the transmitted subtree's
   transfer down and up, latency jitter and dropout, from the seeded
   availability model (``runtime.clients``) and ``core.costs.
   VirtualTimeModel``.  Cohort spans go into a ``SubmeshOccupancy`` book.
3. **Merge.**  Delivered updates fill the server buffer; the policy
   (``runtime.policy``) decides when to merge and discounts stale updates.
   A merge bumps the version, which advances the schedule, lets the
   controller (``runtime.control``, ``controller="adaptive"``) adjust its
   knobs, and tops the in-flight cohorts back up.

The event heap, its FIFO tiebreak, the retry and wait logic, the launch
queue, the occupancy book, host-side compression at ``resolve`` and the
``"control"`` events are the reference's.  Every dispatch decision depends
only on virtual events (the sampler's and availability's numpy streams,
float64 virtual-clock sums, the cost tables), so a run's ``Timeline``
equals the reference's event for event; only the merges' losses and the
evals' accuracies come from training.  A launch returns before the device
has finished (CUDA launches are asynchronous and the losses stay on the
device): ``resolve``, at a cohort's first popped member event, is where the
host first waits for it.  No captured version-``v`` tree is ever written:
the merge builds new leaves.  Per-dispatch host work is O(cohort), never
O(population): Floyd sampling over ``range(n)`` minus the busy set, lazy
per-id speeds and traces, shards built for picked members only.  The host
clock (``time.perf_counter``) feeds ``host_seconds`` and nothing else, so
the shard_map engine's ranks, each running this loop, take the same
decisions and issue the same collectives in the same order.

In the degenerate configuration (full participation, perfect fleet,
``buffer_k=0``, exponent 0, one cohort in flight) every cohort is a barrier
round and the run equals ``runtime="sync"``.  Besides the reference's
outputs, ``FLResult.host_seconds`` splits the run's host time into
``dispatch`` (sampling, the picked members' shards, booking), ``launch``
(``run_local_async`` returning), ``resolve``, ``merge`` and ``eval``, and
each history entry carries its merge's host ``seconds``.
"""

from __future__ import annotations

import heapq
import itertools
import time
from collections import deque
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation, compress, masking
from repro_torch.core.costs import comm_cost, comp_cost, plan_step_flops
from repro_torch.core.partition import (group_param_bytes, group_param_counts,
                                        total_param_bytes)
from repro_torch.core.schedule import PlanAssigner, RoundSpec, ScheduleIndex
from repro_torch.core.telemetry import Timeline
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.fl.batched import make_engine, resolve_plan
from repro_torch.fl.client import LocalTrainer
from repro_torch.fl.population import (ClientPopulation, IncrementalSampler,
                                       as_population, client_round_seed,
                                       resolve_cohort_size,
                                       weighted_sample_without_replacement)
from repro_torch.fl.runtime.clients import ClientAvailability
from repro_torch.fl.runtime.control import make_controller
from repro_torch.fl.runtime.policy import ClientUpdate, make_policy
from repro_torch.fl.tasks import TaskAdapter
from repro_torch.optim.adam import AdamConfig
from repro_torch.tree import PyTree, tree_leaves, tree_map

if TYPE_CHECKING:  # fl.server imports this module
    from repro_torch.fl.server import FLResult, FLRunConfig


def _steps_per_round(n: int, batch_size: int, epochs: int) -> int:
    """Local step count of ``data.pipeline.batch_plan`` without building it."""
    bs = min(batch_size, n)
    per_epoch = (n - bs) // bs + 1 if n >= bs else 1
    return epochs * per_epoch


class _Cohort:
    """One dispatched cohort: booked at dispatch, launched then or later
    (a queued launch), its results read at its first popped member event."""

    __slots__ = ("picked", "datasets", "seeds", "prevs", "spec", "plan",
                 "params", "dispatched_t", "end_t", "updates", "submesh",
                 "stacked", "losses_dev", "launched", "resolved", "tl_event")

    def __init__(self, *, picked, datasets, seeds, prevs, spec, plan, params,
                 dispatched_t, end_t, updates, tl_event):
        self.picked = picked
        self.datasets = datasets
        self.seeds = seeds
        self.prevs = prevs
        self.spec = spec
        self.plan = plan              # per-client group bitmask (None = homogeneous)
        self.params = params          # version-``v`` tree captured at dispatch
        self.dispatched_t = dispatched_t
        self.end_t = end_t            # last member completion (virtual)
        self.updates = updates
        self.tl_event = tl_event
        self.submesh = None
        self.stacked = None
        self.losses_dev = None
        self.launched = False
        self.resolved = False


def run_federated_async(
    adapter: TaskAdapter,
    clients_data: Sequence | ClientPopulation,
    eval_set: tuple[np.ndarray, np.ndarray],
    rounds: Sequence[RoundSpec],
    run_cfg: "FLRunConfig",
    *,
    init_params: PyTree | None = None,
    verbose: bool = False,
) -> "FLResult":
    """Run the federation on the virtual clock; ``init_params`` as in
    ``fl.server.run_federated``."""
    from repro_torch.fl.server import FLResult  # fl.server imports this module

    if run_cfg.track_stepsizes:
        raise ValueError("track_stepsizes requires runtime='sync' with "
                         "engine='sequential'")
    if run_cfg.max_inflight_cohorts < 1:
        raise ValueError("max_inflight_cohorts must be >= 1, got "
                         f"{run_cfg.max_inflight_cohorts}")
    device = resolve_device(run_cfg.device)
    if device.type == "cuda":
        strict_fp32()
    if init_params is None:
        init_params = adapter.init(torch.Generator().manual_seed(run_cfg.seed))
    params = tree_map(lambda a: torch.as_tensor(a).to(device, copy=True),
                      init_params)
    partition = adapter.partition(params)
    host_seconds = {"dispatch": 0.0, "launch": 0.0, "resolve": 0.0, "merge": 0.0,
                    "eval": 0.0}
    if not rounds:  # the sync loop's no-op
        return FLResult(history=[], params=params, partition=partition,
                        tracker=None, comm_total_bytes=0, comp_total_flops=0.0,
                        comm_fnu_bytes=0, comp_fnu_flops=0.0, timeline=Timeline(),
                        host_seconds=host_seconds)
    trainer = LocalTrainer(adapter=adapter, partition=partition, algo=run_cfg.algo,
                           adam=AdamConfig(lr=run_cfg.lr, eps=run_cfg.adam_eps))
    engine = make_engine(run_cfg.engine, trainer=trainer, partition=partition,
                         algo=run_cfg.algo, sim_devices=run_cfg.sim_devices,
                         fused_adam=run_cfg.fused_adam, device_type=device.type)
    policy = make_policy(run_cfg.async_policy, partition,
                         staleness_exponent=run_cfg.staleness_exponent,
                         buffer_goal=run_cfg.buffer_k)
    sched = ScheduleIndex.from_rounds(rounds)
    assigner = PlanAssigner(
        num_groups=partition.num_groups, kind=run_cfg.plan,
        capacity_tiers=tuple(run_cfg.capacity_tiers), seed=run_cfg.seed)
    population = as_population(clients_data)
    n_clients = population.num_clients
    avail = ClientAvailability(run_cfg.availability, n_clients)
    vtm = run_cfg.vtime
    timeline = Timeline()
    # the synchronous server's selection stream: one Floyd k-subset per
    # dispatch while the whole fleet is idle
    rng = np.random.default_rng(run_cfg.seed)
    eval_x = torch.as_tensor(eval_set[0][: run_cfg.eval_batch], device=device)
    eval_y = torch.as_tensor(eval_set[1][: run_cfg.eval_batch], device=device)
    is_moon = run_cfg.algo.name == "moon"
    ccfg = run_cfg.compression_config()
    # MOON previous models ("moon") and EF residuals ("ef") per client
    state_store = run_cfg.make_state_store()

    # cost tables: upstream bytes (encoded when compressing) and per-step flops
    if ccfg is None:
        group_bytes = group_param_bytes(params, partition)
        full_bytes = int(total_param_bytes(params))
    else:
        group_bytes = compress.group_encoded_bytes(params, partition, ccfg)
        full_bytes = int(group_bytes.sum())
    group_counts = group_param_counts(params, partition).astype(np.float64)
    _flops_cache: dict[int, float] = {}

    def _step_flops(spec: RoundSpec) -> float:
        if spec.group not in _flops_cache:
            _flops_cache[spec.group] = float(
                comp_cost(partition, [spec], group_fwd_flops=group_counts)
                .per_round_flops[0])
        return _flops_cache[spec.group]

    _plan_flops_cache: dict[tuple[int, ...], float] = {}

    def _plan_flops(groups: tuple[int, ...]) -> float:
        if groups not in _plan_flops_cache:
            _plan_flops_cache[groups] = plan_step_flops(
                partition, groups, group_fwd_flops=group_counts)
        return _plan_flops_cache[groups]

    # -- host-parallel dispatch state ---------------------------------------
    max_inflight = run_cfg.max_inflight_cohorts
    # the controller's dispatch knobs; static runs never move them
    cohort_target = resolve_cohort_size(n_clients, run_cfg.sample_fraction,
                                        run_cfg.cohort_size)
    plan_boost = 0
    num_tiers = len(assigner.capacity_tiers)
    # None under controller="static": no observation hook at all.  Adaptive
    # runs may grow the in-flight target, so the pool is cut for its bound.
    controller = make_controller(run_cfg, num_clients=n_clients,
                                 num_groups=partition.num_groups,
                                 cohort_size=cohort_target)
    pool_cap = (max(max_inflight, run_cfg.controller_inflight_bounds[1])
                if controller is not None else max_inflight)
    pool = engine.cohort_pool(pool_cap, device.type)
    occupancy = vtm.occupancy()
    launch_queue: deque[_Cohort] = deque()
    # results of a cohort on another slot's device come back to the run's
    # device at resolve, so the merge never mixes devices (a shard_map slot's
    # results are broadcast to every rank's own device: no transfer)
    params_device = tree_leaves(params)[0].device
    xfer_back = pool is not None and any(sm.device != params_device
                                         for sm in pool.submeshes)

    # -- event-loop state ---------------------------------------------------
    events: list[tuple] = []         # min-heap of (t, seq, kind, upd, cohort)
    seq = itertools.count()          # FIFO tiebreak for simultaneous events
    busy: set[int] = set()
    retry_pending = False            # a "retry" wait event is already booked
    retry_streak = 0                 # consecutive dispatches with no arrival
    buffer: list[ClientUpdate] = []
    history: list[dict] = []
    version = 0                      # server aggregations committed so far
    vclock = 0.0
    pending = 0                      # in-flight updates that WILL deliver
    inflight = 0                     # dispatched-but-unresolved cohorts
    last_cohort = 0
    total = len(rounds)
    t_merge_end = time.perf_counter()

    def launch(cohort: _Cohort, submesh) -> None:
        """Hand the cohort's stacked local training to the engine (returns
        before the device is done) and book its occupancy."""
        t0 = time.perf_counter()
        cohort.submesh = submesh
        cohort.stacked, cohort.losses_dev = engine.run_local_async(
            cohort.params, cohort.spec, cohort.datasets, seeds=cohort.seeds,
            epochs=run_cfg.local_epochs, batch_size=run_cfg.batch_size,
            prev_params=cohort.prevs, submesh=submesh, plan=cohort.plan)
        host_seconds["launch"] += time.perf_counter() - t0
        cohort.launched = True
        idx = submesh.index if submesh is not None else -1
        cohort.tl_event["submesh"] = idx
        occupancy.book(idx, cohort.dispatched_t, cohort.end_t)

    def resolve(cohort: _Cohort) -> None:
        """Read the cohort's results into its member updates (the host waits
        for the device here), free its slot, start the next queued launch."""
        nonlocal inflight
        if cohort.resolved:
            return
        if not cohort.launched:  # queued past exhaustion: run unbound now
            launch(cohort, None)
        t0 = time.perf_counter()
        cohort.resolved = True
        inflight -= 1
        stacked = cohort.stacked
        losses = cohort.losses_dev.tolist()
        if is_moon:
            # a copy per client, so no entry keeps the cohort's buffers alive
            for i, ci in enumerate(cohort.picked):
                state_store.put("moon", int(ci), tree_map(
                    lambda x, i=i: x[i].to(device, copy=True), stacked))
        spec = cohort.spec
        if cohort.plan is None:
            sub = stacked if spec.is_full else masking.select(
                stacked, partition, spec.group)
        else:
            # the union of the cohort's trained groups, then each member's own
            union = tuple(int(g) for g in np.flatnonzero(cohort.plan.any(axis=0)))
            sub = (stacked if len(union) == partition.num_groups
                   else masking.select(stacked, partition, union))
        sub = aggregation.drop_local_stats(sub)
        if xfer_back:
            # only the transmitted subtree comes back to the run's device
            sub = tree_map(lambda x: x.to(device), sub)
        subs = masking.unstack_tree(sub, len(cohort.picked))
        # host-side transmission compression against the dispatch-version
        # model, with the per-client EF residual; the buffer holds the
        # decompressed view, ``comm_bytes`` booked the encoded size
        g_views: dict = {}

        def _g_view(sel):
            if sel not in g_views:
                t = (cohort.params if sel is None
                     else masking.select(cohort.params, partition, sel))
                g_views[sel] = aggregation.drop_local_stats(t)
            return g_views[sel]

        for i, upd in enumerate(cohort.updates):
            upd_sub = (subs[i] if upd.groups is None else
                       masking.select(subs[i], partition, upd.groups))
            if ccfg is not None:
                sel = (upd.groups if upd.groups is not None
                       else (None if spec.is_full else spec.group))
                res_full = state_store.get("ef", upd.client_id)
                if res_full is None:
                    res_full = compress.init_residual(cohort.params)
                res_sub = aggregation.drop_local_stats(
                    res_full if sel is None
                    else masking.select(res_full, partition, sel))
                upd_sub, new_res = compress.transmit_tree(
                    _g_view(sel), upd_sub, res_sub, ccfg, partition=partition)
                state_store.put("ef", upd.client_id,
                                masking.tree_update(res_full, new_res))
            upd.subtree = upd_sub
            upd.loss = losses[i]
        # drop the big references now: the snapshot, the outputs, MOON prevs
        cohort.stacked = cohort.losses_dev = cohort.params = None
        cohort.prevs = None
        host_seconds["resolve"] += time.perf_counter() - t0
        if cohort.submesh is not None:
            pool.release(cohort.submesh)
            while launch_queue and pool.free_count > 0:
                nxt = launch_queue.popleft()
                if not nxt.launched:
                    launch(nxt, pool.acquire())

    def book_retry(t: float, rejected: list[int]) -> None:
        """Every sampled candidate is unavailable at ``t``: book one
        deterministic wait/retry event (the earliest trace on-window among
        the rejected, else ``retry_wait``); at most one is in flight."""
        nonlocal retry_pending, retry_streak
        if retry_pending:
            return
        retry_streak += 1
        if retry_streak > 1000:
            raise RuntimeError(
                "async runtime: 1000 consecutive dispatch attempts found no "
                "available client — the availability trace/knobs leave the "
                "fleet effectively unreachable")
        waits: list[float] = []
        if avail.cfg.trace:
            coin_failed = False
            for ci in rejected:
                w = avail.next_on_time(ci, t) - t
                if w > 0.0:
                    waits.append(w)
                else:
                    coin_failed = True
            if coin_failed or not waits:
                waits.append(avail.cfg.retry_wait)
        else:
            waits.append(avail.cfg.retry_wait)
        wait = min(waits)
        retry_pending = True
        timeline.record(t, "wait", until=t + wait, rejected=len(rejected))
        heapq.heappush(events, (t + wait, next(seq), "retry", None, None))

    def dispatch(t: float, fragment_ok: bool) -> int:
        """``_dispatch``, its host seconds outside the launch booked as
        ``"dispatch"``."""
        t0, launched = time.perf_counter(), host_seconds["launch"]
        try:
            return _dispatch(t, fragment_ok)
        finally:
            host_seconds["dispatch"] += (time.perf_counter() - t0
                                         - (host_seconds["launch"] - launched))

    def _dispatch(t: float, fragment_ok: bool) -> int:
        """Sample a cohort at the current version, book each member's
        completion, and launch it on a free slot (or queue the launch).
        ``fragment_ok``: a merge- or stall-triggered dispatch takes whatever
        idle clients exist; capacity top-ups need a full cohort."""
        nonlocal pending, last_cohort, inflight, retry_streak
        spec = sched.for_version(version)
        pool_size = n_clients - len(busy)
        if pool_size <= 0:
            return 0
        n_pick = cohort_target
        if pool_size < n_pick and not fragment_ok:
            return 0
        # Floyd over range(n) minus the busy set: blind mode filters each
        # candidate through its own arrival draw and tops up; biased mode
        # weights candidates by their current availability
        k_target = min(n_pick, pool_size)
        sampler = IncrementalSampler(rng, n_clients, busy)
        picked: list[int] = []
        rejected: list[int] = []
        if run_cfg.participation_sampling == "biased":
            pool_ids: list[int] = []
            pool_w: list[float] = []
            navail = 0
            while navail < k_target and sampler.remaining > 0:
                need = k_target - navail
                ask = (need if not avail.cfg.trace else
                       max(need, min(4 * k_target, sampler.remaining)))
                for ci in sampler.draw(ask):
                    w = avail.availability_weight(ci, t)
                    pool_ids.append(ci)
                    pool_w.append(w)
                    if w > 0.0:
                        navail += 1
            if navail == 0:
                book_retry(t, pool_ids)
                return 0
            picked = weighted_sample_without_replacement(
                rng, pool_ids, pool_w, min(k_target, navail))
        else:
            while len(picked) < k_target and sampler.remaining > 0:
                for ci in sampler.draw(k_target - len(picked)):
                    (picked if avail.arrival_ok(ci, t) else rejected).append(ci)
            if not picked:
                book_retry(t, rejected)
                return 0
        retry_streak = 0
        k = len(picked)

        datasets = [population.dataset(ci) for ci in picked]
        seeds = [client_round_seed(run_cfg.seed, spec.index, int(ci)) for ci in picked]
        prevs = ([state_store.get("moon", int(ci)) for ci in picked]
                 if is_moon else None)
        # the raw plan decides the updates' group sets (per-(client, group)
        # merges for every plan-kind dispatch); the resolved one only which
        # training path runs
        plan_raw = assigner.assign(spec, picked, boost=plan_boost)
        plan = resolve_plan(plan_raw, spec, partition.num_groups)
        up_bytes = full_bytes if spec.is_full else int(group_bytes[spec.group])
        step_flops = _step_flops(spec)

        # per member: jitter, then drop (the reference's draw order)
        biased = run_cfg.participation_sampling == "biased"
        members, end_t = [], t
        for i, ci in enumerate(picked):
            if plan_raw is None:
                groups_i, ub, sf = None, up_bytes, step_flops
            else:
                groups_i = tuple(int(g) for g in np.flatnonzero(plan_raw[i]))
                ub = (full_bytes if len(groups_i) == partition.num_groups
                      else int(group_bytes[list(groups_i)].sum()))
                sf = _plan_flops(groups_i)
            flops = sf * _steps_per_round(
                len(datasets[i]), run_cfg.batch_size, run_cfg.local_epochs)
            dur = vtm.round_seconds(flops, ub, speed=avail.speed(ci),
                                    jitter=avail.jitter())
            upd = ClientUpdate(
                client_id=int(ci), version=version, group=spec.group,
                subtree=None, weight=float(len(datasets[i])),
                loss=float("nan"), dispatched_t=t, completed_t=t + dur,
                comp_flops=flops, comm_bytes=ub, groups=groups_i,
                encoding=None if ccfg is None else ccfg.kind,
                inclusion_prob=avail.inclusion_prob(ci) if biased else 1.0)
            members.append((upd, "drop" if avail.drops() else "complete"))
            end_t = max(end_t, t + dur)
        timeline.record(t, "dispatch", version=version, group=spec.group,
                        clients=[int(c) for c in picked], t_end=end_t)
        cohort = _Cohort(picked=picked, datasets=datasets, seeds=seeds,
                         prevs=prevs, spec=spec, plan=plan, params=params,
                         dispatched_t=t, end_t=end_t,
                         updates=[u for u, _ in members],
                         tl_event=timeline.events[-1])
        inflight += 1
        for upd, kind in members:
            if kind == "complete":
                pending += 1
            heapq.heappush(events, (upd.completed_t, next(seq), kind, upd, cohort))
            busy.add(upd.client_id)
        submesh = pool.acquire() if pool is not None else None
        if pool is None or submesh is not None:
            launch(cohort, submesh)
        else:
            launch_queue.append(cohort)
        last_cohort = k
        return k

    def top_up(t: float, fragment_ok: bool = False) -> None:
        """Dispatch until the in-flight target is met (or nothing is
        dispatchable); only the first attempt may take a fragment cohort."""
        first = fragment_ok
        while inflight < max_inflight:
            if dispatch(t, first) == 0:
                break
            first = False

    def flush() -> None:
        """Commit one server aggregation: merge the buffer, eval on the sync
        cadence, advance the schedule, let the controller adjust its knobs,
        top the in-flight cohorts back up."""
        nonlocal params, version, max_inflight, cohort_target, plan_boost
        nonlocal t_merge_end
        spec = sched.for_version(version)
        t0 = time.perf_counter()
        params, info = policy.merge(params, buffer, version)
        host_seconds["merge"] += time.perf_counter() - t0
        buffer.clear()
        entry = {"round": spec.index, "phase": spec.phase, "group": spec.group,
                 "loss": info["loss"], "t": vclock, "merged": info["merged"],
                 "staleness_mean": info["staleness_mean"],
                 "staleness_max": info["staleness_max"]}
        timeline.record(vclock, "merge", version=version, group=spec.group, **{
            k: info[k] for k in ("loss", "merged", "staleness_mean", "staleness_max")})
        if spec.index % run_cfg.eval_every == 0 or spec.index == total - 1:
            t0 = time.perf_counter()
            acc = float(adapter.evaluate(params, eval_x, eval_y))
            host_seconds["eval"] += time.perf_counter() - t0
            entry["acc"] = acc
            timeline.record(vclock, "eval", version=version, acc=acc)
        now = time.perf_counter()
        entry["seconds"] = now - t_merge_end
        t_merge_end = now
        history.append(entry)
        if verbose:
            print(f"merge v{version:3d} [{spec.phase}:{spec.group:3d}] "
                  f"t={vclock:8.2f}s loss={entry['loss']:.4f} "
                  f"acc={entry.get('acc', float('nan')):.4f} "
                  f"stale(mean={entry['staleness_mean']:.2f},"
                  f"max={entry['staleness_max']})")
        version += 1
        if controller is not None and version < total:
            # observe between merges, apply before the post-merge dispatch
            adj = controller.observe(timeline.window(run_cfg.controller_window))
            if adj:
                if adj.max_inflight is not None:
                    max_inflight = min(max(adj.max_inflight, 1), pool_cap)
                if adj.buffer_k is not None:
                    policy.buffer_goal = max(adj.buffer_k, 1)
                if (adj.group_override is not None
                        and 0 <= adj.group_override < partition.num_groups):
                    sched.override_group(version, adj.group_override)
                if adj.cohort_size is not None:
                    c_lo, c_hi = run_cfg.controller_cohort_bounds
                    cohort_target = min(max(int(adj.cohort_size), c_lo),
                                        c_hi, n_clients)
                if adj.plan_boost is not None:
                    plan_boost = min(max(int(adj.plan_boost), 0),
                                     run_cfg.controller_plan_boost_max)
                timeline.record(vclock, "control", version=version,
                                max_inflight=max_inflight,
                                buffer_k=policy.buffer_goal,
                                group_override=adj.group_override,
                                cohort_size=cohort_target,
                                plan_boost=plan_boost,
                                note=adj.note)
        if version < total:
            if max_inflight == 1:
                # merge-driven regime: every merge dispatches
                dispatch(vclock, True)
            else:
                top_up(vclock, fragment_ok=True)

    # -- main loop ----------------------------------------------------------
    top_up(0.0, fragment_ok=True)
    while version < total:
        if not events:
            # nobody in flight: merge the leftovers or re-dispatch
            if buffer and policy.should_merge(len(buffer), 0, last_cohort):
                flush()
                continue
            if dispatch(vclock, True) == 0 and not events:
                raise RuntimeError(
                    "async runtime stalled: no events in flight, nothing "
                    "dispatchable, and the buffer cannot merge")
            continue
        t, _, kind, upd, cohort = heapq.heappop(events)
        vclock = t
        if kind == "retry":
            retry_pending = False
            if version < total:
                top_up(vclock, fragment_ok=True)
            continue
        busy.discard(upd.client_id)
        resolve(cohort)
        if kind == "complete":
            pending -= 1
            buffer.append(upd)
            timeline.record(t, "complete", client=upd.client_id,
                            staleness=upd.staleness(version),
                            comm_bytes=upd.comm_bytes,
                            comp_flops=upd.comp_flops,
                            inclusion_prob=upd.inclusion_prob,
                            tier=upd.client_id % num_tiers)
        else:
            timeline.record(t, "drop", client=upd.client_id,
                            comp_flops=upd.comp_flops)
        if buffer and policy.should_merge(len(buffer), pending, last_cohort):
            flush()
        elif max_inflight > 1 and version < total:
            top_up(vclock)

    if occupancy.spans:
        timeline.record(vclock, "occupancy", **occupancy.summary())

    # cost books over the committed versions as trained (controller
    # overrides swap in the groups it pinned)
    effective = [sched.for_version(v) for v in range(total)]
    comm = comm_cost(params, partition, effective, compression=ccfg)
    comp = comp_cost(partition, effective, group_fwd_flops=group_counts)
    return FLResult(
        history=history,
        params=params,
        partition=partition,
        tracker=None,
        comm_total_bytes=comm.total_bytes,
        comp_total_flops=float(comp.total_flops),
        comm_fnu_bytes=comm.fnu_total_bytes,
        comp_fnu_flops=float(comp.fnu_total_flops),
        timeline=timeline,
        host_seconds=host_seconds,
    )
