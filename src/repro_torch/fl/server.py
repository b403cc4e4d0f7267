"""Server orchestration (port of ``repro.fl.server``): the synchronous
FedPart / FNU round loop, and the dispatch to the event-driven async
runtime (``runtime="async"``, ``fl.runtime.engine``).

Per synchronous round: select the trainable group from the schedule, train
the sampled clients locally, average exactly the transmitted parameters
(the full network on FNU rounds, the trainable group's subtree on partial
rounds; BN running statistics never travel), evaluate the global model on
the balanced set, and book communication / computation costs.  The
host-side draws (cohort sampling from ``np.random.default_rng(seed)``,
per-(round, client) seeds) are the reference's, in the same order, so a run
given the reference's initial parameters replays the reference's batches
exactly.

``clients_data`` is a list of ``ClientDataset`` or a ``ClientPopulation``
(e.g. a streamed ``SyntheticPopulation`` of a million clients): either
way only the sampled cohort's shards are built.

``FLRunConfig(compression=...)`` compresses the transmitted subtree at the
client-to-server boundary (int8 / 1-bit / top-k with per-client error
feedback, ``core.compress``), and the communication book then prices the
encoded wire format; ``"none"`` (the default) leaves every path as it was.
Per-client state that outlives a round (MOON's previous local models, the
error-feedback residuals) lives in one ``ClientStateStore``, bounded and
spilled to disk with ``state_store_entries`` / ``state_store_spill``.
``track_stepsizes`` records every local step's update norm of each round's
first client (sequential engine, sync runtime; Fig. 1).

Everything runs on ``FLRunConfig.device`` — ``"cuda"`` unless the caller
asks for ``"cpu"`` — and a CUDA device without a card raises.
``engine="shard_map"`` shards each round's clients over the ranks of a
``torch.distributed`` client mesh of ``sim_devices`` ranks (0 = all; NCCL
on ``"cuda"``, gloo on ``"cpu"``): run one process per device, each
calling ``run_federated`` with the same config (``torchrun``; without a
launcher the mesh is this one process).  Every rank returns the same
result.  The reference's ``donate_buffers`` has no field: there is
nothing to donate.

Each synchronous round runs inside a profiler range
(``torch.profiler.record_function``) ``FL_ROUND``, its eval inside
``FL_EVAL``; the engines label the phases in between (``fl.batched``,
``fl.client``).  A round is a barrier, so a phase belongs to the round
whose range holds it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import compress
from repro_torch.core.costs import VirtualTimeModel, comm_cost, comp_cost
from repro_torch.core.partition import Partition, group_param_counts
from repro_torch.core.schedule import PlanAssigner, RoundSpec
from repro_torch.core.telemetry import StepSizeTracker, Timeline
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.fl.algorithms import AlgoConfig
from repro_torch.fl.batched import make_engine
from repro_torch.fl.client import LocalTrainer
from repro_torch.fl.population import (ClientPopulation, ClientStateStore,
                                       as_population, client_round_seed,
                                       resolve_cohort_size,
                                       sample_without_replacement)
from repro_torch.fl.runtime.clients import AvailabilityConfig
from repro_torch.fl.tasks import TaskAdapter
from repro_torch.optim.adam import AdamConfig
from repro_torch.tree import PyTree, tree_map

RUNTIMES = ("sync", "async")

# profiler labels of the synchronous round loop
FL_ROUND = "fl.round"   # a whole round: cohort draw to its history entry
FL_EVAL = "fl.eval"     # the global model's eval (its accuracy stays on the device)


@dataclasses.dataclass(frozen=True)
class FLRunConfig:
    local_epochs: int = 8
    batch_size: int = 32
    lr: float = 1e-3
    adam_eps: float = 1e-8
    algo: AlgoConfig = AlgoConfig()
    sample_fraction: float = 1.0    # participation fraction per dispatch/round
    cohort_size: int = 0            # explicit clients per dispatch (0 = use fraction)
    # async cohort selection: "blind" filters each candidate through its own
    # arrival draw; "biased" weights candidates by current availability and
    # records inclusion probabilities for debiased merges
    participation_sampling: str = "blind"   # "blind" | "biased" (async only)
    seed: int = 0
    eval_every: int = 1
    eval_batch: int = 256
    track_stepsizes: bool = False   # Fig. 1 step sizes (sync, sequential engine)
    engine: str = "sequential"
    sim_devices: int = 0            # shard_map mesh size (0 = every rank)
    fused_adam: bool = False        # masked-Adam CUDA kernel local steps
    # -- transmitted-subtree compression (core.compress)
    compression: str = "none"       # "none" | "int8" | "onebit" | "topk"
    topk_fraction: float = 0.01     # retained fraction per leaf (topk only)
    error_feedback: bool = True     # per-client EF residuals (compressed kinds)
    compression_block_rows: int = 0  # scale granularity: 0 = per leaf, B = B*128-elem blocks
    plan: str = "homogeneous"       # "homogeneous" | "nested" | "random"
    capacity_tiers: tuple[float, ...] = ()
    state_store_entries: int = 0    # LRU cap on MOON prevs + EF residuals (0 = unbounded)
    state_store_spill: str = ""     # spill dir for evicted entries ("" = drop on evict)
    # -- runtime (sync barrier loop vs event-driven async simulator) --------
    runtime: str = "sync"           # "sync" | "async" (fl.runtime)
    async_policy: str = "fedbuff"   # "fedbuff" | "sync" (barrier oracle)
    buffer_k: int = 0               # FedBuff goal K (0 = cohort size)
    staleness_exponent: float = 0.0  # poly staleness discount (1+s)^-a
    availability: AvailabilityConfig = AvailabilityConfig()
    vtime: VirtualTimeModel = VirtualTimeModel()
    max_inflight_cohorts: int = 1   # cohorts in flight at once (async)
    # -- adaptive server control loop (fl.runtime.control)
    controller: str = "static"      # "static" (no controller object) | "adaptive"
    controller_window: int = 4      # merges per observation window
    controller_inflight_bounds: tuple[int, int] = (1, 4)  # adaptive inflight lo/hi
    controller_buffer_bounds: tuple[int, int] = (1, 8)    # adaptive buffer_k lo/hi
    controller_mix_floor: float = 0.5  # min windowed discounted mixing coeff
    controller_max_repeats: int = 2    # consecutive layer-group repeats cap
    controller_participation_target: float = 0.0  # windowed target (0 = off)
    controller_cohort_bounds: tuple[int, int] = (1, 64)
    controller_plan_boost_max: int = 0  # extra plan-prefix groups cap (0 = off)
    device: str = "cuda"            # "cuda" | "cuda:N" | "cpu"; no fallback

    def __post_init__(self):
        if not 0.0 < self.sample_fraction <= 1.0:
            raise ValueError(
                f"sample_fraction must be in (0, 1], got {self.sample_fraction}")
        if self.cohort_size < 0:
            raise ValueError(f"cohort_size must be >= 0, got {self.cohort_size}")
        if self.participation_sampling not in ("blind", "biased"):
            raise ValueError(
                f"unknown participation_sampling {self.participation_sampling!r}; "
                "expected 'blind' or 'biased'")
        if not 0.0 <= self.controller_participation_target <= 1.0:
            raise ValueError(
                f"controller_participation_target must be in [0, 1], got "
                f"{self.controller_participation_target}")
        lo, hi = self.controller_cohort_bounds
        if not 1 <= lo <= hi:
            raise ValueError(
                f"controller_cohort_bounds must satisfy 1 <= lo <= hi, got "
                f"{self.controller_cohort_bounds}")
        if self.controller_plan_boost_max < 0:
            raise ValueError(
                f"controller_plan_boost_max must be >= 0, got "
                f"{self.controller_plan_boost_max}")
        if self.runtime not in RUNTIMES:
            raise ValueError(
                f"unknown runtime {self.runtime!r}; expected one of {RUNTIMES}")
        self.compression_config()       # validates the compression fields
        resolve_device(self.device)

    def compression_config(self) -> compress.CompressionConfig | None:
        return compress.make_config(
            self.compression, topk_fraction=self.topk_fraction,
            error_feedback=self.error_feedback,
            block_rows=self.compression_block_rows)

    def make_state_store(self) -> ClientStateStore:
        return ClientStateStore(max_entries=self.state_store_entries,
                                spill_dir=self.state_store_spill or None)


@dataclasses.dataclass
class FLResult:
    history: list[dict]
    params: PyTree
    partition: Partition
    tracker: StepSizeTracker | None
    comm_total_bytes: int
    comp_total_flops: float
    comm_fnu_bytes: int
    comp_fnu_flops: float
    timeline: Timeline | None = None   # async runtime: virtual-clock event log
    host_seconds: dict | None = None   # async runtime: dispatch / launch / resolve / merge / eval

    @property
    def best_acc(self) -> float:
        accs = [h["acc"] for h in self.history if "acc" in h]
        return max(accs) if accs else float("nan")

    @property
    def final_acc(self) -> float:
        accs = [h["acc"] for h in self.history if "acc" in h]
        return accs[-1] if accs else float("nan")


def _to_host(t):
    """A round's device numbers start their copy to the host without
    waiting for the card (a copy, no kernel); ``_read_back`` waits once."""
    return t.detach().to("cpu", non_blocking=True) if isinstance(t, torch.Tensor) else t


def _read_back(history: list[dict]) -> None:
    """The entries' losses (their clients' mean) and accuracies as floats,
    after one wait for the card: the rounds queue on the device without
    the host reading each round's numbers."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for h in history:
        h["loss"] = float(np.mean(h["loss"].tolist() if isinstance(h["loss"], torch.Tensor)
                                  else h["loss"]))
        if "acc" in h:
            h["acc"] = float(h["acc"])


def run_federated(
    adapter: TaskAdapter,
    clients_data: Sequence | ClientPopulation,
    eval_set: tuple[np.ndarray, np.ndarray],
    rounds: Sequence[RoundSpec],
    run_cfg: FLRunConfig,
    *,
    init_params: PyTree | None = None,
    verbose: bool = False,
) -> FLResult:
    """Run the federation.  ``init_params`` (a tree of tensors or numpy
    arrays, e.g. the reference's initial parameters bridged over numpy) is
    copied to the run's device; without it the adapter draws its initial
    parameters from a ``torch.Generator`` seeded with ``run_cfg.seed``.
    Each history entry also records the round's host ``seconds``: the
    host's time to queue the round: the losses and accuracies are copied to
    the host as the card reaches them, and read after one wait once the
    rounds are queued."""
    if run_cfg.runtime == "async":
        from repro_torch.fl.runtime.engine import run_federated_async
        return run_federated_async(adapter, clients_data, eval_set, rounds, run_cfg,
                                   init_params=init_params, verbose=verbose)
    if run_cfg.participation_sampling != "blind":
        raise ValueError("participation_sampling='biased' needs the arrival "
                         "process; use runtime='async'")
    if run_cfg.track_stepsizes and run_cfg.engine != "sequential":
        raise ValueError("track_stepsizes requires engine='sequential'")
    device = resolve_device(run_cfg.device)
    if device.type == "cuda":
        strict_fp32()
    if init_params is None:
        init_params = adapter.init(torch.Generator().manual_seed(run_cfg.seed))
    params = tree_map(lambda a: torch.as_tensor(a).to(device, copy=True),
                      init_params)
    partition = adapter.partition(params)
    trainer = LocalTrainer(adapter=adapter, partition=partition,
                           algo=run_cfg.algo,
                           adam=AdamConfig(lr=run_cfg.lr, eps=run_cfg.adam_eps))
    ccfg = run_cfg.compression_config()
    state_store = run_cfg.make_state_store()
    engine = make_engine(run_cfg.engine, trainer=trainer, partition=partition,
                         algo=run_cfg.algo, sim_devices=run_cfg.sim_devices,
                         fused_adam=run_cfg.fused_adam, compression=ccfg,
                         state_store=state_store, device_type=device.type)
    assigner = PlanAssigner(
        num_groups=partition.num_groups, kind=run_cfg.plan,
        capacity_tiers=tuple(run_cfg.capacity_tiers), seed=run_cfg.seed)
    rng = np.random.default_rng(run_cfg.seed)
    eval_x = torch.as_tensor(eval_set[0][: run_cfg.eval_batch], device=device)
    eval_y = torch.as_tensor(eval_set[1][: run_cfg.eval_batch], device=device)
    tracker = StepSizeTracker() if run_cfg.track_stepsizes else None
    history: list[dict] = []
    is_moon = run_cfg.algo.name == "moon"

    # a list becomes a materialised population; only the cohort is touched
    population = as_population(clients_data)
    n_clients = population.num_clients
    for spec in rounds:
        with record_function(FL_ROUND):
            t0 = time.perf_counter()
            n_pick = resolve_cohort_size(n_clients, run_cfg.sample_fraction,
                                         run_cfg.cohort_size)
            picked = sample_without_replacement(rng, n_clients, n_pick)
            if tracker is not None:
                tracker.mark_round_boundary()
            datasets = [population.dataset(ci) for ci in picked]
            seeds = [client_round_seed(run_cfg.seed, spec.index, ci) for ci in picked]
            weights = [len(d) for d in datasets]
            prevs = ([state_store.get("moon", int(ci)) for ci in picked]
                     if is_moon else None)

            params, losses, new_locals = engine.run_round(
                params, spec, datasets, seeds=seeds, weights=weights,
                epochs=run_cfg.local_epochs, batch_size=run_cfg.batch_size,
                prev_params=prevs, tracker=tracker,
                plan=assigner.assign(spec, [int(ci) for ci in picked]),
                client_ids=[int(ci) for ci in picked])
            if new_locals is not None:
                for ci, local in zip(picked, new_locals):
                    state_store.put("moon", int(ci), local)

            entry = {"round": spec.index, "phase": spec.phase, "group": spec.group,
                     "loss": _to_host(losses)}
            if spec.index % run_cfg.eval_every == 0 or spec.index == len(rounds) - 1:
                with record_function(FL_EVAL):
                    entry["acc"] = _to_host(adapter.evaluate(params, eval_x, eval_y))
            entry["seconds"] = time.perf_counter() - t0
            history.append(entry)
        if verbose:
            _read_back(history[-1:])
            print(f"round {spec.index:3d} [{spec.phase}:{spec.group:3d}] "
                  f"loss={entry['loss']:.4f} acc={entry.get('acc', float('nan')):.4f}")

    _read_back(history)

    # Cost bookkeeping (per client, per the paper's Comm./Comp. metrics).
    group_weights = group_param_counts(params, partition).astype(np.float64)
    comm = comm_cost(params, partition, rounds, compression=ccfg)
    comp = comp_cost(partition, rounds, group_fwd_flops=group_weights)
    return FLResult(
        history=history,
        params=params,
        partition=partition,
        tracker=tracker,
        comm_total_bytes=comm.total_bytes,
        comp_total_flops=float(comp.total_flops),
        comm_fnu_bytes=comm.fnu_total_bytes,
        comp_fnu_flops=float(comp.fnu_total_flops),
    )
