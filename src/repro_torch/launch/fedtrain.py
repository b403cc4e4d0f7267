"""FedPart trainer for the served architectures, and the simulation's
command line (port of ``repro.launch.fedtrain``).

The mesh-trainer path (the default) runs the paper's round schedule over
the step functions of ``launch.steps`` on a served architecture: each
round runs the FNU step or the partial step of the scheduled layer group,
with fresh optimizer state over the group's subtree.  Round boundaries are
the communication rounds (under data parallelism the per-step gradient
all-reduce plays the server's part).  One card, no mesh: the reference's
sharded placement has no counterpart yet.  Its batches are random tokens
drawn from a ``torch.Generator``; the port does not reproduce jax's PRNG,
so its losses are not the reference's numbers (the tests feed both the
same batches instead).

    python -m repro_torch.launch.fedtrain --arch tinyllama-1.1b --rounds 8 \\
        --steps-per-round 4 --device cpu                   # smoke size
    python -m repro_torch.launch.fedtrain --arch tinyllama-1.1b --full-size \\
        --batch 4 --seq 512 --rounds 8                     # one H100

``--sim-clients N`` (or ``--population N``) runs the many-client
simulation instead (``fl.run_federated``) on the synthetic vision task,
with every flag of the reference: ``--engine sequential|vmap``,
``--fused-adam`` (local steps through the CUDA masked-Adam kernel),
``--runtime async`` and its FedBuff / availability / controller flags,
``--plan``, ``--compression`` and the streamed population:

    python -m repro_torch.launch.fedtrain --sim-clients 8 --rounds 12 \\
        --batch 32 --engine vmap --fused-adam --device cpu

``--engine shard_map`` shards each round's clients over a
``torch.distributed`` client mesh of ``--sim-devices`` ranks (0 = every
rank), one process per device: alone, the mesh is this one process; under
``torchrun`` the ranks join the group from the environment, each on
``cuda:LOCAL_RANK`` (or the CPU, over gloo), and only rank 0 prints:

    torchrun --nproc-per-node 2 -m repro_torch.launch.fedtrain \\
        --sim-clients 8 --engine shard_map --device cpu

The reference's ``_simdev.force_sim_devices`` (an XLA flag for simulated
host devices) is not applicable: torch has no simulated devices, so N
ranks are N processes.

Everything runs on ``--device`` (default ``cuda``; no fallback).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.schedule import FULL_NETWORK, FedPartSchedule, RoundSpec
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models.api import InputShape
from repro_torch.optim.adam import AdamConfig
from repro_torch.tree import PyTree, tree_leaves

FNU_SPEC = RoundSpec(0, "warmup", -1, FULL_NETWORK)


class FedPartMeshTrainer:
    """Round loop cycling layer groups over partial steps.

    One step per distinct group is cached; optimizer state is
    re-initialised per round over the group's subtree (paper semantics:
    clients start each round fresh from the broadcast model).  The
    reference's ``donate`` (XLA buffer donation) has no counterpart."""

    def __init__(self, cfg, adam: AdamConfig = AdamConfig(), *, remat: bool = False):
        self.cfg = cfg
        self.adam = adam
        self.remat = remat
        self._full = steps.make_train_step(cfg, adam, remat=remat)
        self._partial: dict[int, object] = {}
        self._groups: list[steps.StackedGroup] | None = None

    def groups(self, params) -> list[steps.StackedGroup]:
        if self._groups is None:
            self._groups = steps.list_groups(params)
        return self._groups

    def _partial_step(self, params, gidx: int):
        if gidx not in self._partial:
            group = self.groups(params)[gidx]
            self._partial[gidx] = steps.make_fedpart_train_step(
                self.cfg, group, self.adam, remat=self.remat)
        return self._partial[gidx]

    def run_round(self, params, spec: RoundSpec, batches) -> tuple[PyTree, float]:
        """One communication round: several local steps of the scheduled
        group (or the full network), fresh optimizer state; returns the new
        params and the mean of the steps' losses."""
        if spec.is_full:
            opt = steps.init_opt_state(params)
            step = self._full
        else:
            gidx = spec.group % len(self.groups(params))
            opt = steps.init_partial_opt_state(params, self.groups(params)[gidx])
            step = self._partial_step(params, gidx)
        losses = []
        for batch in batches:
            params, opt, loss = step(params, opt, batch)
            losses.append(loss)
        return params, float(np.mean([float(x) for x in losses]))

    def transmitted_params(self, params, spec: RoundSpec) -> int:
        """Parameter count this round's aggregation moves (ledger)."""
        if spec.is_full:
            return int(sum(x.numel() for x in tree_leaves(params)))
        group = self.groups(params)[spec.group % len(self.groups(params))]
        sub = steps._select_group(params, group)
        return int(sum(x.numel() for x in tree_leaves(sub)))


def run_mesh(args) -> tuple[PyTree, list[dict]]:
    """The mesh-trainer path of ``main``: returns the final params and one
    record per round (``round``, ``group``, ``loss``, ``tx``, host
    ``seconds`` ended by the loss's device sync, and on a card
    ``peak_bytes``, the round's ``torch.cuda.max_memory_allocated``)."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        strict_fp32()
    cfg = get_config(args.arch, smoke=not args.full_size)
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    batch_gen = torch.Generator(device=dev).manual_seed(1)
    trainer = FedPartMeshTrainer(cfg, AdamConfig(lr=args.lr))
    n_groups = len(trainer.groups(params))
    sched = FedPartSchedule(num_groups=n_groups, warmup_rounds=args.warmup,
                            rounds_per_layer=args.rl, cycles=10_000)
    shape = InputShape("t", args.seq, args.batch, "train")

    records, total_tx, full_tx = [], 0, 0
    t_all = time.perf_counter()
    for spec in sched.rounds()[: args.rounds]:
        batches = [api.synth_batch(batch_gen, cfg, shape, dev)
                   for _ in range(args.steps_per_round)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params, loss = trainer.run_round(params, spec, batches)
        rec = {"round": spec.index, "group": spec.group, "loss": loss,
               "seconds": time.perf_counter() - t0,
               "tx": trainer.transmitted_params(params, spec)}
        if dev.type == "cuda":
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        records.append(rec)
        total_tx += rec["tx"]
        full_tx += trainer.transmitted_params(params, FNU_SPEC)
        tag = "FNU " if spec.is_full else f"g={spec.group:3d}"
        mem = (f" peak={rec['peak_bytes'] / 2**30:.2f}GiB" if "peak_bytes" in rec
               else "")
        print(f"[fedtrain] round {spec.index:3d} [{tag}] loss={loss:.4f} "
              f"tx={rec['tx'] / 1e6:.2f}M params {rec['seconds']:.3f}s{mem}")
    print(f"[fedtrain] {len(records)} rounds in {time.perf_counter() - t_all:.0f}s | "
          f"comm={total_tx / max(full_tx, 1):.2%} of FNU")
    return params, records


def build_simulation(args):
    """``(adapter, clients, eval_set, rounds, run_cfg)`` of the
    ``--sim-clients`` / ``--population`` mode: the reference's synthetic
    vision task, data and schedule (numpy-seeded, so identical)."""
    from repro_torch.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                                  iid_partition, make_vision_dataset)
    from repro_torch.fl import (AvailabilityConfig, FLRunConfig, SyntheticPopulation,
                                resnet_task)

    spec = VisionDatasetSpec(num_classes=8, image_size=16)
    xe, ye = make_vision_dataset(spec, 400, seed=99)
    eval_set = balanced_eval_set(xe, ye, per_class=24)
    if args.population > 0:
        # Streaming population: shards derive lazily from (seed, client_id);
        # nothing O(population) is ever built.
        clients = SyntheticPopulation(spec=spec, population=args.population,
                                      samples_per_client=160, seed=0)
    else:
        x, y = make_vision_dataset(spec, 160 * args.sim_clients, seed=0)
        clients = build_clients(x, y, iid_partition(len(y), args.sim_clients, seed=0))
    adapter = resnet_task("resnet8", num_classes=8)
    cycles = max(1, -(-args.rounds // (10 * args.rl)))   # just enough rounds
    sched = FedPartSchedule(num_groups=10, warmup_rounds=args.warmup,
                            rounds_per_layer=args.rl, cycles=cycles)
    rank, local_rank = launcher_ranks()
    device, spill = args.device, args.state_store_spill
    if device == "cuda" and local_rank is not None:
        device = f"cuda:{local_rank}"
    if spill and rank:
        spill = os.path.join(spill, f"rank{rank}")   # each rank spills its own copy
    cfg = FLRunConfig(local_epochs=1, batch_size=args.batch, lr=args.lr,
                      engine=args.engine, sim_devices=args.sim_devices,
                      fused_adam=args.fused_adam,
                      runtime=args.runtime, async_policy=args.async_policy,
                      buffer_k=args.buffer_k,
                      staleness_exponent=args.staleness_exp,
                      sample_fraction=args.participation,
                      cohort_size=args.cohort_size,
                      participation_sampling=args.participation_sampling,
                      state_store_entries=args.state_store_entries,
                      state_store_spill=spill,
                      max_inflight_cohorts=args.max_inflight,
                      controller=args.controller,
                      controller_window=args.controller_window,
                      controller_inflight_bounds=tuple(args.controller_inflight_bounds),
                      controller_buffer_bounds=tuple(args.controller_buffer_bounds),
                      controller_mix_floor=args.controller_mix_floor,
                      controller_max_repeats=args.controller_max_repeats,
                      controller_participation_target=(
                          args.controller_participation_target),
                      controller_cohort_bounds=tuple(args.controller_cohort_bounds),
                      controller_plan_boost_max=args.controller_plan_boost_max,
                      plan=args.plan,
                      capacity_tiers=tuple(args.capacity_tiers),
                      compression=args.compression,
                      topk_fraction=args.topk_fraction,
                      error_feedback=not args.no_error_feedback,
                      compression_block_rows=args.compression_block_rows,
                      availability=AvailabilityConfig(
                          speed_spread=args.speed_spread,
                          latency_jitter=args.latency_jitter,
                          dropout_prob=args.dropout,
                          unavailable_prob=args.unavailable,
                          trace=args.trace,
                          trace_period=args.trace_period,
                          duty_cycle=tuple(args.duty_cycle),
                          trace_path=args.trace_path),
                      device=device)
    return adapter, clients, eval_set, sched.rounds()[: args.rounds], cfg


def launcher_ranks() -> tuple[int, int | None]:
    """(``RANK``, ``LOCAL_RANK``) as ``torchrun`` sets them; (0, None)
    without a launcher."""
    local = os.environ.get("LOCAL_RANK")
    return int(os.environ.get("RANK", 0)), None if local is None else int(local)


def run_simulation(args):
    """Many-client FL simulation (``fl``) behind the launch surface;
    returns the ``FLResult``."""
    from repro_torch.fl import run_federated

    adapter, clients, eval_set, rounds, cfg = build_simulation(args)
    n_clients = args.population if args.population > 0 else args.sim_clients
    lead = launcher_ranks()[0] == 0        # only rank 0 prints
    t0 = time.time()
    res = run_federated(adapter, clients, eval_set, rounds, cfg, verbose=lead)
    if not lead:
        return res
    extra = ""
    if res.timeline is not None:
        stale = [h["staleness_max"] for h in res.history]
        extra = (f" vtime={res.timeline.total_seconds:.3f}s "
                 f"max_staleness={max(stale) if stale else 0}")
    print(f"[fedtrain.sim] engine={args.engine} runtime={args.runtime} "
          f"clients={n_clients} rounds={args.rounds} "
          f"in {time.time() - t0:.1f}s | best_acc={res.best_acc:.4f} "
          f"comm={res.comm_total_bytes / max(res.comm_fnu_bytes, 1):.2%} of FNU"
          f"{extra}")
    return res


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full-size", action="store_true",
                    help="full config (one H100); default smoke")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps-per-round", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--rl", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--sim-clients", type=int, default=0,
                    help="simulate N federated clients (fl stack) instead of "
                         "the mesh trainer")
    ap.add_argument("--population", type=int, default=0,
                    help="stream N virtual clients from a seeded "
                         "SyntheticPopulation instead of materialising "
                         "--sim-clients shards up front; per-round host cost "
                         "is O(cohort), so N can be millions")
    ap.add_argument("--cohort-size", type=int, default=0,
                    help="explicit clients per dispatch/round (0 = "
                         "--participation fraction of the fleet); the natural "
                         "knob under --population")
    ap.add_argument("--state-store-entries", type=int, default=0,
                    help="LRU cap on per-client MOON/EF state entries "
                         "(0 = unbounded)")
    ap.add_argument("--state-store-spill", default="",
                    help="directory to spill evicted per-client state to "
                         "(empty = evicted entries are dropped)")
    ap.add_argument("--engine", choices=["sequential", "vmap", "shard_map"],
                    default="sequential",
                    help="client engine for --sim-clients: per-client oracle "
                         "loop (default), batched vmap-over-clients, or "
                         "shard_map over a torch.distributed client mesh "
                         "(see --sim-devices)")
    ap.add_argument("--fused-adam", action="store_true",
                    help="run local steps through the CUDA masked-Adam kernel "
                         "(packed optimizer state; its plain version on the CPU)")
    ap.add_argument("--sim-devices", type=int, default=0,
                    help="shard_map mesh size over the 'clients' axis (0 = "
                         "every rank; start N ranks with torchrun "
                         "--nproc-per-node N)")
    ap.add_argument("--runtime", choices=["sync", "async"], default="sync",
                    help="round execution model for --sim-clients: barrier "
                         "per round, or the event-driven async simulator")
    ap.add_argument("--async-policy", choices=["fedbuff", "sync"],
                    default="fedbuff",
                    help="async aggregation policy: FedBuff goal-K buffer or "
                         "the per-cohort barrier oracle")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients sampled per dispatch/round")
    ap.add_argument("--participation-sampling", choices=["blind", "biased"],
                    default="blind",
                    help="async cohort selection: rejection-sample the "
                         "arrival process blind (default), or weight "
                         "candidates by current availability and debias the "
                         "merge by inverse inclusion probability")
    ap.add_argument("--buffer-k", type=int, default=0,
                    help="FedBuff merge goal K (0 = cohort size)")
    ap.add_argument("--staleness-exp", type=float, default=0.0,
                    help="polynomial staleness discount exponent a in "
                         "(1+staleness)^-a")
    ap.add_argument("--max-inflight", type=int, default=1,
                    help="cohorts concurrently in flight under --runtime "
                         "async: 1 = merge-driven dispatch, >1 queues that "
                         "many cohorts on the device slots")
    ap.add_argument("--controller", choices=["static", "adaptive"],
                    default="static",
                    help="server control loop under --runtime async: static "
                         "config (default, no controller object) or the "
                         "adaptive bundle that re-targets --max-inflight, "
                         "--buffer-k, and the layer-group schedule between "
                         "merges")
    ap.add_argument("--controller-window", type=int, default=4,
                    help="merges per controller observation window")
    ap.add_argument("--controller-inflight-bounds", type=int, nargs=2,
                    default=[1, 4], metavar=("LO", "HI"),
                    help="adaptive in-flight cohort target bounds")
    ap.add_argument("--controller-buffer-bounds", type=int, nargs=2,
                    default=[1, 8], metavar=("LO", "HI"),
                    help="adaptive FedBuff goal-K bounds")
    ap.add_argument("--controller-mix-floor", type=float, default=0.5,
                    help="windowed discounted-mixing-coefficient floor the "
                         "staleness controller defends")
    ap.add_argument("--controller-max-repeats", type=int, default=2,
                    help="max consecutive layer-group repeats the progress "
                         "controller may schedule")
    ap.add_argument("--controller-participation-target", type=float,
                    default=0.0,
                    help="windowed effective-participation target the "
                         "participation controller holds by re-sizing the "
                         "cohort (0 = controller off)")
    ap.add_argument("--controller-cohort-bounds", type=int, nargs=2,
                    default=[1, 64], metavar=("LO", "HI"),
                    help="adaptive cohort-size bounds for the participation "
                         "controller")
    ap.add_argument("--controller-plan-boost-max", type=int, default=0,
                    help="max extra layer groups the plan-assignment "
                         "controller may grant stalled-tier clients "
                         "(0 = controller off; needs --plan nested|random)")
    ap.add_argument("--plan", choices=["homogeneous", "nested", "random"],
                    default="homogeneous",
                    help="per-client layer plan for --sim-clients: every "
                         "client trains the scheduled group (default), "
                         "FedPLT-style capacity prefixes, or seeded random "
                         "per-client group subsets")
    ap.add_argument("--capacity-tiers", type=float, nargs="*", default=[],
                    help="capacity fractions in (0, 1], one per tier, clients "
                         "assigned round-robin (e.g. 0.3 0.6 1.0); empty = "
                         "one full-capacity tier")
    ap.add_argument("--compression",
                    choices=["none", "int8", "onebit", "topk"],
                    default="none",
                    help="transmitted-subtree compression for --sim-clients: "
                         "symmetric int8, 1-bit sign+scale, or top-k "
                         "sparsification, each with per-client error feedback")
    ap.add_argument("--topk-fraction", type=float, default=0.01,
                    help="retained fraction per leaf under --compression topk")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the per-client error-feedback residual "
                         "(compressed kinds only)")
    ap.add_argument("--compression-block-rows", type=int, default=0,
                    help="quantisation scale granularity: 0 = one scale per "
                         "leaf, B = one per B*128-element block (the masked-"
                         "Adam packed-row layout)")
    ap.add_argument("--speed-spread", type=float, default=0.0,
                    help="per-client compute-speed heterogeneity (log-uniform "
                         "spread; 0 = homogeneous fleet)")
    ap.add_argument("--latency-jitter", type=float, default=0.0,
                    help="per-dispatch multiplicative latency noise")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-dispatch probability a client update is lost")
    ap.add_argument("--unavailable", type=float, default=0.0,
                    help="per-dispatch probability a sampled client is "
                         "offline (the i.i.d. arrival knob)")
    ap.add_argument("--trace", choices=["", "diurnal", "file"], default="",
                    help="trace-driven availability: deterministic per-client "
                         "periodic on/off windows (diurnal) or an on-disk "
                         "trace (file; see --trace-path)")
    ap.add_argument("--trace-period", type=float, default=16.0,
                    help="virtual seconds per on/off trace cycle")
    ap.add_argument("--duty-cycle", type=float, nargs=2, default=[1.0, 1.0],
                    metavar=("LO", "HI"),
                    help="per-client on-fraction range for --trace diurnal")
    ap.add_argument("--trace-path", default="",
                    help="availability trace file (.npz or JSON with "
                         "duty/phase arrays) for --trace file")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.sim_clients > 0 or args.population > 0:
        run_simulation(args)
    else:
        run_mesh(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
