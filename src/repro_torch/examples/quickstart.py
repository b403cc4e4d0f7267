"""Quickstart: FedPart vs. full-network updates (FedAvg) on a synthetic
federated vision task — the paper's core comparison (Table 1) at small
scale (port of ``examples/quickstart.py``).

Runs both strategies with a matched round budget, prints accuracy curves
and the communication / computation ledger.

--engine selects the client-simulation engine: the sequential oracle (the
default), vmap (a bucket of clients per launch), or shard_map over a
``torch.distributed`` client mesh, one process per device: alone, the mesh
is this one process; under ``torchrun`` each rank joins it on
``cuda:LOCAL_RANK`` (or the CPU, over gloo), and only rank 0 prints.
--fused-adam sends every local step through the masked-Adam CUDA kernel.

    python -m repro_torch.examples.quickstart --fused-adam      # one H100
    python -m repro_torch.examples.quickstart --device cpu \\
        [--engine sequential|vmap|shard_map]
    torchrun --nproc-per-node 2 -m repro_torch.examples.quickstart \\
        --engine shard_map --device cpu

--population N streams the federation from N virtual clients whose shards
derive on demand from (seed, client_id) — try --population 1000000
--cohort-size 4: same demo, million-client fleet.
"""

from __future__ import annotations

import argparse

from repro_torch.core.schedule import FedPartSchedule, matched_fnu
from repro_torch.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                              iid_partition, make_vision_dataset)
from repro_torch.fl import FLRunConfig, SyntheticPopulation, resnet_task, run_federated
from repro_torch.launch.fedtrain import launcher_ranks


def build(*, engine: str = "sequential", sim_devices: int = 0,
          plan: str = "homogeneous", capacity_tiers=(), compression: str = "none",
          population: int = 0, cohort_size: int = 0, device: str = "cuda",
          fused_adam: bool = False, samples: int = 1200,
          eval_samples: int = 600, samples_per_client: int = 300):
    """``(adapter, clients, eval_set, schedule, run_cfg)`` at the
    reference's sizes unless told otherwise.  Under ``torchrun`` a
    ``"cuda"`` device is the rank's ``cuda:LOCAL_RANK``."""
    spec = VisionDatasetSpec(num_classes=8, image_size=16, noise=1.0)
    xe, ye = make_vision_dataset(spec, eval_samples, seed=99)
    eval_set = balanced_eval_set(xe, ye, per_class=24)
    if population > 0:
        clients = SyntheticPopulation(spec=spec, population=population,
                                      samples_per_client=samples_per_client, seed=0)
        cohort = cohort_size or 4
    else:
        x, y = make_vision_dataset(spec, samples, seed=0)
        clients = build_clients(x, y, iid_partition(len(y), 4, seed=0))
        cohort = cohort_size
    adapter = resnet_task("resnet8", num_classes=8)
    schedule = FedPartSchedule(num_groups=10, warmup_rounds=2, rounds_per_layer=1,
                               cycles=1)
    local_rank = launcher_ranks()[1]
    if device == "cuda" and local_rank is not None:
        device = f"cuda:{local_rank}"
    cfg = FLRunConfig(local_epochs=1, batch_size=32, lr=1e-3, engine=engine,
                      sim_devices=sim_devices, plan=plan,
                      capacity_tiers=tuple(capacity_tiers), compression=compression,
                      cohort_size=cohort, fused_adam=fused_adam, device=device)
    return adapter, clients, eval_set, schedule, cfg


def run(*, rounds: int | None = None, verbose: bool = True, **build_kw):
    """FedPart, then its matched FNU baseline; returns ``(fedpart, fnu)``
    ``FLResult``s and prints the reference's summary (rank 0 only).
    ``rounds`` keeps only that many rounds of each schedule."""
    adapter, clients, eval_set, schedule, cfg = build(**build_kw)
    verbose = verbose and launcher_ranks()[0] == 0
    if verbose:
        print(f"=== FedPart (partial network updates) [engine={cfg.engine}"
              + (f", plan={cfg.plan}" if cfg.plan != "homogeneous" else "")
              + (f", compression={cfg.compression}"
                 if cfg.compression != "none" else "")
              + "] ===")
    fp = run_federated(adapter, clients, eval_set, schedule.rounds()[:rounds], cfg,
                       verbose=verbose)
    if verbose:
        print("\n=== FedAvg-FNU (full network updates, matched rounds) ===")
    fnu = run_federated(adapter, clients, eval_set,
                        matched_fnu(schedule).rounds()[:rounds], cfg, verbose=verbose)
    if verbose:
        print("\n================ summary ================")
        print(f"{'':12s} {'best acc':>9s} {'comm (MB)':>10s} {'comp ratio':>10s}")
        print(f"{'FedPart':12s} {fp.best_acc:9.4f} {fp.comm_total_bytes/1e6:10.1f} "
              f"{fp.comp_total_flops/fp.comp_fnu_flops:10.2%}")
        print(f"{'FedAvg-FNU':12s} {fnu.best_acc:9.4f} "
              f"{fnu.comm_total_bytes/1e6:10.1f} {'100.00%':>10s}")
        print(f"\nFedPart comm = {fp.comm_total_bytes/fnu.comm_total_bytes:.1%} of "
              f"FNU (paper Eq. 5: partial rounds move 1/M of the bytes)")
    return fp, fnu


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine", choices=["sequential", "vmap", "shard_map"],
                    default="sequential",
                    help="client-simulation engine (see module docstring)")
    ap.add_argument("--sim-devices", type=int, default=0,
                    help="shard_map mesh size (0 = every rank; else the world size)")
    ap.add_argument("--plan", choices=["homogeneous", "nested", "random"],
                    default="homogeneous",
                    help="per-client layer plan: capacity-tiered clients train "
                         "different group subsets in the same round")
    ap.add_argument("--capacity-tiers", type=float, nargs="*", default=[],
                    help="tier capacity fractions in (0, 1], clients "
                         "round-robin (e.g. 0.3 0.6 1.0)")
    ap.add_argument("--compression", choices=["none", "int8", "onebit", "topk"],
                    default="none",
                    help="compress the transmitted subtree (int8 / 1-bit / top-k "
                         "with error feedback); the comm column then prices the "
                         "encoded bytes")
    ap.add_argument("--population", type=int, default=0,
                    help="stream N virtual clients from a seeded "
                         "SyntheticPopulation instead of materialising 4 shards; "
                         "per-round cost is O(cohort)")
    ap.add_argument("--cohort-size", type=int, default=0,
                    help="explicit clients per round (0 = full participation "
                         "of a materialised fleet, or 4 under --population)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused-adam", action="store_true",
                    help="local Adam steps through the masked-Adam CUDA kernel")
    args = ap.parse_args(argv)
    return run(engine=args.engine, sim_devices=args.sim_devices, plan=args.plan,
               capacity_tiers=args.capacity_tiers, compression=args.compression,
               population=args.population, cohort_size=args.cohort_size,
               device=args.device, fused_adam=args.fused_adam)


if __name__ == "__main__":
    main()
