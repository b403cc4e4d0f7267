"""FL training driver, the paper's end-to-end entry point (port of
``repro.launch.train``).

Runs federated training (FNU baseline or FedPart) on the synthetic vision
or text task with the paper's models (ResNet-8/18, the nlp transformer),
prints per-round accuracy and the comm/comp cost ledger, and writes a JSON
result (``--out``) and a checkpoint (``--checkpoint-dir``,
``checkpoint.io``'s layout, which the reference reads too).  Data and
schedules are numpy-seeded, identical to the reference's; initial params
come from a ``torch.Generator`` seeded with ``--seed``.

    python -m repro_torch.launch.train --task resnet8 --strategy fedpart \\
        --clients 8 --cycles 2 --rl 2 --warmup 5 --device cpu
    python -m repro_torch.launch.train --task resnet8 --strategy fnu --rounds 30
    python -m repro_torch.launch.train --task nlp --strategy fedpart --algo fedprox

Everything runs on ``--device`` (default ``cuda``; no fallback).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core.schedule import FedPartSchedule, FNUSchedule
from repro_torch.data import (
    TextDatasetSpec,
    VisionDatasetSpec,
    balanced_eval_set,
    build_clients,
    dirichlet_partition,
    iid_partition,
    make_text_dataset,
    make_vision_dataset,
)
from repro_torch.fl import AlgoConfig, FLRunConfig, nlp_task, resnet_task, run_federated


def build_task_and_data(args):
    if args.task in ("resnet8", "resnet18"):
        spec = VisionDatasetSpec(num_classes=args.classes, image_size=args.image_size)
        x, y = make_vision_dataset(spec, args.samples, seed=args.seed)
        xe, ye = make_vision_dataset(spec, max(args.samples // 2, 200), seed=args.seed + 99)
        adapter = resnet_task(args.task, num_classes=args.classes)
    elif args.task == "nlp":
        spec = TextDatasetSpec(num_classes=4)
        x, y = make_text_dataset(spec, args.samples, seed=args.seed)
        xe, ye = make_text_dataset(spec, max(args.samples // 2, 200), seed=args.seed + 99)
        adapter = nlp_task(num_classes=4, smoke=args.smoke)
    else:
        raise SystemExit(f"unknown task {args.task}")

    if args.alpha > 0:
        parts = dirichlet_partition(y, args.clients, args.alpha, seed=args.seed)
    else:
        parts = iid_partition(len(y), args.clients, seed=args.seed)
    clients = build_clients(x, y, parts)
    eval_set = balanced_eval_set(xe, ye, per_class=args.eval_per_class)
    return adapter, clients, eval_set


def build_schedule(args, num_groups: int):
    if args.strategy == "fnu":
        total = args.rounds or (
            args.warmup + args.cycles * num_groups * args.rl
            + (args.cycles - 1) * args.bridge
        )
        return FNUSchedule(total=total)
    return FedPartSchedule(
        num_groups=num_groups,
        warmup_rounds=args.warmup,
        rounds_per_layer=args.rl,
        cycles=args.cycles,
        bridge_rounds=args.bridge,
        order=args.order,
        seed=args.seed,
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", default="resnet8",
                    choices=["resnet8", "resnet18", "nlp"])
    ap.add_argument("--strategy", default="fedpart", choices=["fedpart", "fnu"])
    ap.add_argument("--algo", default="fedavg",
                    choices=["fedavg", "fedprox", "moon"])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--classes", type=int, default=20)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="Dirichlet alpha (0 = IID)")
    ap.add_argument("--sample-fraction", type=float, default=1.0)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--rl", type=int, default=2, help="rounds per layer (R/L)")
    ap.add_argument("--cycles", type=int, default=1)
    ap.add_argument("--bridge", type=int, default=5)
    ap.add_argument("--order", default="sequential",
                    choices=["sequential", "reverse", "random"])
    ap.add_argument("--rounds", type=int, default=0,
                    help="FNU rounds (default: match FedPart budget)")
    ap.add_argument("--eval-per-class", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--track-stepsizes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args):
    """What ``main`` does; returns ``(summary, FLResult)``."""
    adapter, clients, eval_set = build_task_and_data(args)
    # Discover the group count from a throwaway init.
    probe = adapter.partition(adapter.init(torch.Generator().manual_seed(0)))
    schedule = build_schedule(args, probe.num_groups)
    print(f"[train] task={args.task} strategy={args.strategy} algo={args.algo} "
          f"groups={probe.num_groups} rounds={schedule.total_rounds} "
          f"clients={len(clients)}")

    run_cfg = FLRunConfig(
        local_epochs=args.local_epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        algo=AlgoConfig(name=args.algo),
        sample_fraction=args.sample_fraction,
        seed=args.seed,
        track_stepsizes=args.track_stepsizes,
        device=args.device,
    )
    t0 = time.time()
    result = run_federated(adapter, clients, eval_set, schedule.rounds(), run_cfg,
                           verbose=not args.quiet)
    elapsed = time.time() - t0

    summary = {
        "task": args.task,
        "strategy": args.strategy,
        "algo": args.algo,
        "best_acc": result.best_acc,
        "final_acc": result.final_acc,
        "rounds": schedule.total_rounds,
        "comm_bytes": result.comm_total_bytes,
        "comm_ratio_to_fnu": result.comm_total_bytes / max(result.comm_fnu_bytes, 1),
        "comp_flops": result.comp_total_flops,
        "comp_ratio_to_fnu": result.comp_total_flops / max(result.comp_fnu_flops, 1),
        "elapsed_s": elapsed,
        "history": result.history,
    }
    if result.tracker is not None:
        summary["stepsizes"] = result.tracker.sizes
        summary["boundaries"] = result.tracker.boundaries
        summary["post_agg_spike"] = result.tracker.post_aggregation_spike()
    print(f"[train] best_acc={result.best_acc:.4f} "
          f"comm={summary['comm_ratio_to_fnu']:.2%} of FNU, "
          f"comp={summary['comp_ratio_to_fnu']:.2%} of FNU, {elapsed:.0f}s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2, default=float)
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, result.params,
                        {"rounds": schedule.total_rounds, "best_acc": result.best_acc})
    return summary, result


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
