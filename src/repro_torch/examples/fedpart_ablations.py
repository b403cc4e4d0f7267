"""Ablations from the paper at small scale: selection order (Table 7) and
warm-up duration (Table 6) on the synthetic vision task (port of
``examples/fedpart_ablations.py``).

    python -m repro_torch.examples.fedpart_ablations --fused-adam    # one H100
    python -m repro_torch.examples.fedpart_ablations --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.core.schedule import FedPartSchedule
from repro_torch.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                              iid_partition, make_vision_dataset)
from repro_torch.fl import FLRunConfig, resnet_task, run_federated

ORDERS = ("sequential", "reverse", "random")
WARMUPS = (0, 2, 5)


def build(order: str = "sequential", warmup: int = 2, *, samples: int = 1000,
          eval_samples: int = 500, device: str = "cuda", fused_adam: bool = False):
    """``(adapter, clients, eval_set, schedule, run_cfg)`` of one ablation
    run, at the reference's sizes unless told otherwise."""
    spec = VisionDatasetSpec(num_classes=8, image_size=16, noise=1.0)
    x, y = make_vision_dataset(spec, samples, seed=0)
    xe, ye = make_vision_dataset(spec, eval_samples, seed=9)
    eval_set = balanced_eval_set(xe, ye, per_class=24)
    clients = build_clients(x, y, iid_partition(len(y), 4, seed=0))
    adapter = resnet_task("resnet8", num_classes=8)
    schedule = FedPartSchedule(num_groups=10, warmup_rounds=warmup,
                               rounds_per_layer=1, cycles=1, order=order)
    cfg = FLRunConfig(local_epochs=1, batch_size=32, lr=1e-3, fused_adam=fused_adam,
                      device=device)
    return adapter, clients, eval_set, schedule, cfg


def run_one(order: str = "sequential", warmup: int = 2, *, rounds: int | None = None,
            **build_kw):
    """One ablation run; ``rounds`` keeps only that many of its rounds."""
    adapter, clients, eval_set, schedule, cfg = build(order, warmup, **build_kw)
    return run_federated(adapter, clients, eval_set, schedule.rounds()[:rounds], cfg)


def run(*, verbose: bool = True, **build_kw) -> dict:
    """The six runs; ``{("order", o) | ("warmup", w): FLResult}``, each line
    of the reference's summary printed."""
    out = {}
    if verbose:
        print("--- selection order (paper Table 7: seq > rev > rand) ---")
    for order in ORDERS:
        out["order", order] = res = run_one(order=order, **build_kw)
        if verbose:
            print(f"order={order:10s} best_acc={res.best_acc:.4f}")
    if verbose:
        print("--- warm-up rounds (paper Table 6) ---")
    for warmup in WARMUPS:
        out["warmup", warmup] = res = run_one(warmup=warmup, **build_kw)
        if verbose:
            print(f"warmup={warmup} best_acc={res.best_acc:.4f}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused-adam", action="store_true",
                    help="local Adam steps through the masked-Adam CUDA kernel")
    args = ap.parse_args(argv)
    return run(device=args.device, fused_adam=args.fused_adam)


if __name__ == "__main__":
    main()
