"""The paper's headline claim at a faithful operating point (port of
``experiments/claims_experiment.py``).

FedPart against FNU at the paper's 8 local epochs and matched
communication rounds: both runs' accuracy curves, the Eq. 5 communication
book and the computation book as fractions of FNU's, and the Fig. 1
post-aggregation step-size spike of each.  The data, schedule and run
config are the reference's; the local steps go through the masked-Adam
CUDA kernel with ``--fused-adam`` (one one-client launch per local step:
``track_stepsizes`` needs the sequential engine).

    python -m repro_torch.experiments.claims_experiment --fused-adam      # one H100
    python -m repro_torch.experiments.claims_experiment --device cpu \\
        --epochs 1 --samples 200 --cycles 1 --out /tmp/claims.json       # CPU, small
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.schedule import FedPartSchedule, matched_fnu
from repro_torch.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                              iid_partition, make_vision_dataset)
from repro_torch.fl import FLRunConfig, resnet_task, run_federated


def build(*, epochs: int = 8, clients: int = 4, samples: int = 800,
          classes: int = 16, noise: float = 1.2, cycles: int = 2,
          device: str = "cuda", fused_adam: bool = False, adam_eps: float = 1e-8):
    """``(adapter, clients, eval_set, schedule, run_cfg)`` at the
    reference's sizes unless told otherwise."""
    spec = VisionDatasetSpec(num_classes=classes, image_size=16, noise=noise)
    x, y = make_vision_dataset(spec, samples, seed=0)
    xe, ye = make_vision_dataset(spec, samples // 2, seed=99)
    eval_set = balanced_eval_set(xe, ye, per_class=16)
    data = build_clients(x, y, iid_partition(len(y), clients, seed=0))
    adapter = resnet_task("resnet8", num_classes=classes)
    sched = FedPartSchedule(num_groups=10, warmup_rounds=3, rounds_per_layer=1,
                            cycles=cycles, bridge_rounds=2)
    cfg = FLRunConfig(local_epochs=epochs, batch_size=32, lr=1e-3,
                      track_stepsizes=True, fused_adam=fused_adam, adam_eps=adam_eps,
                      device=device)
    return adapter, data, eval_set, sched, cfg


def summarize(fp, fnu, sched, cfg, elapsed_s: float) -> dict:
    """The reference's output dict from the FedPart and FNU ``FLResult``s."""
    return {
        "local_epochs": cfg.local_epochs,
        "rounds": sched.total_rounds,
        "fedpart": {"best_acc": fp.best_acc, "final_acc": fp.final_acc,
                    "comm_ratio": fp.comm_total_bytes / fp.comm_fnu_bytes,
                    "comp_ratio": fp.comp_total_flops / fp.comp_fnu_flops,
                    "spike": fp.tracker.post_aggregation_spike(),
                    "acc_curve": [h.get("acc") for h in fp.history]},
        "fnu": {"best_acc": fnu.best_acc, "final_acc": fnu.final_acc,
                "spike": fnu.tracker.post_aggregation_spike(),
                "acc_curve": [h.get("acc") for h in fnu.history]},
        "elapsed_s": elapsed_s,
    }


def run(*, verbose: bool = True, **build_kw) -> dict:
    """FedPart, then its matched FNU baseline, from ``build(**build_kw)``;
    the reference's output dict."""
    adapter, data, eval_set, sched, cfg = build(**build_kw)
    t0 = time.time()
    fp = run_federated(adapter, data, eval_set, sched.rounds(), cfg, verbose=verbose)
    fnu = run_federated(adapter, data, eval_set, matched_fnu(sched).rounds(), cfg,
                        verbose=verbose)
    return summarize(fp, fnu, sched, cfg, time.time() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--samples", type=int, default=800)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--noise", type=float, default=1.2)
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--out", default="experiments/claims_result_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused-adam", action="store_true",
                    help="local Adam steps through the masked-Adam CUDA kernel")
    args = ap.parse_args(argv)

    out = run(epochs=args.epochs, clients=args.clients, samples=args.samples,
              classes=args.classes, noise=args.noise, cycles=args.cycles,
              device=args.device, fused_adam=args.fused_adam)
    print(json.dumps(out, indent=2, default=float))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, default=float)
    return out


if __name__ == "__main__":
    main()
