"""FedPart on the language modality (paper Table 3): federated text
classification with the small transformer, FedPart vs FNU, plus the
FedProx composition (port of ``examples/fedpart_language.py``).

    python -m repro_torch.examples.fedpart_language --fused-adam     # one H100
    python -m repro_torch.examples.fedpart_language --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.core.schedule import FedPartSchedule, matched_fnu
from repro_torch.data import (TextDatasetSpec, balanced_eval_set, build_clients,
                              dirichlet_partition, make_text_dataset)
from repro_torch.fl import AlgoConfig, FLRunConfig, nlp_task, run_federated

ALGOS = ("fedavg", "fedprox")


def build(*, samples: int = 1600, eval_samples: int = 800):
    """``(adapter, clients, eval_set, schedule)`` at the reference's sizes
    unless told otherwise."""
    spec = TextDatasetSpec(num_classes=4, vocab_size=512, seq_len=48)
    x, y = make_text_dataset(spec, samples, seed=0)
    xe, ye = make_text_dataset(spec, eval_samples, seed=7)
    eval_set = balanced_eval_set(xe, ye, per_class=48)
    # Mild heterogeneity (paper Table 4: Dirichlet alpha=1)
    clients = build_clients(x, y, dirichlet_partition(y, 4, alpha=1.0, seed=0))
    adapter = nlp_task(num_classes=4, smoke=True)
    # 2 blocks + embed + head = 4 groups for the smoke transformer
    schedule = FedPartSchedule(num_groups=4, warmup_rounds=2, rounds_per_layer=2,
                               cycles=2, bridge_rounds=1)
    return adapter, clients, eval_set, schedule


def run_config(algo: str, *, device: str = "cuda",
               fused_adam: bool = False) -> FLRunConfig:
    return FLRunConfig(local_epochs=2, batch_size=32, lr=1e-3,
                       algo=AlgoConfig(name=algo), fused_adam=fused_adam,
                       device=device)


def run(*, device: str = "cuda", fused_adam: bool = False, rounds: int | None = None,
        verbose: bool = True, **build_kw) -> dict:
    """FedPart and FNU for FedAvg and FedProx; ``{algo: (fedpart, fnu)}``
    ``FLResult``s, each line of the reference's summary printed.
    ``rounds`` keeps only that many rounds of each schedule."""
    adapter, clients, eval_set, schedule = build(**build_kw)
    out = {}
    for algo in ALGOS:
        cfg = run_config(algo, device=device, fused_adam=fused_adam)
        fp = run_federated(adapter, clients, eval_set, schedule.rounds()[:rounds], cfg)
        fnu = run_federated(adapter, clients, eval_set,
                            matched_fnu(schedule).rounds()[:rounds], cfg)
        out[algo] = fp, fnu
        if verbose:
            print(f"[{algo}] FedPart best={fp.best_acc:.4f} "
                  f"(comm {fp.comm_total_bytes/fp.comm_fnu_bytes:.1%} of FNU) | "
                  f"FNU best={fnu.best_acc:.4f}")
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
