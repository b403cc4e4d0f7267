"""FedPart under the async runtime: sync barrier vs FedBuff on a straggling
fleet (port of ``examples/fedpart_async.py``).

The synchronous loop pays for every round's slowest client; the async
runtime (``repro_torch.fl.runtime``) merges as soon as K updates arrive and
discounts stale ones polynomially, so the virtual clock — not the round
counter — decides which strategy wins.  This demo runs the same FedPart
schedule on a fleet with heavy compute heterogeneity and compares
*time-to-accuracy* on the shared virtual timeline (all three use the
event-driven runtime, which is what books virtual time; the barrier
*policy* has exactly the synchronous loop's semantics):

1. barrier policy (``async_policy="sync"``) — synchronous FedAvg as an
   event-driven policy: every merge waits for the round's slowest client;
2. FedBuff (K = a quarter of the fleet, staleness exponent 0.5) — merges
   early, stragglers land stale and discounted;
3. FedBuff + host-parallel dispatch (``--max-inflight``, default 2) — the
   server keeps several cohorts in flight, each on its own device slot;
   one card has one slot, so later cohorts wait in the launch queue while
   the virtual clock still overlaps them.

Uses the tiny-transformer NLP task on the vmap engine; ``--fused-adam``
sends every bucket-step through the masked-Adam CUDA kernel's cohort
launch.

    python -m repro_torch.examples.fedpart_async --fused-adam        # one H100
    python -m repro_torch.examples.fedpart_async --device cpu [--clients 8]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.schedule import FedPartSchedule
from repro_torch.data import (TextDatasetSpec, balanced_eval_set, build_clients,
                              iid_partition, make_text_dataset)
from repro_torch.fl import AvailabilityConfig, FLRunConfig, nlp_task, run_federated


def setup(clients: int, samples_per_client: int = 48, eval_samples: int = 400):
    cfg = get_config("nlp-transformer", smoke=True).with_(
        num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
        vocab_size=256, max_position_embeddings=16)
    spec = TextDatasetSpec(num_classes=4, vocab_size=256, seq_len=16)
    x, y = make_text_dataset(spec, samples_per_client * clients, seed=0)
    xe, ye = make_text_dataset(spec, eval_samples, seed=99)
    eval_set = balanced_eval_set(xe, ye, per_class=32)
    data = build_clients(x, y, iid_partition(len(y), clients, seed=0))
    return nlp_task(num_classes=4, cfg=cfg), data, eval_set


def variants(clients: int = 8, *, speed_spread: float = 4.0, max_inflight: int = 2,
             plan: str = "homogeneous", capacity_tiers=(), device: str = "cuda",
             fused_adam: bool = False) -> list[tuple[str, FLRunConfig]]:
    """The three ``(name, FLRunConfig)`` variants, the reference's."""
    fleet = AvailabilityConfig(speed_spread=speed_spread, latency_jitter=0.2, seed=7)
    base = dict(local_epochs=1, batch_size=16, lr=3e-3, engine="vmap",
                sample_fraction=0.5, availability=fleet, plan=plan,
                capacity_tiers=tuple(capacity_tiers), fused_adam=fused_adam,
                device=device, runtime="async")
    buff = dict(async_policy="fedbuff", buffer_k=max(1, clients // 4),
                staleness_exponent=0.5)
    return [("sync barrier", FLRunConfig(**base, async_policy="sync")),
            ("fedbuff K=n/4", FLRunConfig(**base, **buff)),
            (f"fedbuff x{max_inflight} inflight",
             FLRunConfig(**base, **buff, max_inflight_cohorts=max_inflight))]


def schedule_rounds(rounds: int = 16):
    sched = FedPartSchedule(num_groups=4, warmup_rounds=2, rounds_per_layer=2,
                            cycles=2, bridge_rounds=1)
    return sched.rounds()[:rounds]


def run(*, clients: int = 8, rounds: int = 16, speed_spread: float = 4.0,
        threshold: float = 0.5, max_inflight: int = 2, plan: str = "homogeneous",
        capacity_tiers=(), device: str = "cuda", fused_adam: bool = False,
        samples_per_client: int = 48, eval_samples: int = 400,
        verbose: bool = True) -> dict:
    """Each variant's ``FLResult`` by name, the reference's per-variant lines
    and summary table printed."""
    adapter, data, eval_set = setup(clients, samples_per_client, eval_samples)
    specs = schedule_rounds(rounds)
    if verbose:
        print(f"fleet: {clients} clients, speed spread {speed_spread} "
              f"(speeds span ~{(1 + speed_spread) ** 2:.0f}x), 50% sampled "
              f"per dispatch\n")
    out, rows = {}, []
    for name, cfg in variants(clients, speed_spread=speed_spread,
                              max_inflight=max_inflight, plan=plan,
                              capacity_tiers=capacity_tiers, device=device,
                              fused_adam=fused_adam):
        t0 = time.time()
        out[name] = res = run_federated(adapter, data, eval_set, specs, cfg)
        tta = res.timeline.time_to_accuracy(threshold)
        stale = max((h["staleness_max"] for h in res.history), default=0)
        overlap = res.timeline.overlap_seconds()
        rows.append((name, res.best_acc, res.timeline.total_seconds, tta, stale,
                     overlap))
        if verbose:
            print(f"[{name:22s}] wall={time.time()-t0:5.1f}s "
                  f"virtual={res.timeline.total_seconds:8.2f}s "
                  f"best_acc={res.best_acc:.4f} "
                  f"tta@{threshold:.2f}="
                  f"{'never' if np.isinf(tta) else f'{tta:.2f}s'} "
                  f"max_staleness={stale} overlap={overlap:.2f}s")
    if verbose:
        print("\n=================== summary (virtual time) ===================")
        print(f"{'variant':24s} {'best acc':>9s} {'total (s)':>10s} "
              f"{'tta (s)':>9s} {'staleness':>9s} {'overlap':>8s}")
        for name, acc, total, tta, stale, overlap in rows:
            tta_s = "never" if np.isinf(tta) else f"{tta:.2f}"
            print(f"{name:24s} {acc:9.4f} {total:10.2f} {tta_s:>9s} {stale:9d} "
                  f"{overlap:8.2f}")
        print("\nFedBuff merges at K updates instead of waiting for the slowest "
              "straggler,\nso its virtual clock advances ~K/cohort as fast; stale "
              "updates merge against\nthe *current* frozen context with "
              "polynomially discounted weight.  With\n--max-inflight > 1 the "
              "server additionally keeps several cohorts in flight —\noverlap "
              "shows how much of the run ran concurrently on the virtual clock.")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--speed-spread", type=float, default=4.0,
                    help="fleet heterogeneity (4.0: ~25x fastest-to-slowest)")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="accuracy threshold for time-to-accuracy")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="in-flight cohorts for the host-parallel variant")
    ap.add_argument("--plan", choices=["homogeneous", "nested", "random"],
                    default="homogeneous",
                    help="per-client layer plan for every variant; pair with "
                         "--capacity-tiers to give the straggling fleet "
                         "capacity-matched group subsets")
    ap.add_argument("--capacity-tiers", type=float, nargs="*", default=[],
                    help="tier capacity fractions in (0, 1], clients "
                         "round-robin (e.g. 0.5 1.0)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused-adam", action="store_true",
                    help="local Adam steps through the masked-Adam CUDA kernel")
    args = ap.parse_args(argv)
    return run(clients=args.clients, rounds=args.rounds,
               speed_spread=args.speed_spread, threshold=args.threshold,
               max_inflight=args.max_inflight, plan=args.plan,
               capacity_tiers=args.capacity_tiers, device=args.device,
               fused_adam=args.fused_adam)


if __name__ == "__main__":
    main()
