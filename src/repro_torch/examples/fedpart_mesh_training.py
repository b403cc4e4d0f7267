"""FedPart as a datacenter training feature: the round schedule driving the
partial train steps on an assigned architecture — gradients, optimizer
state, and the per-round transmitted bytes all scoped to the scheduled
layer group (port of ``examples/fedpart_mesh_training.py``; it drives
``repro_torch.launch.fedtrain``).

    python -m repro_torch.examples.fedpart_mesh_training --arch gemma-2b   # one H100
    python -m repro_torch.examples.fedpart_mesh_training --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.launch import fedtrain


def fedtrain_argv(arch: str = "tinyllama-1.1b", rounds: int = 6,
                  device: str = "cuda") -> list[str]:
    """The ``launch.fedtrain`` command line the reference example passes,
    plus ``--device``."""
    return ["--arch", arch, "--rounds", str(rounds), "--steps-per-round", "3",
            "--batch", "4", "--seq", "32", "--device", device]


def run(*, arch: str = "tinyllama-1.1b", rounds: int = 6, device: str = "cuda"):
    """``launch.fedtrain``'s mesh-trainer run of ``fedtrain_argv``: the final
    params and one record per round."""
    return fedtrain.run_mesh(fedtrain.parse_args(fedtrain_argv(arch, rounds, device)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return fedtrain.main(fedtrain_argv(args.arch, args.rounds, args.device))


if __name__ == "__main__":
    raise SystemExit(main())
