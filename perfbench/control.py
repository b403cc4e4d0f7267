"""The readings the limits of ``correct`` are set from, at a cell's own size,
on the card: for each seed, the numbers ``compare`` gives for

* ``program``: the program's checked rounds (a sound run) against the
  plain reference: the lower readings;
* ``tf32``: the control, the reference computed with TF32 on for matmuls
  and convolutions (the precision just below the configuration's float32
  with TF32 off), in the program's place;
* ``half_batch``: the reference leaving out half of every batch, the loss
  the mean over the rest, in the program's place;
* ``dropped_splice``: the reference losing the last checked round's
  aggregate, in the program's place.

    python3 perfbench/control.py --workload nlp.fnu --seeds 12 --control-seeds 3

(every kind on the first ``--control-seeds`` seeds, the program alone on
the rest).
One JSON line per seed and kind on standard output; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("program", "tf32", "half_batch", "dropped_splice")


def readings(root: Path, name: str, seed: int, kinds, device: str = "cuda", **overrides):
    """``{kind: compare.gaps(...)}`` for one seed."""
    import torch

    from perfbench import compare
    from perfbench.cell import fp32_only, prepare, program_checked_rounds

    fp32_only()
    inp = prepare(root, name, seed, device, **overrides)
    ref = inp.reference(device)
    out = {}
    for kind in kinds:
        if kind == "program":
            side = program_checked_rounds(inp, device)[0]
        elif kind == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                side = inp.reference(device)
            finally:
                fp32_only()
        elif kind == "half_batch":
            side = inp.reference(device, half_batch=True)
        elif kind == "dropped_splice":
            side = inp.reference(device, drop_splice=len(inp.checked) - 1)
        else:
            raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
        out[kind] = compare.gaps(side, ref, inp.params0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        kinds = KINDS if i < args.control_seeds else ("program",)
        for kind, numbers in readings(ROOT, args.workload, seed, kinds).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              **numbers}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
