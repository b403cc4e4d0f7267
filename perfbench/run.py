"""Run one cell of the benchmark once, on the machine it is started on:

    python3 perfbench/run.py --workload nlp.fedpart --seed 7 --seconds 30 --trace 0

from the root of a checkout.  The last line of standard output is the
result as one JSON object: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a profiler
trace of the window.  The numbers that decide ``correct`` close standard
error, each beside its limit.  Without a CUDA card, or with fewer cards
than the cell needs, it exits with code 3 and prints no result; with JAX or
the JAX package (``repro``) loaded once the run is over, with code 4.

Kernel builds and caches stay inside the checkout (``build/``), at fixed
paths, so only a checkout's first run builds.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX package's."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfbench.cell import run_cell
    from perfbench.manifest import load_cell

    chips = load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
