"""The numbers that decide ``correct``, and their limits.

A run's first rounds go through the window's own call; the plain reference
(``fedref``) follows them from the same weights and data.  The numbers:

* ``loss_gap``: the largest relative gap of a checked round's loss (the
  mean over clients of each client's mean local loss); ``loss0_gap`` the
  first round's alone;
* ``grad_gap``: the first local step's gradient, as the optimizer got it,
  by the worst leaf: for every client and leaf trained in the first
  round, the gap between the program's and the reference's gradient norm,
  over the larger of the reference's norm of that leaf and of its median
  leaf;
* ``change_gap``: the same for each leaf's change over the checked rounds,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (nought to rounding); ``change_median_gap`` the median of
  those leaves' gaps;
* ``unmoved``: the leaves the reference leaves exactly as they were (groups
  not trained, BatchNorm running moments, which never travel) that the
  program moved; an exact comparison, limit 0;
* ``stuck``: the reverse, the leaves the reference moves (those the rule
  above keeps) that the program leaves exactly as they were, as a round
  whose update or splice is lost leaves its group; exact, limit 0.

Norms are compared, not the norm of a difference: each number is a gap
between two norms, as a share of the reference's.  A cell's
``limits/<cell>.json`` names the numbers it compares, each with its limit;
``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from perfbench.fedref import Readings

NAMES = ("loss_gap", "loss0_gap", "grad_gap", "change_gap", "change_median_gap", "unmoved",
         "stuck")
RULE = 1e-3        # a leaf whose reference gradient is under this share of the median's


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _rel(a: float, b: float) -> float:
    gap = abs(a - b) / abs(b)
    return gap if np.isfinite(gap) else float("inf")


def gaps(prog: Readings, ref: Readings, params0: dict[str, torch.Tensor]) -> dict[str, float]:
    """Every number of the module docstring, program against reference."""
    losses = [_rel(a, b) for a, b in zip(prog.losses, ref.losses)]
    if len(prog.losses) != len(ref.losses):
        losses = [float("inf")]
    grad_gap = 0.0 if len(prog.first_grads) == len(ref.first_grads) else float("inf")
    for pg, rg in zip(prog.first_grads, ref.first_grads):
        med = float(np.median(list(rg.values())))
        for k, r in rg.items():
            gap = abs(pg.get(k, 0.0) - r) / max(r, med)
            grad_gap = max(grad_gap, gap if np.isfinite(gap) else float("inf"))
    rule_med = float(np.median(list(ref.grad_rule.values())))
    dp, dr, unmoved, stuck = {}, {}, 0, 0
    for k, p0 in params0.items():
        d_ref = ref.params[k].to(p0.device) - p0
        d_prog = prog.params[k].to(p0.device) - p0
        if not bool(d_ref.any()):
            unmoved += int(bool(d_prog.any()))
        elif ref.grad_rule.get(k, 0.0) >= RULE * rule_med:
            dp[k], dr[k] = _norm(d_prog), _norm(d_ref)
            stuck += int(not bool(d_prog.any()))
    med = float(np.median(list(dr.values()))) if dr else 0.0
    change = [abs(dp[k] - dr[k]) / max(dr[k], med) for k in dr]
    change = [c if np.isfinite(c) else float("inf") for c in change]
    return {"loss_gap": max(losses), "loss0_gap": losses[0], "grad_gap": grad_gap,
            "change_gap": max(change, default=0.0),
            "change_median_gap": float(np.median(change)) if change else 0.0,
            "unmoved": float(unmoved), "stuck": float(stuck)}


def load_limits(root: Path, cell: str) -> dict[str, float]:
    """The numbers cell ``cell`` compares, each with its limit."""
    data = json.loads((root / "perfbench" / "limits" / f"{cell}.json").read_text())
    limits = {k: float(v) for k, v in data.items() if k in NAMES}
    if not {"unmoved", "stuck"} <= set(limits) or len(limits) < 3:
        raise ValueError(f"limits/{cell}.json must limit 'unmoved', 'stuck' and another "
                         "number")
    return limits


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Correct when every compared number is within its limit."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
