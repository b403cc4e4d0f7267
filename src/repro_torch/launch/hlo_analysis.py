"""A step's cost, memory and roofline terms on the H100 (the port's
counterpart of ``repro.launch.hlo_analysis``; the name is kept so that a
reader finds it, though no HLO exists here).

The reference reads a compiled XLA executable.  The port has no compile
step; it runs the step once under ``FakeTensorMode`` (shapes and dtypes,
no storage, no device) and reads what ran:

* ``extract_cost``: the FLOPs of ``torch.utils.flop_counter.FlopCounterMode``
  (matmuls, convolutions and attention, forward and backward; elementwise
  ops are not counted) and the bytes of every op that is not a view, each
  input read and each output written once: no fusion, so an upper bound,
  as the reference's CPU-backend "bytes accessed" is.
* ``extract_memory``: the activation peak, the most bytes that tensors
  made inside the step held at once
  (``torch.distributed._tools.mem_tracker.MemTracker``; parameters,
  optimizer state and inputs made before the step are not in it), beside
  the residency the caller reckons from the placements.
* ``collective_bytes`` is not ported: it parses XLA's optimized HLO text,
  which torch never produces.  The dry run reckons collective bytes from
  the placements and from ``moe_ep``'s traffic records instead.

Roofline constants: the NVIDIA H100 80GB HBM3 (SXM, 700 W) data sheet,
dense rates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s, NVIDIA H100 80GB HBM3, 700 W (data sheet)
HBM_BW = 3.35e12         # HBM3 bytes/s, NVIDIA H100 80GB HBM3, 700 W (data sheet)
NVLINK_BW = 450e9        # NVLink 4 bytes/s a direction, NVIDIA H100 80GB HBM3, 700 W
# ``fits_h100_80gb`` budget, not the capacity: the card (NVIDIA H100 80GB
# HBM3) reports 79.18 GiB (85.0e9 B) to PyTorch; 5.0e9 B of that are left
# for the CUDA context, NCCL's buffers and the caching allocator's slack.
HBM_BUDGET = 80e9


class _OpBytes(TorchDispatchMode):
    """Sums the bytes of every op's tensor inputs and outputs.  Views and
    ops that return no tensor (``prim.device``, sizes: metadata reads) move
    no bytes and are skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and any(isinstance(t, torch.Tensor) for t in tree_leaves(out)):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


@dataclasses.dataclass(frozen=True)
class StepTrace:
    """What one run of a step showed: FLOPs, op bytes, activation peak."""

    flops: float
    op_bytes: float
    act_peak_bytes: float


def _total(snapshot: dict) -> float:
    return float(sum(v["Total"] for v in snapshot.values()))


def trace_step(fn: Callable[[], Any], inputs: Any = (), *,
               peak: bool = True) -> tuple[Any, StepTrace]:
    """``fn()`` (under the caller's ``FakeTensorMode``) with its FLOPs, op
    bytes and, with ``peak`` (the tracker costs a third more time), its
    activation peak counted (else NaN).  ``inputs`` (a tree: the params,
    the batch, a cache) are registered with the tracker first, so that a
    view of them (a layer's slice of a stacked weight) is not counted as a
    new tensor; the peak is over what they hold."""
    if not peak:
        with FlopCounterMode(display=False) as fc, _OpBytes() as ob:
            out = fn()
        return out, StepTrace(float(fc.get_total_flops()), float(ob.bytes), math.nan)
    mt = MemTracker()
    mt.track_external(*[t for t in tree_leaves(inputs) if isinstance(t, torch.Tensor)])
    with mt, FlopCounterMode(display=False) as fc, _OpBytes() as ob:
        base = _total(mt.get_tracker_snapshot("current"))
        out = fn()
    top = _total(mt.get_tracker_snapshot("peak")) - base
    return out, StepTrace(float(fc.get_total_flops()), float(ob.bytes), top)


def extract_cost(trace: StepTrace) -> dict[str, float]:
    return {"flops": trace.flops, "bytes": trace.op_bytes}


def extract_memory(trace: StepTrace, residency: dict[str, int]) -> dict[str, float]:
    """The per-device picture: the residency terms (params, optimizer
    state, inputs / caches; bytes from the placements), the activation
    peak, and their sum."""
    out = {**residency, "act_peak_bytes": trace.act_peak_bytes}
    out["per_device_total_bytes"] = float(sum(out.values()))
    return out


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-device roofline terms, in seconds, on the H100 constants.

    Two memory terms: ``memory_s_ops``, the op bytes (no fusion: an upper
    bound) over ``HBM_BW``; ``memory_s_min``, 2 x the per-device residency
    (every live byte written and read once: a lower bound) over
    ``HBM_BW``.  ``dominant`` uses the lower bound, as the reference's."""

    compute_s: float
    memory_s_ops: float
    memory_s_min: float
    collective_s: float
    flops: float
    hbm_bytes: float
    residency_bytes: float
    coll_bytes: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s_min,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s_min, self.collective_s)

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant}


def roofline(
    flops: float, hbm_bytes: float, coll_bytes: float, residency_bytes: float = 0.0
) -> RooflineTerms:
    """All quantities are per device."""
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s_ops=hbm_bytes / HBM_BW,
        memory_s_min=2.0 * residency_bytes / HBM_BW,
        collective_s=coll_bytes / NVLINK_BW,
        flops=flops,
        hbm_bytes=hbm_bytes,
        residency_bytes=residency_bytes,
        coll_bytes=coll_bytes,
    )


def model_flops_6nd(active_params: float, tokens: float) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for a train step;
    forward-only callers divide by 3."""
    return 6.0 * active_params * tokens
