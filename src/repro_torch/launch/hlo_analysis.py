"""A step's cost, memory and roofline terms on the H100 (the port's
counterpart of ``repro.launch.hlo_analysis``; the name is kept so that a
reader finds it, though no HLO exists here).

The reference reads a compiled XLA executable, GSPMD's per-device
program.  The port has no compile step; it runs the step once under
``FakeTensorMode`` (shapes and dtypes, no storage, no device), on DTensors
when the step is sharded, and reads what one rank ran (``_LocalCost``:
an op on DTensors is counted as the local ops DTensor runs it as):

* ``extract_cost``: the FLOPs of ``torch.utils.flop_counter``'s formulas
  (matmuls, convolutions and attention, forward and backward; elementwise
  ops are not counted) and the bytes of every op that is not a view, each
  input read and each output written once: no fusion, so an upper bound,
  as the reference's CPU-backend "bytes accessed" is.
* ``extract_memory``: the activation peak, the most bytes that tensors
  made inside the step held at once
  (``torch.distributed._tools.mem_tracker.MemTracker``, which counts a
  DTensor's local shards; parameters, optimizer state and inputs made
  before the step are not in it), beside the residency the caller reckons
  from the placements.
* ``collective_bytes``: the result bytes and calls per kind of the
  collectives the rank ran (DTensor's redistributions and ``moe_ep``'s
  c10d calls; ``CommDebugMode`` counts them by op beside), where the
  reference parses XLA's optimized HLO text.

Roofline constants: the NVIDIA H100 80GB HBM3 (SXM, 700 W) data sheet,
dense rates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch._guards import active_fake_mode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s, NVIDIA H100 80GB HBM3, 700 W (data sheet)
HBM_BW = 3.35e12         # HBM3 bytes/s, NVIDIA H100 80GB HBM3, 700 W (data sheet)
NVLINK_BW = 450e9        # NVLink 4 bytes/s a direction, NVIDIA H100 80GB HBM3, 700 W
# ``fits_h100_80gb`` budget, not the capacity: the card (NVIDIA H100 80GB
# HBM3) reports 79.18 GiB (85.0e9 B) to PyTorch; 5.0e9 B of that are left
# for the CUDA context, NCCL's buffers and the caching allocator's slack.
HBM_BUDGET = 80e9


# the collectives a rank issues: DTensor's functional ones and the c10d ops
# ``models.moe_ep`` calls, by the reference's HLO kind names
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")


def _collective_kind(func) -> str | None:
    ns = getattr(func, "namespace", None)
    if ns not in _COLLECTIVE_NS:
        return None
    return _COLLECTIVES.get(func._overloadpacket.__name__)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


class _LocalCost(TorchDispatchMode):
    """One rank's FLOPs, op bytes and collective bytes.

    * An op on DTensors is handed back (``NotImplemented``): DTensor runs it
      as ops on each rank's local tensors, which this mode then sees, so
      every count is of this rank's shards, not of the DTensor-level
      (global) shapes ``FlopCounterMode`` alone would count.  Ops that
      DTensor's sharding propagation runs under its own fake mode are not
      counted (``MemTracker``'s rule).
    * FLOPs: ``torch.utils.flop_counter``'s formulas, an op without one
      decomposed first, as ``FlopCounterMode`` does (matmuls, convolutions
      and attention; elementwise ops are not counted).
    * Op bytes: each op that is not a view and returns a tensor, its tensor
      inputs read and outputs written once (counted before any
      decomposition); collectives are not op bytes.
    * Collective bytes per kind (``KINDS``): the bytes of each collective's
      result, as the reference's ``collective_bytes`` sums HLO result
      shapes; a ``wait`` moves nothing.  (``CommDebugMode`` counts the
      calls.)"""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = dict.fromkeys(KINDS, 0)
        self._fake = active_fake_mode()
        self._inner = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        counted = active_fake_mode() is self._fake
        kind = _collective_kind(func)
        if kind is not None:
            out = func(*args, **kwargs)
            if counted:
                res = out if kind != "all-reduce" or func.namespace != "c10d" else args[0]
                self.coll_bytes[kind] += _nbytes(tree_leaves(res))
            return out
        top = counted and self._inner == 0 and not func.is_view
        # FlopCounterMode's order: try a decomposition first (its registry is
        # keyed by overload packets, so an overload is never "in" it)
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            self._inner += 1
            try:
                with self:
                    r = func.decompose(*args, **kwargs)
            finally:
                self._inner -= 1
            if r is not NotImplemented:
                if top and any(isinstance(t, torch.Tensor) for t in tree_leaves(r)):
                    self.bytes += _nbytes(tree_leaves((args, kwargs, r)))
                return r
        out = func(*args, **kwargs)
        if counted and func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        if top and any(isinstance(t, torch.Tensor) for t in tree_leaves(out)):
            self.bytes += _nbytes(tree_leaves((args, kwargs, out)))
        return out


@dataclasses.dataclass(frozen=True)
class StepTrace:
    """What one run of a step showed on one rank: FLOPs, op bytes,
    activation peak and the collectives' result bytes and calls per kind
    (``KINDS``; CommDebugMode's counts beside them)."""

    flops: float
    op_bytes: float
    act_peak_bytes: float
    coll_bytes: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0.0))
    coll_calls: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    comm_counts: dict = dataclasses.field(default_factory=dict)


def _total(snapshot: dict) -> float:
    return float(sum(v["Total"] for v in snapshot.values()))


def trace_step(fn: Callable[[], Any], inputs: Any = (), *,
               peak: bool = True) -> tuple[Any, StepTrace]:
    """``fn()`` (under the caller's ``FakeTensorMode``) with one rank's
    FLOPs, op bytes and collectives counted (``_LocalCost``; on plain
    tensors the rank is the whole step) and, with ``peak`` (the tracker
    costs a third more time), its activation peak (else NaN).  ``inputs``
    (a tree: the params, the batch, a cache; DTensors' local shards) are
    registered with the tracker first, so that a view of them (a layer's
    slice of a stacked weight) is not counted as a new tensor; the peak is
    over what they hold.  ``CommDebugMode`` counts the collective calls
    (``comm_counts``, by op name)."""
    local = [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(inputs)]
    cost, comm = _LocalCost(), CommDebugMode()
    if not peak:
        with comm, cost:
            out = fn()
        return out, _trace(cost, comm, math.nan)
    mt = MemTracker()
    mt.track_external(*[t for t in local if isinstance(t, torch.Tensor)])
    with mt, comm, cost:
        base = _total(mt.get_tracker_snapshot("current"))
        out = fn()
    top = _total(mt.get_tracker_snapshot("peak")) - base
    return out, _trace(cost, comm, top)


def _trace(cost: _LocalCost, comm, peak: float) -> StepTrace:
    counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    calls = dict.fromkeys(KINDS, 0)
    for name, n in counts.items():
        kind = _COLLECTIVES.get(name.rsplit(".", 1)[-1])
        if kind is not None:
            calls[kind] += n
    return StepTrace(float(cost.flops), float(cost.bytes), peak,
                     {k: float(v) for k, v in cost.coll_bytes.items()}, calls, counts)


def extract_cost(trace: StepTrace) -> dict[str, float]:
    return {"flops": trace.flops, "bytes": trace.op_bytes}


def collective_bytes(trace: StepTrace) -> dict[str, Any]:
    """The counterpart of the reference's ``collective_bytes``: result bytes
    and calls per kind, and their total, of the collectives one rank ran
    in the trace (DTensor's redistributions and ``moe_ep``'s)."""
    return {"total_bytes": float(sum(trace.coll_bytes.values())),
            "per_kind_bytes": dict(trace.coll_bytes),
            "per_kind_count": dict(trace.coll_calls)}


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
