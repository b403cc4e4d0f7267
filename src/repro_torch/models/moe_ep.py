"""Expert-parallel MoE over ``torch.distributed`` (port of
``repro.models.moe_ep``).

The reference writes the communication out in a ``shard_map``, because
GSPMD's own partitioning of the sort dispatch replicated the whole
(E·C, d) buffer on every device.  Here each rank is a process, and the
pattern is the same:

- tokens stay sharded over the data axes and **replicated over "model"**:
  every model rank runs the router and the sort dispatch identically
  (``moe.route``, ``moe.dispatch``: the stable top-k, the same slots);
- each model rank computes only its ``E / model`` experts, from its local
  shard of ``experts/*`` (under FSDP the d_model axis of those shards is
  all-gathered over "data");
- each rank combines its experts' slots into a partial per-token sum (the
  port's deterministic ``(T, k, d)`` sum over k, masked to the rank's
  slots: no atomics), adds its tensor-parallel slice of the shared expert,
  and **one all-reduce over the "model" group** finishes the layer.

The load-balance aux loss is the reference's: computed on each data shard,
then the mean over the DP group.

Parameters.  Each leaf of the layer's ``params`` is the rank's shard, as
``ep_specs`` lays it out (the router replicated, the experts on "model"
with d_model on "data" under FSDP, the shared expert column / row split
on "model"), either a plain tensor or a DTensor (its ``to_local()`` is
read).  ``local_moe_params`` cuts a rank's shards from a full tree.  In a
DTensor step (DTensor tokens) every DTensor leaf is redistributed to that
layout first (``_local_param``; under FSDP the step's shared expert is
also split over "data"), the tokens to batch over the data-parallel axes,
and y and aux come back as DTensors (batch-sharded, replicated).

Backward.  Every model rank computes the same loss from the same output,
so:

- the output all-reduce passes the replicated cotangent through unchanged
  (``_SumOverModel``: all-reduce forward, identity backward).
  ``torch.distributed.nn.functional.all_reduce`` would sum the ranks'
  equal cotangents and make every gradient ``model`` times too large;
- each replicated tensor that enters a rank's *partial* work (the
  dispatched tokens with the shared expert's input, and the combine's gate
  values) has its cotangent all-reduced over "model" (``_ReduceGrad``:
  identity forward, all-reduce backward).  So the router's gradient and
  the input's come out whole and equal on every rank, and the aux loss's
  path, computed identically on every rank, is not counted ``model``
  times;
- under FSDP the weight all-gather's backward is a reduce-scatter (sum)
  over "data": the experts' gradient shards come out summed over the data
  ranks;
- the aux loss's DP mean passes ``ct / n`` to each data rank's own aux
  (``n`` the DP size), as the transpose of the reference's ``pmean`` does.

Over "data" the gradients follow one convention, the sum: each data rank
back-propagates its tokens' part of the global loss (the cotangent of its
``y``) and the cotangent of the replicated aux loss as it is (1 for
``loss = ... + aux``); the gradient of the global loss is then the sum of
the ranks' gradients over "data".  A DP step sums every leaf over the data
ranks (the router, the shared expert and, without FSDP, the expert
shards), except the FSDP expert shards, which the reduce-scatter has
already summed.  So summed, the gradients equal the reference's
``jax.grad`` (at one data rank, of the non-EP ``moe.moe_apply``), each rank
holding its shards' part.

Traffic.  ``expert_parallel`` yields an ``ExpertParallel`` whose
``traffic`` gets one record per layer call: the tokens, the output
all-reduce's calls and bytes, the FSDP all-gathers', the aux loss's DP
all-reduce (forward only) and, when a backward runs, the cotangent
all-reduces and the reduce-scatters.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_size, dp_axes, dp_size
from repro_torch.launch.sharding import local_shard, placements
from repro_torch.models import moe
from repro_torch.models.layers import mlp_apply
from repro_torch.tree import PyTree, tree_map_with_path

COUNTERS = ("all_reduce", "all_gather", "aux_all_reduce", "grad_all_reduce",
            "reduce_scatter")


@dataclasses.dataclass
class ExpertParallel:
    """The active expert-parallel layout: the mesh (a ``DeviceMesh`` with a
    "model" dim), FSDP or not, and the collectives' records."""

    mesh: object
    fsdp: bool = False
    traffic: list = dataclasses.field(default_factory=list)

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis) if axis in self.mesh.mesh_dim_names else 0

    def group(self, axis: str):
        return self.mesh.get_group(axis)


_EP: list[ExpertParallel | None] = [None]


@contextmanager
def expert_parallel(mesh, fsdp: bool = False):
    """Route ``moe.moe_apply`` through ``moe_apply_ep`` on ``mesh`` while the
    context is open; yields the ``ExpertParallel`` (its ``traffic``)."""
    if "model" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"expert parallelism needs a 'model' mesh dim, got "
                         f"{mesh.mesh_dim_names}")
    ep = ExpertParallel(mesh, fsdp)
    prev, _EP[0] = _EP[0], ep
    try:
        yield ep
    finally:
        _EP[0] = prev


def ep_enabled() -> bool:
    return _EP[0] is not None


def ep_specs(cfg: ModelConfig, fsdp: bool) -> dict[str, tuple]:
    """Leaf (relative to the MoE layer) -> spec of the rank's shards, the
    reference's ``_moe_param_specs``."""
    d_ax = "data" if fsdp else None
    specs = {"router/w": (None, None),
             "experts/w_gate": ("model", d_ax, None),
             "experts/w_up": ("model", d_ax, None),
             "experts/w_down": ("model", None, d_ax)}
    if cfg.num_shared_experts > 0:
        specs.update({"shared/w_gate/w": (None, "model"), "shared/w_up/w": (None, "model"),
                      "shared/w_down/w": ("model", None)})
    return specs


def local_moe_params(params: PyTree, cfg: ModelConfig, mesh, coords: dict[str, int],
                     fsdp: bool = False) -> PyTree:
    """``params`` (a whole model's tree or one MoE layer's) with every MoE
    leaf (``.../moe/...``, or the layer's own) cut to the shard of the rank
    at ``coords`` (axis -> index; ``sharding.mesh_coords(mesh)`` for this
    rank); a stacked leaf keeps its layer axes whole.  Other leaves are
    returned as they are."""
    specs = ep_specs(cfg, fsdp)

    def cut(path: str, x):
        rel = path.split("moe/", 1)[-1]
        if rel not in specs:
            return x
        spec = specs[rel]
        return local_shard(x, (None,) * (x.dim() - len(spec)) + spec, mesh, coords)

    return tree_map_with_path(cut, params)


# ---------------------------------------------------------------------------
# Collectives with the backward EP needs
# ---------------------------------------------------------------------------

def _count(rec: dict, kind: str, t: torch.Tensor, n: int = 1) -> None:
    rec[kind + "_calls"] += 1
    rec[kind + "_bytes"] += t.numel() * t.element_size() * n


class _SumOverModel(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the layer's output."""

    @staticmethod
    def forward(ctx, x, group, rec):
        dist.all_reduce(x, group=group)
        _count(rec, "all_reduce", x)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceGrad(torch.autograd.Function):
    """Identity forward, all-reduce (sum) of the cotangent backward: a
    replicated tensor entering a rank's partial work."""

    @staticmethod
    def forward(ctx, x, group, rec):
        ctx.group, ctx.rec = group, rec
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        _count(ctx.rec, "grad_all_reduce", g)
        return g, None, None


class _MeanOverGroups(torch.autograd.Function):
    """The mean over the product of ``groups`` (the DP axes), of ``size``
    ranks.  Backward: the replicated cotangent over ``size``, no collective
    (``pmean``'s transpose), so that the data ranks' gradients sum to the
    global loss's."""

    @staticmethod
    def forward(ctx, x, groups, size, rec):
        ctx.size = size
        x = x.clone()
        for grp in groups:
            dist.all_reduce(x, group=grp)
            _count(rec, "aux_all_reduce", x)
        return x / size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None, None, None


class _GatherOverData(torch.autograd.Function):
    """FSDP: the data ranks' shards concatenated along ``axis`` forward;
    the cotangent reduce-scattered (summed) back along it.  The shards are
    gathered stacked on a new leading dim and moved to ``axis``, which is a
    view when there is one data rank (no copy of an expert stack beside
    the gathered one)."""

    @staticmethod
    def forward(ctx, x, axis, group, n, rec):
        ctx.axis, ctx.group, ctx.n, ctx.rec = axis, group, n, rec
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        _count(rec, "all_gather", x, n)
        shape = list(x.shape)
        shape[axis] *= n
        return out.view(n, *x.shape).movedim(0, axis).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        n, axis = ctx.n, ctx.axis
        parts = g.reshape(*g.shape[:axis], n, g.shape[axis] // n, *g.shape[axis + 1:])
        src = parts.movedim(axis, 0).contiguous()
        out = src.new_empty(src.shape[1:])
        dist.reduce_scatter_tensor(out, src.reshape(-1, *src.shape[2:]), group=ctx.group)
        _count(ctx.rec, "reduce_scatter", src)
        return out, None, None, None, None


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _tokens_placements(x: DTensor, mesh) -> list:
    """The tokens' layout EP reads: batch over the data-parallel axes (when
    it divides), replicated over "model"."""
    dp = dp_axes(mesh)
    split = x.shape[0] % dp_size(mesh) == 0
    return [Shard(0) if name in dp and split else Replicate()
            for name in mesh.mesh_dim_names]


def _local_param(w, spec: tuple, mesh, tokens_pl: list) -> torch.Tensor:
    """This rank's shard of an MoE leaf laid out by its ``ep_specs`` spec: a
    plain tensor is taken as that shard already; a DTensor (a step's
    ``shard_params`` layout, which differs from EP's for the shared expert
    under FSDP) is redistributed to it.  Its gradient comes back as this
    rank's shard where the spec shards it, and as a partial sum over a data
    axis that shards the tokens elsewhere (the sum convention above);
    over "model" a replicated leaf's gradient is whole on every rank."""
    if not isinstance(w, DTensor):
        return w
    pl = placements(spec, mesh)
    grad_pl = [p if isinstance(p, Shard) else Partial() if isinstance(t, Shard) else p
               for p, t in zip(pl, tokens_pl)]
    return w.redistribute(mesh, pl).to_local(grad_placements=grad_pl)


def _check_shape(name: str, x: torch.Tensor, want: tuple) -> None:
    if tuple(x.shape) != want:
        raise ValueError(f"expert parallelism: {name} is {tuple(x.shape)}, this rank's "
                         f"shard is {want} (moe_ep.local_moe_params cuts it)")


def moe_apply_ep(params: PyTree, cfg: ModelConfig,
                 x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe.moe_apply`` on this rank's tokens ``x`` (B_loc, S, d: its data
    shard, the same on every model rank) and its shards of ``params``;
    returns (y, aux) replicated over "model"."""
    ep = _EP[0]
    mesh, fsdp = ep.mesh, ep.fsdp
    model, data = axis_size(mesh, "model"), axis_size(mesh, "data")
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    if e % model:
        raise ValueError(f"{e} experts do not divide over {model} model ranks")
    e_loc = e // model
    specs = ep_specs(cfg, fsdp)
    dtensor = isinstance(x, DTensor)
    tok_pl = _tokens_placements(x, mesh) if dtensor else None
    if dtensor:      # a DTensor step: EP runs on each rank's tokens and shards
        x = x.redistribute(mesh, tok_pl).to_local()
        params = {"router": {"w": _local_param(params["router"]["w"], specs["router/w"],
                                               mesh, tok_pl)},
                  "experts": {n: _local_param(w, specs["experts/" + n], mesh, tok_pl)
                              for n, w in params["experts"].items()},
                  **({"shared": {n: {"w": _local_param(q["w"], specs[f"shared/{n}/w"],
                                                       mesh, tok_pl)}
                                 for n, q in params["shared"].items()}}
                     if "shared" in params else {})}
    x = _local(x)
    b, s, d = x.shape
    t = b * s
    cap = moe._capacity(t, cfg)
    mgroup = ep.group("model")
    rec = {"tokens": t, **{f"{c}_{w}": 0 for c in COUNTERS for w in ("calls", "bytes")}}
    ep.traffic.append(rec)
    xf = x.reshape(t, d)

    with record_function(moe.MOE_ROUTE):
        logits, gate_vals, expert_idx = moe.route({"router": {"w": _local(
            params["router"]["w"])}}, cfg, xf)

    with record_function(moe.MOE_DISPATCH):
        slots, token_idx, aux = moe.dispatch(cfg, logits, expert_idx, cap)
        dp = dp_axes(mesh)
        aux = _MeanOverGroups.apply(aux, [ep.group(a) for a in dp], dp_size(mesh), rec)
        # the tokens this rank's partial work reads: their cotangent sums the ranks'
        xp = _ReduceGrad.apply(xf, mgroup, rec)
        my0 = ep.rank("model") * e_loc * cap
        expert_in = moe.fill_slots(xp, slots, token_idx, e, cap, ep.rank("model") * e_loc,
                                   e_loc)

    with record_function(moe.MOE_EXPERTS):
        d_loc = d // data if fsdp else d
        ew = {n: _local(w) for n, w in params["experts"].items()}
        _check_shape("experts/w_gate", ew["w_gate"], (e_loc, d_loc, cfg.moe_d_ff))
        _check_shape("experts/w_up", ew["w_up"], (e_loc, d_loc, cfg.moe_d_ff))
        _check_shape("experts/w_down", ew["w_down"], (e_loc, cfg.moe_d_ff, d_loc))
        if fsdp:
            dgroup = ep.group("data")
            ew = {n: _GatherOverData.apply(w, 2 if n == "w_down" else 1, dgroup, data, rec)
                  for n, w in ew.items()}
        out_my = moe.experts_apply(ew, expert_in).reshape(e_loc * cap, d)

    with record_function(moe.MOE_COMBINE):
        in_mine = (slots >= my0) & (slots < my0 + e_loc * cap)
        local_idx = torch.clamp(slots - my0, 0, e_loc * cap - 1)
        vals = torch.where(in_mine[:, None], out_my[local_idx], 0)
        gates = _ReduceGrad.apply(gate_vals, mgroup, rec)
        y = moe.gate_sum(vals, gates, k)

    if cfg.num_shared_experts > 0:
        with record_function(moe.MOE_SHARED):
            sh = {n: {"w": _local(p["w"])} for n, p in params["shared"].items()}
            y = y + mlp_apply(sh, cfg.mlp_kind, xp)
    y = _SumOverModel.apply(y, mgroup, rec).reshape(b, s, d)
    if dtensor:
        y = DTensor.from_local(y, mesh, tok_pl, run_check=False)
        aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return y, aux
