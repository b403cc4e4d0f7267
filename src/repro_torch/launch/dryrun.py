"""Dry run: does an (architecture x input shape x mesh) fit, and what bounds
it (port of ``repro.launch.dryrun``), on no card.

The reference lowers and compiles every pair for 512 simulated devices and
reads XLA's analyses of the GSPMD-partitioned program.  Here each pair's
step runs once on fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage, no device), with ``impl="plain"`` (the kernel wrappers need real
device pointers), inside a ``"fake"``-backend process group of the mesh's
world size (e.g. 256 ranks for 16 x 16) in which this process is rank 0.
The step is the sharded one (``launch.steps``, ``_trace_at``): every leaf
a DTensor on the mesh, placed as the reference's ``in_shardings`` place it
and propagated through the model code, so the dense compute is
partitioned over "model" and the batch over the data-parallel axes; the
collectives DTensor and expert parallelism issue move nothing.  The group
is made and destroyed by the run, so it never outlives it; a process that
already has a default group cannot run it.

Each record holds:

* params and active params (the reference's counts) and ``fsdp`` (the
  reference's thresholds);
* per-device residency, exact: the params, the f32 Adam state (train
  shapes; a FedPart step's covers its group), and the inputs / caches, each
  leaf's shard from its placements (``launch.sharding``);
* the step's FLOPs, op bytes, activation peak and collectives on one
  device, counted on its local shards (``hlo_analysis.trace_step``: the
  DTensor ops desugar into the rank's local ops before they are counted).
  Where heads do not divide "model" the attention runs replicated there,
  as GSPMD runs it (``models.sharded_heads``), and the counts say so;
* costs (FLOPs, op bytes, collective bytes per kind, expert parallelism's
  traffic) fitted on the probe configs and extrapolated (``cost_probes``)
  as the reference does; a FedPart step's (its backward depends on the
  group's position) from one full-depth run without remat.  The
  activation peak comes from the full-depth step with remat, as the
  reference's memory from its main compile;
* collectives: per kind the result bytes and calls of what one device
  ran (the counterpart of the reference's ``collective_bytes``; their sum
  is ``total_bytes``), ``CommDebugMode``'s counts by op, expert
  parallelism's records (``ep_*``), and, reckoned from the placements, the
  gradient bytes each device reduces over "data" (``dp_all_reduce_bytes``,
  or FSDP's ``fsdp_*``);
* roofline terms on the H100's data-sheet figures (``hlo_analysis``) and
  ``fits_h100_80gb``: the per-device total under ``HBM_BUDGET`` (80e9 B of
  the card's 85.0e9, the rest left for the context and the allocator).

A train step's trace is the loss and its gradients, each brought to its
param's layout; the optimizer update is not traced.  ``--act-shard`` runs
the step under ``models.act_sharding``'s layouts (the attention's query
positions over "model" where its heads do not divide it), with the
reference's ``__act`` artifact suffix.

An xLSTM prefill is traced at two and three scan chunks and extended
linearly to its length (``seq_points``: its costs are affine in the
length, and its sLSTM's eager loop over time costs per op on fake
tensors); the record's ``seq_model`` says so.  Its train step is traced at
full length.

Usage (on no card; ``PYTHONPATH=src``):
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all                 # 40 pairs, 16 x 16
    python -m repro_torch.launch.dryrun --all --multi-pod     # 2 x 16 x 16
    python -m repro_torch.launch.dryrun --arch X --shape train_4k --fedpart --group 12
    python -m repro_torch.launch.dryrun --arch X --shape train_4k --mesh 16,16
    python -m repro_torch.launch.dryrun --arch llava-next-34b --shape train_4k --act-shard

Artifacts: experiments/dryrun_torch/<arch>__<shape>__<mesh>[__fedpartN][__ep][__act][__accumN].json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from contextlib import contextmanager, nullcontext

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import hlo_analysis, sharding, steps
from repro_torch.launch.cost_probes import fit_and_extrapolate, probe_plan
from repro_torch.launch.mesh import (FAKE_BACKEND, MeshShape, dp_size,
                                     make_mesh_override, make_production_mesh,
                                     mesh_override_shape)
from repro_torch.models import api, moe_ep
from repro_torch.models.api import INPUT_SHAPES, InputShape
from repro_torch.tree import tree_leaves, tree_paths

ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch"
)

# FSDP policy (the reference's): shard params over "data" too when the model
# is too big for tensor-parallel-only residency.
FSDP_TRAIN_THRESHOLD = 8e9       # params
FSDP_SERVE_THRESHOLD = 60e9

@contextmanager
def _dtensor_metadata_unfaked():
    """Keep DTensor's own shape work out of the counts and out of the fake
    mode.  DTensor derives an op's global output shape by running the op on
    global-shape fake tensors in the ambient fake mode, which is the dry
    run's: ``MemTracker`` and ``hlo_analysis``'s counter would count those
    global tensors and FLOPs as this rank's.  And it sizes a
    ``_StridedShard`` (two sharded dims flattened into one, e.g. batch over
    "data" and positions over "model" before a linear's ``mm``) from an
    index tensor it reads back, which under the fake mode raises
    ``DataDependentOutputException``.  Inside this context both run with
    the dry run's fake mode unset: the shape work in a fresh fake mode of
    its own (the counters skip what runs in another fake mode than theirs),
    the sizing on a few real integers.  Both are private to torch: where
    this torch lacks either, it raises rather than count global work as
    this rank's (and ``fake_world`` checks the counts once a run,
    ``_check_local_counts``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _sharding_prop, placement_types

    patched = []
    for cls, name in ((getattr(placement_types, "_StridedShard", None),
                       "local_shard_size_and_offset"),
                      (getattr(_sharding_prop, "ShardingPropagator", None),
                       "_propagate_tensor_meta_non_cached")):
        orig = cls.__dict__.get(name) if cls is not None else None
        if orig is None:
            raise RuntimeError(
                f"torch {torch.__version__} has no DTensor "
                f"{'_StridedShard' if cls is None else cls.__name__}.{name}: the dry run "
                "cannot keep DTensor's global-shape work out of its per-device counts")

        def unfaked(self, *args, _orig=orig, **kwargs):
            with unset_fake_temporarily():
                return _orig(self, *args, **kwargs)

        setattr(cls, name, unfaked)
        patched.append((cls, name, orig))
    try:
        yield
    finally:
        for cls, name, orig in patched:
            setattr(cls, name, orig)


@contextmanager
def fake_world(world: int):
    """A ``"fake"``-backend default process group of ``world`` ranks, this
    process rank 0; destroyed on exit.  DTensor's shape work runs as
    ``_dtensor_metadata_unfaked`` says while it is open."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own process group; run it in a "
                           "process that has none")
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0, world_size=world)
    try:
        with _dtensor_metadata_unfaked():
            _check_local_counts(world)
            yield
    finally:
        dist.destroy_process_group()


def _check_local_counts(world: int) -> None:
    """Refuse the run unless a ``(64, 128) @ (128, 2 * world)`` product with
    the weight ``Shard(1)`` over the ``world`` ranks counts exactly this
    rank's ``(64, 128) @ (128, 2)`` FLOPs and op bytes: the counter sees the
    local ops and not DTensor's global-shape ones."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = DeviceMesh("cpu", list(range(world)))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(64, 128), mesh, [Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(128, 2), mesh, [Shard(1)], run_check=False)
        _, got = hlo_analysis.trace_step(lambda: x @ w, (x, w), peak=False)
    want = (2 * 64 * 128 * 2, 4 * (64 * 128 + 128 * 2 + 64 * 2))
    if (got.flops, got.op_bytes) != want:
        raise RuntimeError(
            f"the dry run's counter saw {got.flops:.0f} FLOPs and {got.op_bytes:.0f} op bytes "
            f"for one rank's share of a Shard(1) product over {world} ranks, not {want[0]} "
            f"and {want[1]}: on torch {torch.__version__} it counts DTensor-level work")


def _param_count(params) -> float:
    return float(sum(x.numel() for x in tree_leaves(params)))


def _active_param_count(cfg, params) -> float:
    """Active params per token (MoE: routed experts counted at top-k/E)."""
    total = 0.0
    for path, leaf in tree_paths(params):
        n = float(leaf.numel())
        if "experts" in path:
            n *= cfg.num_experts_per_tok / max(cfg.num_experts, 1)
        total += n
    return total


def _fsdp(n_params: float, shape: InputShape) -> bool:
    return n_params > (FSDP_TRAIN_THRESHOLD if shape.kind == "train"
                       else FSDP_SERVE_THRESHOLD)



def rank_batch(shape: InputShape, mesh) -> int:
    """The batch one DP rank runs: the global batch over the DP ranks when
    it divides (``sharding.batch_spec``), else all of it."""
    dp = dp_size(mesh)
    return shape.global_batch // dp if shape.global_batch % dp == 0 else shape.global_batch


def fake_params(cfg):
    """``api.init`` of ``cfg`` as fake tensors (call under ``FakeTensorMode``)."""
    return api.init(torch.Generator().manual_seed(0), cfg, "cpu")


def param_residency(cfg, mesh, *, fsdp: bool = False) -> int:
    """Per-device bytes of ``cfg``'s params on ``mesh`` (a ``DeviceMesh`` or
    a ``MeshShape``) from their placements."""
    with FakeTensorMode():
        params = fake_params(cfg)
    return sharding.per_device_bytes(params, sharding.params_specs(params, mesh, fsdp=fsdp),
                                     mesh)


def _group(params, fedpart_group: int | None):
    if fedpart_group is None:
        return None
    groups = steps.list_groups(params)
    return groups[fedpart_group % len(groups)]


def seq_points(cfg, shape: InputShape) -> tuple[int, int] | None:
    """The two sequence lengths an xLSTM prefill is traced at instead of its
    own (two and three scan chunks), or None.  Past one chunk every cost of
    its forward is per token or per chunk (the sLSTM's step, the mLSTM's
    chunked scan, the projections, the head), so its FLOPs, op bytes and
    activation peak are affine in the length and two points give them
    exactly (``tests/test_torch_dryrun_probes.py``); its sLSTM is an eager
    loop over time, which on fake tensors costs per op.  A train step is
    traced at its own length (its remat recompute and backward are not
    checked for being affine)."""
    if cfg.kind != "xlstm" or shape.kind != "prefill":
        return None
    s1, s2 = 2 * cfg.ssm_chunk, 3 * cfg.ssm_chunk
    return (s1, s2) if shape.seq_len > s2 else None


def trace_step(cfg, shape: InputShape, mesh, **kw) -> tuple[hlo_analysis.StepTrace, dict]:
    """``_trace_at`` of ``shape``, or for an xLSTM prefill (``seq_points``)
    at two shorter lengths, each metric extended linearly to
    ``shape.seq_len``."""
    pts = seq_points(cfg, shape)
    if pts is None:
        return _trace_at(cfg, shape, mesh, **kw)
    (t1, e1), (t2, e2) = (_trace_at(cfg, dataclasses.replace(shape, seq_len=s), mesh, **kw)
                          for s in pts)
    f = (shape.seq_len - pts[0]) / (pts[1] - pts[0])

    def lin(a, b):
        return a + (b - a) * f

    trace = hlo_analysis.StepTrace(
        lin(t1.flops, t2.flops), lin(t1.op_bytes, t2.op_bytes),
        lin(t1.act_peak_bytes, t2.act_peak_bytes),
        {k: lin(t1.coll_bytes[k], t2.coll_bytes[k]) for k in t1.coll_bytes},
        {k: lin(t1.coll_calls[k], t2.coll_calls[k]) for k in t1.coll_calls})
    return trace, {k: lin(e1[k], e2[k]) for k in e1}


def _trace_at(cfg, shape: InputShape, mesh, *, fsdp: bool = False,
              fedpart_group: int | None = None, use_moe_ep: bool = False,
              act_shard: bool = False, remat: bool = True, accum: int = 1,
              peak: bool = True) -> tuple[hlo_analysis.StepTrace, dict]:
    """One rank's step of ``shape`` on fake tensors (a train shape's
    microbatch under ``accum``): its trace and the summed expert-parallel
    traffic.  Train shapes take ``api.loss`` and its gradient
    (``steps.loss_and_grads``; a FedPart group's only), prefill the forward
    with its cache, decode one token against a cache of the window's
    length.  ``peak=False`` skips the activation peak (the costs-only runs).

    On a ``DeviceMesh`` (the dry run's, over its ``"fake"`` group) the step
    is the sharded one (``launch.steps``): params placed by
    ``shard_params`` (FSDP as given), the batch and cache by
    ``input_shardings``, so the rank runs its data shard of the batch with
    the dense compute partitioned over "model", and every count is of its
    local shards (``hlo_analysis.trace_step``).  A train shape's gradients
    are brought to their params' layouts (the data-parallel all-reduce or
    FSDP's reduce-scatter, as DTensor issues them: counted); the optimizer
    update is not traced (the residency reckons its state).  ``use_moe_ep``
    runs the MoE layers under ``moe_ep.expert_parallel``, ``act_shard``
    under ``act_sharding.activation_sharding``.  On a ``MeshShape`` (no
    process group) the plain step runs at the rank batch
    (``rank_batch``)."""
    window = api.decode_window(cfg, shape.seq_len)
    use_ep = use_moe_ep and cfg.is_moe
    sharded = isinstance(mesh, DeviceMesh)
    b = shape.global_batch if sharded else rank_batch(shape, mesh)
    if shape.kind == "train":
        b //= accum
    local = InputShape(shape.name, shape.seq_len, b, shape.kind)
    with FakeTensorMode():
        params = fake_params(cfg)
        group = _group(params, fedpart_group)
        batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, local, "cpu")
        if sharded:
            fn, inputs, traffic = _sharded_fn(cfg, shape.kind, mesh, params, batch, group,
                                              window, fsdp=fsdp, use_ep=use_ep,
                                              act_shard=act_shard, remat=remat)
            _, trace = hlo_analysis.trace_step(fn, inputs, peak=peak)
            recs = traffic()
        else:
            if use_ep:
                raise ValueError("--moe-ep traces need a DeviceMesh over a process group")
            fn = _plain_fn(cfg, shape.kind, params, batch, group, window, remat=remat)
            _, trace = hlo_analysis.trace_step(fn, (params, batch), peak=peak)
            recs = []
    ep_totals = {k: float(sum(r[k] for r in recs))
                 for k in ("all_reduce_calls", "all_reduce_bytes", "grad_all_reduce_bytes",
                           "aux_all_reduce_bytes", "all_gather_bytes",
                           "reduce_scatter_bytes")}
    return trace, ep_totals


def _plain_fn(cfg, kind: str, params, batch, group, window: int, *, remat: bool):
    if kind == "train":
        return lambda: steps.loss_and_grads(cfg, params, batch, group, remat=remat)
    if kind == "prefill":
        def fn():
            with torch.no_grad():
                return api.forward(params, cfg, batch, window=window, impl="plain",
                                   collect_cache=True)
        return fn

    def fn():
        with torch.no_grad():
            return api.decode_step(params, cfg, batch["token"], batch["cache"],
                                   batch["pos"], window=window)
    return fn


def _sharded_fn(cfg, kind: str, mesh, params, batch, group, window: int, *, fsdp: bool,
                use_ep: bool, act_shard: bool, remat: bool):
    """(the sharded step to trace, its inputs, a getter of its EP traffic)."""
    placed = sharding.shard_params(params, mesh, fsdp=fsdp)
    batch = steps.shard_inputs(batch, mesh)
    kw = dict(fsdp=fsdp, use_moe_ep=use_ep, act_shard=act_shard)
    if kind == "train":
        trained = placed if group is None else steps._select_group(placed, group)
        eps: list = []

        def fn():
            with steps.sharded_context(cfg, mesh, **kw) as ep:
                _, grads = steps.loss_and_grads(cfg, placed, batch, group, remat=remat)
                eps.append(ep)
                return steps.reduce_grads(grads, trained)

        return fn, (placed, batch), lambda: eps[0].traffic if eps and eps[0] else []
    if kind == "prefill":
        step = steps.make_sharded_prefill_step(cfg, mesh, window=window, impl="plain", **kw)

        def fn():
            with torch.no_grad():
                return step(placed, batch)

        return fn, (placed, batch), lambda: step.traffic
    step = steps.make_sharded_serve_step(cfg, mesh, window=window, **kw)

    def fn():
        with torch.no_grad():
            return step(placed, batch["token"], batch["cache"], batch["pos"])

    return fn, (placed, batch), lambda: step.traffic


def _costs_of(trace: hlo_analysis.StepTrace, ep_totals: dict) -> dict[str, float]:
    cost = hlo_analysis.extract_cost(trace)
    coll = hlo_analysis.collective_bytes(trace)
    return {"flops": cost["flops"], "hbm_bytes": cost["bytes"],
            "coll_bytes": coll["total_bytes"],
            **{f"coll_{k}": v for k, v in coll["per_kind_bytes"].items()},
            **{f"coll_{k}_calls": float(v) for k, v in coll["per_kind_count"].items()},
            **{f"ep_{k}": v for k, v in ep_totals.items()}}


def residency(cfg, shape: InputShape, mesh, *, fsdp: bool,
              fedpart_group: int | None = None) -> tuple[dict, dict]:
    """Per-device bytes of the params, the Adam state (train shapes) and the
    inputs / caches from their placements, and the reckoned collective
    bytes of the gradient's DP reduction (train) or FSDP's weight
    all-gather."""
    with FakeTensorMode():
        params = fake_params(cfg)
        group = _group(params, fedpart_group)
        specs = api.input_specs(cfg, shape)
    p_specs = sharding.params_specs(params, mesh, fsdp=fsdp)
    out = {"params_bytes": sharding.per_device_bytes(params, p_specs, mesh),
           "inputs_bytes": sharding.per_device_bytes(
               specs, sharding.input_specs_of(specs, mesh), mesh)}
    trained = params if group is None else steps._select_group(params, group)
    if shape.kind == "train":
        t_specs = sharding.params_specs(trained, mesh, fsdp=fsdp)
        f32 = sum(math.prod(sharding.local_shape(tuple(x.shape), t_specs["/".join(p)], mesh))
                  for p, x in tree_paths(trained)) * 4
        out["opt_bytes"] = 2 * f32 + 4            # m, v in f32, the int32 step
    # the gradient (or, serving under FSDP, the weights) each device computes
    # with: the tensor-parallel shard, whole over "data"
    tp = sharding.per_device_bytes(trained, sharding.params_specs(trained, mesh), mesh)
    dp = dp_size(mesh)
    coll = {"dp_all_reduce_bytes": 0.0, "fsdp_all_gather_bytes": 0.0,
            "fsdp_reduce_scatter_bytes": 0.0}
    if fsdp:
        coll["fsdp_all_gather_bytes"] = float(tp)
        if shape.kind == "train":
            coll["fsdp_reduce_scatter_bytes"] = float(tp)
    elif shape.kind == "train" and dp > 1:
        coll["dp_all_reduce_bytes"] = float(tp)
    return out, coll


def analyze_pair(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    fedpart_group: int | None = None,
    probes: bool = True,
    moe_ep: bool = False,
    act_shard: bool = False,
    mesh_shape: str | None = None,
    accum: int = 1,
    save: bool = True,
    verbose: bool = True,
    cfg=None,
) -> dict:
    """One pair's record (``cfg`` overrides the registered config of
    ``arch``, e.g. a smoke size)."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mshape = (mesh_override_shape(mesh_shape) if mesh_shape else
              MeshShape((2, 16, 16), ("pod", "data", "model")) if multi_pod else
              MeshShape((16, 16)))
    mesh_name = "x".join(map(str, mshape.shape))
    tag = f"{arch}__{shape_name}__{mesh_name}" + (
        f"__fedpart{fedpart_group}" if fedpart_group is not None else ""
    ) + ("__ep" if moe_ep else "") + ("__act" if act_shard else "") + (
        f"__accum{accum}" if accum > 1 else "")
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mode": "fedpart" if fedpart_group is not None else "baseline",
    }
    if not api.supports_shape(cfg, shape):
        record["status"] = "skipped"
        record["reason"] = "unsupported by design (whisper's decoder cannot reach long_500k)"
        if save:
            _save(tag, record)
        if verbose:
            print(f"[dryrun] {tag}: SKIPPED ({record['reason']})")
        return record

    t0 = time.time()
    n_chips = mshape.size()
    with fake_world(n_chips):
        mesh = (make_mesh_override(mesh_shape, "cpu") if mesh_shape
                else make_production_mesh(multi_pod=multi_pod, device_type="cpu"))
        with FakeTensorMode():
            params = fake_params(cfg)
        n_params = _param_count(params)
        active = _active_param_count(cfg, params)
        fsdp = _fsdp(n_params, shape)
        if fedpart_group is not None:
            record["fedpart_group"] = "{0.key}[{0.index}]".format(
                _group(params, fedpart_group))
        del params
        kw = dict(fsdp=fsdp, use_moe_ep=moe_ep, act_shard=act_shard, accum=accum)

        # MAIN run: full depth with remat -> the activation peak
        main, main_ep = trace_step(cfg, shape, mesh, fedpart_group=fedpart_group,
                                   remat=True, **kw)
        raw = _costs_of(main, main_ep)
        record["main_trace_s"] = time.time() - t0
        pts = seq_points(cfg, shape)
        if pts:
            record["seq_model"] = f"affine in seq_len, traced at {pts[0]} and {pts[1]}"
        if probes and fedpart_group is None:
            plan = probe_plan(cfg)
            probe_costs = [_costs_of(*trace_step(pc, shape, mesh, remat=False, peak=False,
                                                 **kw))
                           for pc in plan.probe_cfgs]
            corrected = fit_and_extrapolate(plan, probe_costs)
            record["cost_model"] = "probe-extrapolated"
        elif fedpart_group is not None:
            # FedPart's truncated backward depends on the group's position:
            # one full-depth run without remat (exact)
            corrected = _costs_of(*trace_step(cfg, shape, mesh, fedpart_group=fedpart_group,
                                              remat=False, peak=False, **kw))
            record["cost_model"] = "full-depth exact"
        else:
            corrected = raw
            record["cost_model"] = "raw (full depth, remat recompute included)"
    if accum > 1:
        corrected = {k: v * accum for k, v in corrected.items()}

    resid, coll = residency(cfg, shape, mshape, fsdp=fsdp, fedpart_group=fedpart_group)
    mem = hlo_analysis.extract_memory(main, resid)
    coll.update({k: v for k, v in corrected.items()
                 if k.startswith("ep_") or k.startswith("coll_")})
    coll["comm_counts"] = main.comm_counts
    coll["total_bytes"] = corrected["coll_bytes"]
    terms = hlo_analysis.roofline(corrected["flops"], corrected["hbm_bytes"],
                                  coll["total_bytes"],
                                  residency_bytes=mem["per_device_total_bytes"])
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = hlo_analysis.model_flops_6nd(active, tokens)
    if shape.kind != "train":
        mf /= 3.0  # forward-only

    record.update(
        status="ok",
        params=n_params,
        active_params=active,
        fsdp=fsdp,
        moe_ep=moe_ep,
        act_shard=act_shard,
        accum=accum,
        chips=n_chips,
        rank_batch=rank_batch(shape, mshape),
        memory=mem,
        raw_cost=raw,
        cost=corrected,
        collectives=coll,
        roofline=terms.to_dict(),
        model_flops=mf,
        model_flops_ratio=mf / max(corrected["flops"] * n_chips, 1.0),
        hbm_gb_per_device=mem["per_device_total_bytes"] / 1e9,
        fits_h100_80gb=mem["per_device_total_bytes"] < hlo_analysis.HBM_BUDGET,
        total_s=time.time() - t0,
    )
    if save:
        _save(tag, record)
    if verbose:
        r = record["roofline"]
        print(
            f"[dryrun] {tag}: OK {record['total_s']:.1f}s "
            f"| {mem['per_device_total_bytes'] / 1e9:.2f} GB/dev "
            f"(fits H100 80GB: {record['fits_h100_80gb']}) "
            f"| compute {r['compute_s'] * 1e3:.3f}ms mem {r['memory_s_min'] * 1e3:.3f}-"
            f"{r['memory_s_ops'] * 1e3:.0f}ms coll {r['collective_s'] * 1e3:.3f}ms -> "
            f"{r['dominant']} | useful-flops {record['model_flops_ratio']:.2f}"
        )
    return record


def _save(tag: str, record: dict) -> None:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with open(os.path.join(ARTIFACT_DIR, tag + ".json"), "w") as f:
        json.dump(record, f, indent=2, default=float)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fedpart", action="store_true")
    ap.add_argument("--group", type=int, default=None,
                    help="FedPart trainable group index (default 12 = mid-stack)")
    ap.add_argument("--moe-ep", action="store_true",
                    help="explicit expert parallelism (models/moe_ep.py)")
    ap.add_argument("--mesh", default=None,
                    help="override mesh shape, e.g. 32,8 or 2,16,16")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (train shapes)")
    ap.add_argument("--act-shard", action="store_true",
                    help="attention-score sharding constraints (models/act_sharding.py)")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]

    failures = 0
    for arch, shape in pairs:
        try:
            g = (args.group if args.group is not None else 12) if args.fedpart else None
            analyze_pair(
                arch, shape, multi_pod=args.multi_pod, fedpart_group=g,
                probes=not args.no_probes, moe_ep=args.moe_ep,
                act_shard=args.act_shard, mesh_shape=args.mesh,
                accum=args.accum, save=not args.no_save,
            )
        except Exception:
            failures += 1
            print(f"[dryrun] {arch} x {shape} FAILED:")
            traceback.print_exc()
    print(f"[dryrun] done: {len(pairs) - failures}/{len(pairs)} OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
