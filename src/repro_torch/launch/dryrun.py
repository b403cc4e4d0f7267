"""Dry run: does an (architecture x input shape x mesh) fit, and what bounds
it (port of ``repro.launch.dryrun``), on no card.

The reference lowers and compiles every pair for 512 simulated devices and
reads XLA's analyses.  Here each pair's step runs once on fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage, no device), with
``impl="plain"`` (the kernel wrappers need real device pointers), inside a
``"fake"``-backend process group of the mesh's world size (e.g. 256 ranks
for 16 x 16) in which this process is rank 0: the mesh is a real
``DeviceMesh``, and expert parallelism's collectives are issued and
counted, but move nothing.  The group is made and destroyed by the run, so
it never outlives it; a process that already has a default group cannot
run it.

Each record holds:

* params and active params (the reference's counts) and ``fsdp`` (the
  reference's thresholds);
* per-device residency, exact: the params, the f32 Adam state (train
  shapes; a FedPart step's covers its group), and the inputs / caches, each
  leaf's shard from its placements (``launch.sharding``);
* the step's FLOPs and activation peak on one DP rank, at the per-rank
  batch (global batch over the DP ranks when it divides, else whole).  The
  port does not partition the dense compute over "model": only the experts
  are divided, and only under ``--moe-ep``.  So both are upper bounds on
  the "model" axis (``model_axis`` in the record says so);
* costs (FLOPs, op bytes, expert parallelism's collective bytes) fitted on
  the probe configs and extrapolated (``cost_probes``) as the reference
  does; a FedPart step's (its backward depends on the group's position)
  from one full-depth run without remat.  The activation peak comes from
  the full-depth step with remat, as the reference's memory from its main
  compile;
* reckoned collectives: the DP gradient all-reduce, or FSDP's weight
  all-gather and gradient reduce-scatter, of the gradient bytes each device
  computes, plus expert parallelism's per-layer all-reduce (counted);
* roofline terms on the H100's data-sheet figures (``hlo_analysis``) and
  ``fits_h100_80gb``: the per-device total under ``HBM_BUDGET`` (80e9 B of
  the card's 85.0e9, the rest left for the context and the allocator).

An xLSTM prefill is traced at two and three scan chunks and extended
linearly to its length (``seq_points``: its costs are affine in the
length, and its sLSTM's eager loop over time costs ~0.15 ms an op on fake
tensors); the record's ``seq_model`` says so.  Its train step is traced at
full length: ``--all`` spends most of its time there.

Usage (on no card; ``PYTHONPATH=src``):
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all                 # 40 pairs, 16 x 16
    python -m repro_torch.launch.dryrun --all --multi-pod     # 2 x 16 x 16
    python -m repro_torch.launch.dryrun --arch X --shape train_4k --fedpart --group 12
    python -m repro_torch.launch.dryrun --arch X --shape train_4k --mesh 16,16

``--act-shard`` is refused: ``models.act_sharding``'s constraints act only
on DTensor activations, and the port's step runs on plain tensors (a
DTensor-propagated step is still to come), so the flag would change no
number.

Artifacts: experiments/dryrun_torch/<arch>__<shape>__<mesh>[__fedpartN][__ep][__accumN].json
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

MODEL_AXIS_NOTE = ("upper bound: the dense compute is not partitioned over 'model'; "
                   "only the experts are divided, and only under --moe-ep")


@contextmanager
def fake_world(world: int):
    """A ``"fake"``-backend default process group of ``world`` ranks, this
    process rank 0; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own process group; run it in a "
                           "process that has none")
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


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
    loop over time, which on fake tensors costs ~0.15 ms an op.  A train
    step is traced at its own length: its backward's bytes and peak are not
    affine (each step's ``gx[:, t]`` slice has a whole-``gx`` gradient)."""
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

    trace = hlo_analysis.StepTrace(lin(t1.flops, t2.flops), lin(t1.op_bytes, t2.op_bytes),
                                   lin(t1.act_peak_bytes, t2.act_peak_bytes))
    return trace, {k: lin(e1[k], e2[k]) for k in e1}


def _trace_at(cfg, shape: InputShape, mesh, *, fsdp: bool = False,
              fedpart_group: int | None = None, use_moe_ep: bool = False,
              remat: bool = True, accum: int = 1,
              peak: bool = True) -> tuple[hlo_analysis.StepTrace, dict]:
    """One DP rank's step of ``shape`` on fake tensors, at the per-rank
    batch (a train shape's microbatch under ``accum``): its trace, and the
    summed expert-parallel traffic (``use_moe_ep`` needs a ``DeviceMesh``
    over a process group; the fake one here).  Train shapes take
    ``api.loss`` and its gradient (``steps.loss_and_grads``; a FedPart
    group's only), prefill the forward with its cache, decode one token
    against a cache of the window's length.  ``peak=False`` skips the
    activation peak (the costs-only runs)."""
    b = rank_batch(shape, mesh)
    if shape.kind == "train":
        b //= accum
    local = InputShape(shape.name, shape.seq_len, b, shape.kind)
    window = api.decode_window(cfg, shape.seq_len)
    use_ep = use_moe_ep and cfg.is_moe
    with FakeTensorMode():
        params = fake_params(cfg)
        group = _group(params, fedpart_group)
        if use_ep:
            params = moe_ep.local_moe_params(params, cfg, mesh, {}, fsdp)
        batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, local, "cpu")
        if shape.kind == "train":
            def fn():
                return steps.loss_and_grads(cfg, params, batch, group, remat=remat)
        elif shape.kind == "prefill":
            def fn():
                with torch.no_grad():
                    return api.forward(params, cfg, batch, window=window, impl="plain",
                                       collect_cache=True)
        else:
            def fn():
                with torch.no_grad():
                    return api.decode_step(params, cfg, batch["token"], batch["cache"],
                                           batch["pos"], window=window)
        with moe_ep.expert_parallel(mesh, fsdp) if use_ep else nullcontext() as ep:
            _, trace = hlo_analysis.trace_step(fn, (params, batch), peak=peak)
    recs = ep.traffic if use_ep else []
    ep_totals = {k: float(sum(r[k] for r in recs))
                 for k in ("all_reduce_calls", "all_reduce_bytes", "grad_all_reduce_bytes",
                           "aux_all_reduce_bytes", "all_gather_bytes",
                           "reduce_scatter_bytes")}
    return trace, ep_totals


def _costs_of(trace: hlo_analysis.StepTrace, ep_totals: dict) -> dict[str, float]:
    cost = hlo_analysis.extract_cost(trace)
    return {"flops": cost["flops"], "hbm_bytes": cost["bytes"],
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
    ) + ("__ep" if moe_ep else "") + (
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
        kw = dict(fsdp=fsdp, use_moe_ep=moe_ep, accum=accum)

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
    ep_bytes = (corrected["ep_all_reduce_bytes"] + corrected["ep_grad_all_reduce_bytes"]
                + corrected["ep_aux_all_reduce_bytes"] + corrected["ep_all_gather_bytes"]
                + corrected["ep_reduce_scatter_bytes"])
    coll.update({k: v for k, v in corrected.items() if k.startswith("ep_")})
    coll["total_bytes"] = (coll["dp_all_reduce_bytes"] + coll["fsdp_all_gather_bytes"]
                           + coll["fsdp_reduce_scatter_bytes"] + ep_bytes)
    terms = hlo_analysis.roofline(corrected["flops"], corrected["hbm_bytes"],
                                  coll["total_bytes"],
                                  residency_bytes=mem["per_device_total_bytes"])
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = hlo_analysis.model_flops_6nd(active, tokens)
    if shape.kind != "train":
        mf /= 3.0  # forward-only
    dp_ranks = dp_size(mshape) if rank_batch(shape, mshape) < shape.global_batch else 1

    record.update(
        status="ok",
        params=n_params,
        active_params=active,
        fsdp=fsdp,
        moe_ep=moe_ep,
        accum=accum,
        chips=n_chips,
        rank_batch=rank_batch(shape, mshape),
        model_axis=MODEL_AXIS_NOTE,
        memory=mem,
        raw_cost=raw,
        cost=corrected,
        collectives=coll,
        roofline=terms.to_dict(),
        model_flops=mf,
        model_flops_ratio=mf / max(corrected["flops"] * dp_ranks, 1.0),
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
                    help="attention-score/residual sharding constraints: refused, "
                         "they act only on DTensor activations")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)
    if args.act_shard:
        ap.error("--act-shard would change no number: models.act_sharding constrains "
                 "DTensor activations only, and the dry run's step runs on plain tensors")

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
                mesh_shape=args.mesh,
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
