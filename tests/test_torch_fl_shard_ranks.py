"""The port's shard_map engine across two ranks (gloo, one process each)
against the JAX package's sequential engine.

Two rank processes are started with a ``file://`` rendezvous under
``tmp_path`` and a 60 s collective timeout; each imports only
``repro_torch`` (checked: ``jax`` is not in ``sys.modules``), runs every
case of ``CASES`` through ``fl.run_federated(engine="shard_map",
device="cpu")`` and writes its params, per-round losses, accuracies and
books to ``.npz``.  Meanwhile this process runs the reference's sequential
engine on the same inputs (the reference's initial parameters, written
for the ranks over numpy; the same host draws), then holds rank 0 to it
and rank 1 to rank 0 bit for bit: the all-reduced sums are the same on
every rank, and so are the spliced params.

Cases, as ``tests/test_engine_equivalence.py``'s two-device script: ResNet-4
on 3 ragged clients (36 / 56 / 40: one bucket padded 3 -> 4, two clients a
rank, the fourth a padding client) for FedAvg, FedProx and MOON, fused
(one cohort-kernel launch per step, the packed transmitted-rows epilogue)
and unfused; the two-bucket cohort (12 / 36 / 20: each bucket padded to
2); a nested per-client plan; the async runtime at in-flight 1 (cohorts
sharded over both ranks) and 2 (each cohort on one rank's slot, then
broadcast), both in the degenerate configuration that equals the sync
run; int8 and top-k compression over two rounds of cohorts of 2 (seed 1:
client 1 trains on rank 1, then on rank 0, with the residual rank 1 left
it).

Tolerances: f32, ``adam_eps=1e-3``, params and per-round losses ≤1e-5 (the
reference's own bar for its engines; the compressed runs too), accuracy
within one eval sample; cost books exact.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core.schedule import FedPartSchedule
from repro.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                        make_vision_dataset)
from repro.fl import AlgoConfig, FLRunConfig, resnet_task, run_federated
from repro.core.partition import tree_paths as j_tree_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
WORLD = 2
RAGGED, BUCKETS = (36, 56, 40), (12, 36, 20)
# name -> (client sizes, first round of the mixed schedule, config fields)
CASES = {
    "fedavg": (RAGGED, 0, dict(algo="fedavg", fused_adam=True)),
    "fedavg_unfused": (RAGGED, 0, dict(algo="fedavg")),
    "fedprox": (RAGGED, 0, dict(algo="fedprox", fused_adam=True)),
    "fedprox_unfused": (RAGGED, 0, dict(algo="fedprox")),
    "moon": (RAGGED, 0, dict(algo="moon", fused_adam=True)),
    "moon_unfused": (RAGGED, 0, dict(algo="moon")),
    "buckets": (BUCKETS, 1, dict(algo="fedavg", fused_adam=True)),
    "nested": (RAGGED, 0, dict(algo="fedavg", fused_adam=True, plan="nested",
                               capacity_tiers=(0.3, 0.6, 1.0), partial_group=4)),
    "async_inflight1": (RAGGED, 0, dict(algo="fedavg", fused_adam=True,
                                        runtime="async", max_inflight_cohorts=1)),
    "async_inflight2": (RAGGED, 0, dict(algo="fedavg", fused_adam=True,
                                        runtime="async", max_inflight_cohorts=2)),
    "int8_moves": (RAGGED, 0, dict(algo="fedavg", fused_adam=True, compression="int8",
                                   cohort_size=2, seed=1)),
    "topk_moves": (RAGGED, 0, dict(algo="fedavg", compression="topk",
                                   topk_fraction=0.05, cohort_size=2, seed=1)),
}
# the reference run each case is held to (the async runs equal the sync one)
REFERENCE = {"async_inflight1": "fedavg", "async_inflight2": "fedavg"}

_RANK_SCRIPT = r"""
import json, os, sys
from datetime import timedelta
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "store"),
                        rank=rank, world_size=world, timeout=timedelta(seconds=60))

from repro_torch import fl
from repro_torch.core.schedule import FedPartSchedule, RoundSpec
from repro_torch.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                              make_vision_dataset)
from repro_torch.fl.batched import ShardMapEngine
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.tree import tree_from_paths, tree_paths

CASES = %(cases)r
init_npz = np.load(os.path.join(out, "init.npz"))
init = tree_from_paths((tuple(k.split("/")), torch.as_tensor(init_npz[k]))
                       for k in init_npz.files)
spec = VisionDatasetSpec(num_classes=4, image_size=8)
xe, ye = make_vision_dataset(spec, 64, seed=9)
eval_set = balanced_eval_set(xe, ye, per_class=8)
adapter = fl.resnet_task("resnet4", num_classes=4)
mixed = FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1,
                        cycles=1).rounds()[:2]
meta = {"jax_loaded": "jax" in sys.modules, "errors": {}, "traffic": {}}
for n in (1, 3):
    try:
        make_client_mesh(n, "cpu")
    except ValueError as e:
        meta["errors"][str(n)] = str(e)
for name, (sizes, first, kw) in CASES.items():
    kw = dict(kw)
    x, y = make_vision_dataset(spec, sum(sizes), seed=0)
    bounds = np.cumsum((0,) + tuple(sizes))
    clients = build_clients(x, y, [np.arange(bounds[i], bounds[i + 1])
                                   for i in range(len(sizes))])
    rounds = mixed[first:]
    if "partial_group" in kw:
        rounds = [mixed[0], RoundSpec(1, "partial", 0, kw.pop("partial_group"))]
    cfg = fl.FLRunConfig(local_epochs=1, batch_size=16, lr=2e-3, adam_eps=1e-3,
                         engine="shard_map", sim_devices=world, device="cpu",
                         algo=fl.AlgoConfig(name=kw.pop("algo")), **kw)
    ShardMapEngine.traffic = []
    res = fl.run_federated(adapter, clients, eval_set, rounds, cfg, init_params=init)
    meta["traffic"][name] = ShardMapEngine.traffic
    arrays = {"p/" + "/".join(p): v.numpy() for p, v in tree_paths(res.params)}
    arrays["loss"] = np.asarray([h["loss"] for h in res.history])
    arrays["acc"] = np.asarray([h["acc"] for h in res.history])
    arrays["books"] = np.asarray([res.comm_total_bytes, res.comm_fnu_bytes,
                                  res.comp_total_flops, res.comp_fnu_flops])
    np.savez(os.path.join(out, f"{name}_r{rank}.npz"), **arrays)
meta["jax_loaded"] = meta["jax_loaded"] or "jax" in sys.modules
with open(os.path.join(out, f"meta_r{rank}.json"), "w") as f:
    json.dump(meta, f)
dist.destroy_process_group()
"""


def _setup(sizes):
    spec = VisionDatasetSpec(num_classes=4, image_size=8)
    x, y = make_vision_dataset(spec, sum(sizes), seed=0)
    xe, ye = make_vision_dataset(spec, 64, seed=9)
    bounds = np.cumsum((0,) + tuple(sizes))
    parts = [np.arange(bounds[i], bounds[i + 1]) for i in range(len(sizes))]
    return (resnet_task("resnet4", num_classes=4), build_clients(x, y, parts),
            balanced_eval_set(xe, ye, per_class=8))


def _reference(name):
    """The reference's sequential run of case ``name`` (unfused: the fused
    and unfused forms agree within 1e-5, test_torch_fl_vmap.py)."""
    sizes, first, kw = CASES[name]
    kw = {k: v for k, v in kw.items() if k != "fused_adam"}
    adapter, clients, eval_set = _setup(sizes)
    mixed = FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1,
                            cycles=1).rounds()[:2]
    rounds = mixed[first:]
    if "partial_group" in kw:
        rounds = [mixed[0], type(mixed[1])(index=1, phase="partial", cycle=0,
                                           group=kw.pop("partial_group"))]
    cfg = FLRunConfig(local_epochs=1, batch_size=16, lr=2e-3, adam_eps=1e-3,
                      engine="sequential", algo=AlgoConfig(name=kw.pop("algo")), **kw)
    return run_federated(adapter, clients, eval_set, rounds, cfg,
                         init_key=jax.random.key(0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks, run the reference meanwhile, and return
    ``(out dir, {name: reference result})`` once both ranks exited 0."""
    out = tmp_path_factory.mktemp("shard_ranks")
    adapter = resnet_task("resnet4", num_classes=4)
    init = adapter.init(jax.random.key(0))
    np.savez(out / "init.npz", **{"/".join(p): np.asarray(v)
                                  for p, v in j_tree_paths(init)})
    script = _RANK_SCRIPT % {"cases": CASES}
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(WORLD), str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        refs = {name: _reference(name) for name in CASES if name not in REFERENCE}
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    return out, refs


def _load(out, name, rank):
    with np.load(out / f"{name}_r{rank}.npz") as z:
        return {k: z[k] for k in z.files}


def test_ranks_import_no_jax_and_refuse_other_mesh_sizes(ranks):
    out, _ = ranks
    for r in range(WORLD):
        meta = json.loads((out / f"meta_r{r}.json").read_text())
        assert meta["jax_loaded"] is False
        assert "torchrun --nproc-per-node 3" in meta["errors"]["3"]
        assert "spans every rank" in meta["errors"]["1"]


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_reference(ranks, name):
    out, refs = ranks
    ref = refs[REFERENCE.get(name, name)]
    got = _load(out, name, 0)
    ref_leaves = j_tree_paths(jax.tree.map(np.asarray, ref.params))
    assert sorted("p/" + "/".join(p) for p, _ in ref_leaves) == \
        sorted(k for k in got if k.startswith("p/"))
    for path, leaf in ref_leaves:
        np.testing.assert_allclose(got["p/" + "/".join(path)], leaf, rtol=TOL, atol=TOL,
                                   err_msg=f"{name}: {'/'.join(path)}")
    np.testing.assert_allclose(got["loss"], [h["loss"] for h in ref.history],
                               rtol=TOL, atol=TOL)
    assert np.abs(got["acc"] - [h["acc"] for h in ref.history]).max() <= 1 / 32 + 1e-9
    assert got["books"].tolist() == [ref.comm_total_bytes, ref.comm_fnu_bytes,
                                     ref.comp_total_flops, ref.comp_fnu_flops]


@pytest.mark.parametrize("name", list(CASES))
def test_both_ranks_hold_bit_equal_params(ranks, name):
    out, _ = ranks
    a, b = _load(out, name, 0), _load(out, name, 1)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{name}: {k} differs between the ranks"


def test_sync_rounds_all_reduce_one_update_per_bucket(ranks):
    """One all-reduce per bucket and round, of the packed transmitted rows
    alone when fused (BN moments never travel), the same on both ranks."""
    out, _ = ranks
    metas = [json.loads((out / f"meta_r{r}.json").read_text()) for r in range(WORLD)]
    assert metas[0]["traffic"] == metas[1]["traffic"]
    traffic = metas[0]["traffic"]
    assert [t["all_reduce_calls"] for t in traffic["fedavg"]] == [1, 1]
    assert [t["all_reduce_calls"] for t in traffic["buckets"]] == [2]
    fnu, part = traffic["fedavg"]
    # fused: rows x 128 lanes x 4 bytes; a partial round moves a strict subset
    assert fnu["all_reduce_bytes"] % 512 == 0 and part["all_reduce_bytes"] % 512 == 0
    assert part["all_reduce_bytes"] < fnu["all_reduce_bytes"]
    assert traffic["async_inflight1"] == [] and traffic["async_inflight2"] == []
