"""The dry run on the sharded step (``launch/dryrun.py`` ``_trace_at`` on a
``DeviceMesh``, ``launch/hlo_analysis.py`` ``trace_step``): its counts are
per device.

In a subprocess (the dry run makes its own ``"fake"`` process group, which
must not meet this process's), against a JAX subprocess with 2 forced host
devices running the reference's ``test_dryrun_small`` compile:

* one DTensor product, (64, 128) @ (128, 256) with the weight ``Shard(1)``
  over 2 ranks: ``FlopCounterMode`` counts the global 4,194,304 FLOPs, the
  dry run's counter (``hlo_analysis.trace_step``) each rank's 2,097,152;
* smoke TinyLlama ``train`` 64 x 8: the per-device FLOPs at mesh (1, 2) over
  those at (1, 1) are at most 0.6 and within 0.1 of the reference's XLA
  ``cost_analysis`` ratio for the same two meshes (its train step jitted
  with the reference's ``in_shardings`` / ``out_shardings``); op bytes and
  the activation peak fall too;
* at mesh (2, 1) a train step's collectives hold the data-axis gradient
  all-reduce: ``CommDebugMode`` counts ``all_reduce`` calls, and their
  result bytes cover the gradient bytes reckoned from the placements
  (``dp_all_reduce_bytes``), with only a few KB (the loss's reductions)
  beyond them; at (1, 1) the step runs no collective;
* at mesh (1, 2) the collectives are tensor parallelism's: a prefill
  all-reduces the residual stream once a sublayer (2 L + 1 calls: the
  vocab-parallel embedding's pending sum and each attention and MLP
  output's, at the next norm), a train step its gradients too, with no
  reduce-scatter or all-to-all, and the train step's all-gathers (the
  norms' scales) move under 1% of the rank's parameter bytes: no weight
  is gathered (DTensor's own choices gathered 2.6 times them);
* ``--act-shard`` (LLaVA smoke, 4 heads, on a (1, 8) mesh where they do not
  divide) lowers the record's activation peak and tags it ``__act``; where
  the heads divide (TinyLlama at (1, 2)) it changes no count;
* ``MODEL_AXIS_NOTE`` is gone and no ``jax`` is imported;
* the dry run refuses to count, rather than count DTensor's global-shape
  work as this rank's: with its metadata patches left out, ``fake_world``'s
  probe product raises, and a patch target this torch lacks raises on
  entry (a subprocess of its own, so that no propagation is cached).
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PORT = r"""
import json, os, sys
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import torch
torch.set_num_threads(1)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.api import InputShape

out = {}
with dryrun.fake_world(2):
    mesh = make_host_mesh(1, 2, "cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.randn(64, 128), mesh, [Replicate(), Replicate()])
        w = distribute_tensor(torch.randn(128, 256), mesh, [Replicate(), Shard(1)])
        with FlopCounterMode(display=False) as fc:
            x @ w
        _, tr = hlo_analysis.trace_step(lambda: x @ w, (x, w))
    out["matmul"] = {"global": fc.get_total_flops(), "local": tr.flops}

cfg = get_config("tinyllama-1.1b", smoke=True)
shape = InputShape("t", 64, 8, "train")
for d, m in ((1, 1), (1, 2), (2, 1)):
    with dryrun.fake_world(d * m):
        tr, _ = dryrun._trace_at(cfg, shape, make_host_mesh(d, m, "cpu"))
    out[f"{d}x{m}"] = {"flops": tr.flops, "op_bytes": tr.op_bytes,
                       "peak": tr.act_peak_bytes, "coll": tr.coll_bytes,
                       "calls": tr.coll_calls, "comm": tr.comm_counts}
_, coll = dryrun.residency(cfg, shape, make_host_mesh.__globals__["MeshShape"]((2, 1)),
                           fsdp=False)
out["reckoned_dp"] = coll["dp_all_reduce_bytes"]
with dryrun.fake_world(2):
    tr, _ = dryrun._trace_at(cfg, InputShape("p", 64, 4, "prefill"), make_host_mesh(1, 2, "cpu"))
out["prefill_1x2_calls"] = tr.coll_calls
out["layers"] = cfg.num_layers
out["param_bytes_1x2"] = dryrun.param_residency(cfg, make_host_mesh.__globals__["MeshShape"]((1, 2)))

llava = get_config("llava-next-34b", smoke=True)
for act in (False, True):
    r = dryrun.analyze_pair("llava-next-34b", "train_4k", mesh_shape="1,8", act_shard=act,
                            probes=False, save=False, verbose=False, cfg=llava)
    out[f"llava_act{int(act)}"] = {"peak": r["memory"]["act_peak_bytes"],
                                   "act_shard": r["act_shard"], "keys": sorted(r)}
tiny = {}
for act in (False, True):
    r = dryrun.analyze_pair("tinyllama-1.1b", "prefill_32k", mesh_shape="1,2",
                            act_shard=act, probes=False, save=False, verbose=False, cfg=cfg)
    tiny[act] = [r["cost"]["flops"], r["memory"]["act_peak_bytes"]]
out["tiny_act_same"] = tiny[False] == tiny[True]
out["has_note"] = hasattr(dryrun, "MODEL_AXIS_NOTE")
out["jax_loaded"] = "jax" in sys.modules
out["group_left"] = torch.distributed.is_initialized()
print(json.dumps(out, default=str))
"""

_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json, sys
sys.path.insert(0, "src")
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch import hlo_analysis, steps
from repro.launch.sharding import input_shardings, params_shardings
from repro.models import api
from repro.models.api import InputShape

cfg = get_config("tinyllama-1.1b", smoke=True)
shape = InputShape("t", 64, 8, "train")
params = jax.eval_shape(lambda: api.init(jax.random.key(0), cfg))
specs = api.input_specs(cfg, shape)
opt = jax.eval_shape(steps.init_opt_state, params)
out = {}
for d, m in ((1, 1), (1, 2)):
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
    p_shard = params_shardings(params, mesh)
    o_shard = type(opt)(step=NamedSharding(mesh, P()), m=params_shardings(opt.m, mesh),
                        v=params_shardings(opt.v, mesh))
    with mesh:
        compiled = jax.jit(
            steps.make_train_step(cfg, remat=True),
            in_shardings=(p_shard, o_shard, input_shardings(specs, mesh)),
            out_shardings=(p_shard, o_shard, NamedSharding(mesh, P())),
        ).lower(params, opt, specs).compile()
    out[f"{d}x{m}"] = hlo_analysis.extract_cost(compiled)["flops"]
print(json.dumps(out))
"""


_REFUSE = r"""
import json, os, sys
from contextlib import nullcontext
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
from torch.distributed.tensor import _sharding_prop
from repro_torch.launch import dryrun

out = {}
patches = dryrun._dtensor_metadata_unfaked
dryrun._dtensor_metadata_unfaked = nullcontext
try:
    with dryrun.fake_world(2):
        out["unpatched"] = "ran"
except RuntimeError as e:
    out["unpatched"] = str(e)
dryrun._dtensor_metadata_unfaked = patches
cls = _sharding_prop.ShardingPropagator
orig = cls.__dict__["_propagate_tensor_meta_non_cached"]
del cls._propagate_tensor_meta_non_cached
try:
    with dryrun.fake_world(2):
        out["missing"] = "ran"
except RuntimeError as e:
    out["missing"] = str(e)
cls._propagate_tensor_meta_non_cached = orig
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-c", src], cwd=ROOT, env=e,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, e in ((_PORT, env), (_JAX, {**env, "JAX_PLATFORMS": "cpu"}),
                            (_REFUSE, env))]
    try:
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in logs]


def test_dtensor_matmul_counts_this_ranks_flops(runs):
    port = runs[0]
    assert port["matmul"]["global"] == 2 * 64 * 128 * 256 == 4_194_304
    assert port["matmul"]["local"] == 2_097_152


def test_flop_ratio_matches_reference(runs):
    port, ref = runs[:2]
    ours = port["1x2"]["flops"] / port["1x1"]["flops"]
    theirs = ref["1x2"] / ref["1x1"]
    assert ours <= 0.6
    assert abs(ours - theirs) <= 0.1, (ours, theirs)
    for k in ("op_bytes", "peak"):
        assert port["1x2"][k] < port["1x1"][k], k


def test_train_step_all_reduces_gradients_over_data(runs):
    port = runs[0]
    r = port["2x1"]
    assert any("all_reduce" in k and n > 0 for k, n in r["comm"].items()), r["comm"]
    assert r["calls"]["all-reduce"] > 0
    reckoned = port["reckoned_dp"]
    assert reckoned > 0
    assert reckoned <= r["coll"]["all-reduce"] <= reckoned + 8192, (reckoned, r["coll"])
    assert sum(port["1x1"]["coll"].values()) == 0 and not port["1x1"]["comm"]


def test_act_shard_takes_effect(runs):
    port = runs[0]
    off, on = port["llava_act0"], port["llava_act1"]
    assert on["act_shard"] and not off["act_shard"]
    assert on["peak"] < off["peak"]
    assert port["tiny_act_same"]


def test_no_model_axis_note_and_no_jax(runs):
    port = runs[0]
    assert not port["has_note"]
    assert "model_axis" not in port["llava_act0"]["keys"]
    assert not port["jax_loaded"] and not port["group_left"]


def test_dry_run_refuses_dtensor_level_counts(runs):
    refused = runs[2]
    assert "counts DTensor-level work" in refused["unpatched"], refused
    assert "_propagate_tensor_meta_non_cached" in refused["missing"], refused


def test_model_axis_collectives_are_tensor_parallel(runs):
    port = runs[0]
    pre, train = port["prefill_1x2_calls"], port["1x2"]
    assert pre["all-reduce"] == 2 * port["layers"] + 1, pre
    for calls in (pre, train["calls"]):
        assert calls["reduce-scatter"] == 0 and calls["all-to-all"] == 0, calls
    assert train["coll"]["all-gather"] < 0.01 * port["param_bytes_1x2"], train["coll"]
