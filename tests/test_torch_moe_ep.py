"""The port's ``models/moe_ep.py`` (expert parallelism over
``torch.distributed``) against the JAX package's ``moe.moe_apply`` and
``moe_ep.moe_apply_ep``.

Rank processes (gloo, one process each, a ``file://`` rendezvous under
``tmp_path``, a 60 s collective timeout) run the port on meshes (1, 2) and
(2, 2) (``launch.mesh.make_host_mesh``), FSDP off and on, on the two smoke
MoE configs with ``num_experts=8`` (DeepSeek-V3 at capacity factor 1.0, so
that tokens are dropped; Llama-4 at its own 8.0) and the reference's params
(``moe_init``), each rank holding its shards (``local_moe_params``) and its
data shard of the tokens.  Each rank differentiates
``L = sum(y * c) + AUX_W * aux`` (``c`` a fixed random cotangent; the
weight makes the aux path's share of the gradients far larger than the
tolerance).  Meanwhile this process runs the reference, and a JAX
subprocess with 4 forced host devices runs the reference's
``moe_apply_ep`` on a (2, 2) mesh.

Held:
* y on each rank within 1e-5 (abs + rel, f32) of the reference's
  ``moe_apply`` on the rank's data shard (capacity per shard, as the
  reference's EP computes it), the same on every model rank;
* the aux loss equal (1e-6) to the reference EP's: the mean over the data
  shards of each shard's;
* at (1, 2) every gradient within 1e-5 of the reference's ``jax.grad`` of
  ``moe_apply`` (the non-EP gradient): router and input whole on both
  ranks, experts and the shared expert's column / row slices against their
  slices.  A backward that summed the output's cotangents over the two
  model ranks would be 2x off;
* at (2, 2) the ranks' gradients summed over "data" (the FSDP expert
  shards as they come: the reduce-scatter has summed them) within 1e-5 of
  the reference's ``jax.grad`` of the global loss, ``sum(y * c)`` over the
  whole batch plus ``AUX_W`` times the mean of the data shards' aux
  losses, and each rank's input gradient against its rows.  An aux
  backward that gave each data rank the whole cotangent (the mean
  convention) would count the aux term twice;
* the traffic records: one output all-reduce per layer call, of
  T x d x 4 bytes; in the backward two cotangent all-reduces (the
  dispatched tokens, the gates); the aux loss's DP mean once, forward
  only; under FSDP three weight all-gathers and three reduce-scatters;
* a whole smoke Llama-4 (its two MoE layers) through ``api.loss`` at
  (1, 2): the loss within 1e-5 of the reference's, one traffic record (one
  all-reduce) per MoE layer;
* the layer on DTensor shards (placed by ``ep_specs``) gives the plain
  shards' y, bit for bit;
* ``make_host_mesh`` refuses a mesh that is not the world size, naming
  ``torchrun --nproc-per-node``; no rank imports ``jax``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.core.partition import tree_paths as j_tree_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
ARCHS = {"deepseek-v3-671b": dict(capacity_factor=1.0),
         "llama4-maverick-400b-a17b": {}}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
B, S = 4, 8
WHOLE = "llama4-maverick-400b-a17b"      # the whole-model case at (1, 2)
AUX_W = 100.0

_RANK_SCRIPT = r"""
import json, os, sys
from datetime import timedelta
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, data, model, out = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                  int(sys.argv[4]), sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "store"),
                        rank=rank, world_size=world, timeout=timedelta(seconds=60))

from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import mesh_coords, placements
from repro_torch.models import api, moe, moe_ep
from repro_torch.tree import tree_from_paths, tree_map_with_path, tree_paths

ARCHS = %(archs)r
WHOLE = %(whole)r
AUX_W = %(aux_w)r
meta = {"jax_loaded": "jax" in sys.modules, "errors": {}, "traffic": {},
        "dtensor_equal": {}}
try:
    make_host_mesh(world, world)
except ValueError as e:
    meta["errors"]["bad_mesh"] = str(e)
mesh = make_host_mesh(data, model, "cpu")
coords = mesh_coords(mesh)
meta["coords"] = coords


def load(name):
    z = np.load(os.path.join(out, name))
    return {k: z[k] for k in z.files}


arrays = {}
for arch, kw in ARCHS.items():
    cfg = get_config(arch, smoke=True).with_(num_experts=8, **kw)
    z = load(arch + ".npz")
    full = tree_from_paths((tuple(k[2:].split("/")), torch.as_tensor(v))
                           for k, v in z.items() if k.startswith("p/"))
    b_loc = z["x"].shape[0] // data
    sl = slice(coords["data"] * b_loc, (coords["data"] + 1) * b_loc)
    for fsdp in (False, True):
        tag = f"{arch}/{'fsdp' if fsdp else 'tp'}"
        local = moe_ep.local_moe_params(full, cfg, mesh, coords, fsdp)
        paths = [p for p, _ in tree_paths(local)]
        leaves = [x.clone().requires_grad_(True) for _, x in tree_paths(local)]
        x = torch.as_tensor(z["x"][sl]).requires_grad_(True)
        c = torch.as_tensor(z["c"][sl])
        with moe_ep.expert_parallel(mesh, fsdp) as ep:
            y, aux = moe.moe_apply(tree_from_paths(zip(paths, leaves)), cfg, x)
            loss = (y * c).sum() + AUX_W * aux
            grads = torch.autograd.grad(loss, leaves + [x])
        meta["traffic"][tag] = ep.traffic
        # the same shards as DTensors placed by ep_specs: to_local() is read
        specs = moe_ep.ep_specs(cfg, fsdp)
        placed = tree_map_with_path(
            lambda p, t: distribute_tensor(t, mesh, placements(specs[p], mesh)), full)
        with moe_ep.expert_parallel(mesh, fsdp), torch.no_grad():
            y_dt, _ = moe.moe_apply(placed, cfg, x.detach())
        meta["dtensor_equal"][tag] = bool(torch.equal(y_dt, y.detach()))
        arrays[tag + "/y"] = y.detach().numpy()
        arrays[tag + "/aux"] = aux.detach().numpy()
        for p, g in zip(paths + [("x",)], grads):
            arrays[tag + "/g/" + "/".join(p)] = g.numpy()

if data == 1:
    # the whole smoke Llama-4, both layers MoE, through api.loss
    cfg = get_config(WHOLE, smoke=True).with_(num_experts=8)
    z = load("whole.npz")
    full = tree_from_paths((tuple(k[2:].split("/")), torch.as_tensor(v))
                           for k, v in z.items() if k.startswith("p/"))
    batch = {"tokens": torch.as_tensor(z["tokens"]), "labels": torch.as_tensor(z["labels"])}
    with moe_ep.expert_parallel(mesh) as ep:
        loss = api.loss(moe_ep.local_moe_params(full, cfg, mesh, coords), cfg, batch)
    arrays["whole/loss"] = loss.detach().numpy()
    meta["traffic"]["whole"] = ep.traffic

np.savez(os.path.join(out, f"r{rank}.npz"), **arrays)
meta["jax_loaded"] = meta["jax_loaded"] or "jax" in sys.modules
with open(os.path.join(out, f"meta_r{rank}.json"), "w") as f:
    json.dump(meta, f)
dist.destroy_process_group()
"""

# the reference's EP aux on a (2, 2) mesh of 4 forced host devices
_JAX_EP_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.models import moe, moe_ep

out = {}
for arch, kw in %(archs)r.items():
    cfg = get_config(arch, smoke=True).with_(num_experts=8, **kw)
    z = np.load(os.path.join(%(out)r, arch + ".npz"))
    params = {}
    for k in z.files:
        if k.startswith("p/"):
            node = params
            parts = k[2:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(z[k])
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    with moe_ep.expert_parallel(mesh), mesh:
        y, aux = jax.jit(lambda p, x: moe.moe_apply(p, cfg, x))(params, jnp.asarray(z["x"]))
    out[arch] = {"aux": float(aux), "y": np.asarray(y).tolist()}
print(json.dumps(out))
"""


def _cfg(arch):
    return j_get_config(arch, smoke=True).with_(num_experts=8, **ARCHS[arch])


def _inputs(arch, seed):
    cfg = _cfg(arch)
    params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(seed), cfg, jnp.float32))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return cfg, params, x, c


def _save_inputs(out, arch, seed):
    _, params, x, c = _inputs(arch, seed)
    np.savez(out / f"{arch}.npz", x=x, c=c,
             **{"p/" + "/".join(p): v for p, v in j_tree_paths(params)})


def _reference(arch, seed):
    """The reference's y and aux per data shard of (1, 2) and (2, 2), and
    per mesh its gradients of the global loss: ``sum(y * c)`` over the
    whole batch plus the mean of the data shards' aux losses."""
    cfg, params, x, c = _inputs(arch, seed)

    def run(p, xx):
        return jmoe.moe_apply(p, cfg, xx)

    def loss(p, xx, cc, data):
        h = B // data
        outs = [(run(p, xx[i * h:(i + 1) * h]), cc[i * h:(i + 1) * h]) for i in range(data)]
        return (sum(jnp.sum(y * ci) for (y, _), ci in outs)
                + AUX_W * sum(aux for (_, aux), _ in outs) / data)

    ref = {"1x2": [run(params, x)],
           "2x2": [run(params, x[i * B // 2:(i + 1) * B // 2]) for i in range(2)]}
    grads = {}
    for name, (data, _) in MESHES.items():
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, x, c, data)
        grads[name] = {"/".join(p): np.asarray(v) for p, v in j_tree_paths(gp)}
        grads[name]["x"] = np.asarray(gx)
    return {k: [(np.asarray(y), float(a)) for y, a in v] for k, v in ref.items()}, grads


def _whole_reference(out):
    cfg = j_get_config(WHOLE, smoke=True).with_(num_experts=8)
    params = japi.init(jax.random.key(3), cfg)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    np.savez(out / "whole.npz", tokens=tokens, labels=labels,
             **{"p/" + "/".join(p): np.asarray(v) for p, v in j_tree_paths(params)})
    return float(japi.loss(params, cfg, {"tokens": jnp.asarray(tokens),
                                          "labels": jnp.asarray(labels)}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both meshes' ranks and the JAX EP subprocess, compute the
    reference meanwhile; returns the ranks' arrays and meta per mesh, the
    reference and the JAX EP output."""
    base = tmp_path_factory.mktemp("moe_ep")
    for i, arch in enumerate(ARCHS):
        _save_inputs(base, arch, i)
    whole_loss = _whole_reference(base)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = {}
    for name, (data, model) in MESHES.items():
        out = base / name
        out.mkdir()
        for f in [f"{a}.npz" for a in ARCHS] + ["whole.npz"]:
            os.link(base / f, out / f)
        script = _RANK_SCRIPT % {"archs": ARCHS, "whole": WHOLE, "aux_w": AUX_W}
        procs[name] = [subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(data * model), str(data), str(model),
             str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(data * model)]
    jax_env = {**env, "JAX_PLATFORMS": "cpu"}
    jproc = subprocess.Popen([sys.executable, "-c", _JAX_EP_SCRIPT % {
        "archs": ARCHS, "out": str(base)}], cwd=ROOT, env=jax_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    all_procs = [p for ps in procs.values() for p in ps] + [jproc]
    try:
        refs = {arch: _reference(arch, i) for i, arch in enumerate(ARCHS)}
        logs = {p: p.communicate(timeout=240) for p in all_procs}
    finally:
        for p in all_procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p in all_procs:
        assert p.returncode == 0, logs[p][1][-3000:]
    got = {}
    for name, (data, model) in MESHES.items():
        ranks = []
        for r in range(data * model):
            with np.load(base / name / f"r{r}.npz") as z:
                arrays = {k: z[k] for k in z.files}
            with open(base / name / f"meta_r{r}.json") as f:
                ranks.append((arrays, json.load(f)))
        got[name] = ranks
    jax_ep = json.loads(logs[jproc][0].strip().splitlines()[-1])
    return got, refs, jax_ep, whole_loss


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b) - tol * (1 + np.abs(b))
    assert float(err.max()) <= 0, float((np.abs(a - b)).max())


def test_ranks_import_no_jax_and_refuse_a_bad_mesh(runs):
    got, *_ = runs
    for name, ranks in got.items():
        for _, meta in ranks:
            assert not meta["jax_loaded"]
            msg = meta["errors"]["bad_mesh"]
            world = MESHES[name][0] * MESHES[name][1]
            assert f"torchrun --nproc-per-node {world * world}" in msg, msg


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_reference(runs, arch, mesh, mode):
    got, refs, jax_ep, _ = runs
    data, model = MESHES[mesh]
    ref, _ = refs[arch]
    for arrays, meta in got[mesh]:
        y_ref, aux_ref = ref[mesh][meta["coords"]["data"]]
        _close(arrays[f"{arch}/{mode}/y"], y_ref)
        # the aux loss: the reference EP's mean over the data shards
        want = jax_ep[arch]["aux"] if mesh == "2x2" else aux_ref
        assert abs(float(arrays[f"{arch}/{mode}/aux"]) - want) <= 1e-6 * (1 + abs(want))
    if mesh == "2x2":
        # the reference's own EP agrees with its per-shard moe_apply
        y_ep = np.asarray(jax_ep[arch]["y"])
        _close(y_ep, np.concatenate([y for y, _ in ref[mesh]]))


def _model_slice(path, want, m, model):
    """The part of the whole gradient ``want`` of ``path`` that model rank
    ``m`` of ``model`` holds (``moe_ep.ep_specs``, without FSDP)."""
    axis = {"shared/w_gate/w": 1, "shared/w_up/w": 1, "shared/w_down/w": 0}.get(
        path, 0 if path.startswith("experts/") else None)
    if axis is None:
        return want
    f = want.shape[axis] // model
    return np.take(want, range(m * f, (m + 1) * f), axis=axis)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_gradients_match_reference(runs, arch, mode):
    """At (1, 2): each rank's gradients against the reference's non-EP
    gradient, its shards against their slices."""
    got, refs, _, _ = runs
    grads = refs[arch][1]["1x2"]
    for arrays, meta in got["1x2"]:
        m = meta["coords"]["model"]
        n = 0
        for key, g in arrays.items():
            if not key.startswith(f"{arch}/{mode}/g/"):
                continue
            path = key[len(f"{arch}/{mode}/g/"):]
            _close(g, _model_slice(path, grads[path], m, 2))
            n += 1
        assert n == len(grads)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_gradients_summed_over_data_match_reference(runs, arch, mode):
    """At (2, 2): the ranks' gradients summed over "data" against the
    reference's gradient of the global loss, at each model rank.  Under
    FSDP each expert shard (its d_model slice on "data") is compared as it
    comes, the reduce-scatter having summed it; each rank's input gradient
    against its own rows."""
    got, refs, _, _ = runs
    grads = refs[arch][1]["2x2"]
    data, model = MESHES["2x2"]
    pre = f"{arch}/{mode}/g/"
    by = {(meta["coords"]["data"], meta["coords"]["model"]): arrays
          for arrays, meta in got["2x2"]}
    assert {k[len(pre):] for k in by[0, 0] if k.startswith(pre)} == set(grads)
    h = B // data
    for m in range(model):
        for path, whole in grads.items():
            mine = [by[d, m][pre + path] for d in range(data)]
            if path == "x":
                for d in range(data):
                    _close(mine[d], whole[d * h:(d + 1) * h])
                continue
            want = _model_slice(path, whole, m, model)
            if mode == "fsdp" and path.startswith("experts/"):
                axis = 2 if path.endswith("w_down") else 1
                f = want.shape[axis] // data
                for d in range(data):
                    _close(mine[d], np.take(want, range(d * f, (d + 1) * f), axis=axis))
            else:
                _close(sum(mine), want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_traffic_one_all_reduce_per_layer(runs, mesh):
    got, *_ = runs
    d = _cfg(WHOLE).d_model
    for arrays, meta in got[mesh]:
        for arch in ARCHS:
            for mode in ("tp", "fsdp"):
                (rec,) = meta["traffic"][f"{arch}/{mode}"]
                t = B // MESHES[mesh][0] * S
                assert rec["tokens"] == t
                assert rec["all_reduce_calls"] == 1
                assert rec["all_reduce_bytes"] == t * d * 4
                assert rec["grad_all_reduce_calls"] == 2
                assert rec["aux_all_reduce_calls"] == 1        # forward only
                gathers = 3 if mode == "fsdp" else 0
                assert rec["all_gather_calls"] == rec["reduce_scatter_calls"] == gathers


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dtensor_shards_give_the_same_layer(runs, mesh):
    got, *_ = runs
    for _, meta in got[mesh]:
        assert meta["dtensor_equal"] and all(meta["dtensor_equal"].values())


def test_whole_model_loss_and_layer_count(runs):
    got, _, _, whole_loss = runs
    cfg = _cfg(WHOLE)
    for arrays, meta in got["1x2"]:
        assert abs(float(arrays["whole/loss"]) - whole_loss) <= TOL * (1 + abs(whole_loss))
        recs = meta["traffic"]["whole"]
        assert len(recs) == cfg.num_layers - cfg.first_dense_layers == 2
        assert all(r["all_reduce_calls"] == 1 for r in recs)
