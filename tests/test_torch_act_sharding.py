"""The port's ``models/act_sharding.py`` against the JAX package's.

* The score / residual layouts: the port's ``scores_spec`` / ``resid_spec``
  equal the specs the reference's ``constrain_scores`` / ``constrain_resid``
  build under ``activation_sharding(mesh)``, captured by patching
  ``jax.lax.with_sharding_constraint`` and the module's ``NamedSharding``
  in this process (no reference file changes), for meshes 16 x 16, 32 x 8,
  2 x 16 x 16, 4 x 2 and a model-only 8, on score shapes where heads
  divide, where they do not (LLaVA's 56) and where neither heads nor query
  positions do, and residual shapes with and without a dividing batch.
  Where the reference adds no constraint the port's spec is None.
* Outside the context, and for a plain tensor inside it, the port returns
  its argument itself.
* Two gloo ranks (subprocesses, ``file://`` rendezvous under
  ``tmp_path``, 60 s timeout) on meshes (1, 2) and (2, 1): a replicated
  DTensor comes out of ``constrain_scores`` / ``constrain_resid`` with the
  placements of those specs and the same values; ``sharding.shard_params``
  places a smoke TinyLlama so that each rank's local tensors are its
  ``local_shard`` blocks.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import act_sharding as jact
from repro_torch.launch.mesh import MeshShape, mesh_override_shape
from repro_torch.models import act_sharding

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ["16,16", "32,8", "2,16,16", "4,2", "8"]
SCORES = [(256, 32, 4096, 4096), (256, 56, 4096, 4096), (1, 56, 4096, 4096),
          (3, 7, 5, 5), (128, 32, 1, 32768), (32, 12, 416, 1500)]
RESIDS = [(256, 4096, 7168), (1, 4096, 2048), (3, 5, 7)]


class _JMesh:
    def __init__(self, m: MeshShape):
        self.axis_names = m.mesh_dim_names
        self.shape = dict(zip(m.mesh_dim_names, m.shape))


def _reference_spec(fn, mesh: MeshShape, shape, monkeypatch):
    """The spec ``fn`` (the reference's constrain_*) passes to
    ``with_sharding_constraint``, or None when it passes nothing."""
    seen = []
    monkeypatch.setattr(jact, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s)) or x)
    x = np.broadcast_to(np.zeros((), np.float32), shape)    # shape only, no storage
    with jact.activation_sharding(_JMesh(mesh)):
        fn(x)
    assert len(seen) <= 1
    return seen[0] if seen else None


@pytest.mark.parametrize("mesh", MESHES)
def test_layouts_match_reference(mesh, monkeypatch):
    m = mesh_override_shape(mesh)
    for shape in SCORES:
        want = _reference_spec(jact.constrain_scores, m, shape, monkeypatch)
        assert act_sharding.scores_spec(shape, m) == want, shape
    for shape in RESIDS:
        want = _reference_spec(jact.constrain_resid, m, shape, monkeypatch)
        assert act_sharding.resid_spec(shape, m) == want, shape


def test_plain_tensors_pass_through():
    x4, x3 = torch.zeros(2, 4, 3, 3), torch.zeros(2, 3, 5)
    assert not act_sharding.enabled()
    assert act_sharding.constrain_scores(x4) is x4
    with act_sharding.activation_sharding(MeshShape((1, 2))):
        assert act_sharding.enabled()
        assert act_sharding.constrain_scores(x4) is x4
        assert act_sharding.constrain_resid(x3) is x3
    assert not act_sharding.enabled()


_RANK_SCRIPT = r"""
import json, os, sys
from datetime import timedelta
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, distribute_tensor

torch.set_num_threads(1)
rank, out = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "store"),
                        rank=rank, world_size=2, timeout=timedelta(seconds=60))
from repro_torch.configs import get_config
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import act_sharding, api
from repro_torch.tree import tree_paths

res = {"jax_loaded": "jax" in sys.modules}
for data, model in ((1, 2), (2, 1)):
    mesh = make_host_mesh(data, model, "cpu")
    name = f"{data}x{model}"
    gen = torch.Generator().manual_seed(0)
    x4 = torch.randn(2, 4, 6, 6, generator=gen)
    x4odd = torch.randn(2, 3, 6, 6, generator=gen)
    x3 = torch.randn(2, 6, 8, generator=gen)
    with act_sharding.activation_sharding(mesh):
        for key, x, fn, spec_fn in (("scores", x4, act_sharding.constrain_scores,
                                     act_sharding.scores_spec),
                                    ("scores_odd", x4odd, act_sharding.constrain_scores,
                                     act_sharding.scores_spec),
                                    ("resid", x3, act_sharding.constrain_resid,
                                     act_sharding.resid_spec)):
            d = distribute_tensor(x, mesh, [Replicate()] * 2)
            y = fn(d)
            spec = spec_fn(tuple(x.shape), mesh)
            want = (sharding.placements(spec, mesh) if spec is not None
                    else tuple(d.placements))
            res[f"{name}/{key}"] = {
                "placements": str(tuple(y.placements)), "want": str(want),
                "values_equal": bool(torch.equal(y.full_tensor(), x)),
                "plain_returned": fn(x) is x}
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = api.init(torch.Generator().manual_seed(1), cfg, "cpu")
    placed = sharding.shard_params(params, mesh)
    specs = sharding.params_specs(params, mesh)
    coords = sharding.mesh_coords(mesh)
    ok = all(torch.equal(d.to_local(), sharding.local_shard(p, specs["/".join(k)], mesh,
                                                            coords))
             for (k, d), (_, p) in zip(tree_paths(placed), tree_paths(params)))
    res[f"{name}/shard_params"] = ok
    res[f"{name}/sharded_leaves"] = sum(any(s is not None for s in sp)
                                        for sp in specs.values())
res["jax_loaded"] = res["jax_loaded"] or "jax" in sys.modules
with open(os.path.join(out, f"r{rank}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("act_ranks")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(r), str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    results = []
    for r in range(2):
        with open(out / f"r{r}.json") as f:
            results.append(json.load(f))
    return results


@pytest.mark.parametrize("key", ["scores", "scores_odd", "resid"])
@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_dtensor_takes_the_layout(ranks, mesh, key):
    for res in ranks:
        assert not res["jax_loaded"]
        r = res[f"{mesh}/{key}"]
        assert r["placements"] == r["want"]
        assert r["values_equal"] and r["plain_returned"]


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_shard_params_places_local_shards(ranks, mesh):
    for res in ranks:
        assert res[f"{mesh}/shard_params"]
        assert res[f"{mesh}/sharded_leaves"] > 0
