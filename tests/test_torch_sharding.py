"""The port's ``launch/sharding.py`` and the sharded-model meshes of
``launch/mesh.py`` against the JAX package's ``launch/sharding.py``.

* ``param_spec`` equals the reference's (its ``PartitionSpec`` as a tuple)
  for every leaf of every assigned architecture at full size, on meshes
  16 x 16, 32 x 8, 2 x 16 x 16 and 4 x 2, FSDP on and off.  The leaves'
  paths and shapes come from the reference's ``jax.eval_shape`` of
  ``api.init`` and from the port's init on the ``meta`` device, and are
  checked equal first.
* The per-device parameter bytes from the port's placements equal those
  reckoned from the reference's specs (each dim over the product of its
  axes' sizes), on the same meshes.
* The reference's own edge cases (``tests/test_sharding_rules.py``).
* ``batch_spec`` / ``cache_spec``, via ``input_specs_of``, against the
  reference's over ``input_specs`` of every architecture x the four input
  shapes (``long_500k``'s sequence-parallel cache at batch 1), on a
  stand-in mesh that carries only names and sizes (the reference reads
  ``axis_names`` and ``shape``, the port a ``launch.mesh.MeshShape``).
* ``placements``: ``Shard(i)`` on each mesh dim a tensor dim names; the
  DP axes of a batch dim in mesh order.
* ``local_shard`` cuts the rank's block, and ``mesh_override_shape`` /
  ``dp_axes`` / ``axis_size`` read 2-D and 3-D meshes.

Exact: specs, shapes and byte counts.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import get_config as j_get_config
from repro.core.partition import tree_paths as j_tree_paths
from repro.launch import sharding as jsh
from repro.models import api as japi
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MeshShape, axis_size, dp_axes, mesh_override_shape
from repro_torch.models import api
from repro_torch.tree import tree_paths

torch.set_num_threads(1)

MESHES = {"16x16": "16,16", "32x8": "32,8", "2x16x16": "2,16,16", "4x2": "4,2"}


class _JMesh:
    """The reference's mesh as its rules read it: names and sizes."""

    def __init__(self, m: MeshShape):
        self.axis_names = m.mesh_dim_names
        self.shape = dict(zip(m.mesh_dim_names, m.shape))


@functools.lru_cache(maxsize=None)
def _leaves(arch):
    """[(path, shape, itemsize)] of the reference's and the port's params."""
    ref = jax.eval_shape(lambda: japi.init(jax.random.key(0), j_get_config(arch)))
    ours = api.init(torch.Generator(), get_config(arch), "meta")
    return ([("/".join(p), tuple(x.shape), np.dtype(x.dtype).itemsize)
             for p, x in j_tree_paths(ref)],
            [("/".join(p), tuple(x.shape), x.element_size()) for p, x in tree_paths(ours)])


def test_assigned_archs_are_the_reference_s():
    assert ASSIGNED_ARCHS == J_ASSIGNED


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", J_ASSIGNED)
def test_param_spec_matches_reference(arch, mesh, fsdp):
    ref, ours = _leaves(arch)
    assert ours == ref
    m = mesh_override_shape(MESHES[mesh])
    model, data = axis_size(m, "model"), axis_size(m, "data")
    params = api.init(torch.Generator(), get_config(arch), "meta")
    specs = sharding.params_specs(params, m, fsdp=fsdp)
    for path, shape, _ in ref:
        want = tuple(jsh.param_spec(path, shape, model=model, data=data, fsdp=fsdp))
        assert sharding.param_spec(path, shape, model=model, data=data, fsdp=fsdp) == want
        assert specs[path] == want, path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", J_ASSIGNED)
def test_per_device_param_bytes_match_reference(arch, mesh):
    ref, _ = _leaves(arch)
    m = mesh_override_shape(MESHES[mesh])
    sizes = dict(zip(m.mesh_dim_names, m.shape))
    model, data = sizes.get("model", 1), sizes.get("data", 1)
    params = api.init(torch.Generator(), get_config(arch), "meta")
    for fsdp in (False, True):
        want = 0
        for path, shape, itemsize in ref:
            spec = jsh.param_spec(path, shape, model=model, data=data, fsdp=fsdp)
            n = math.prod(shape)
            for entry in spec:
                for ax in (entry if isinstance(entry, tuple) else (entry,)):
                    n //= sizes[ax] if ax else 1
            want += n * itemsize
        got = sharding.per_device_bytes(params, sharding.params_specs(params, m, fsdp=fsdp), m)
        assert got == want


EDGE_CASES = [
    ("blocks/attn/wq/w", (22, 2048, 2048), False, (None, None, "model")),
    ("blocks/attn/wo/w", (22, 2048, 2048), False, (None, "model", None)),
    ("blocks/attn/wq/w", (60, 7168, 7168), True, (None, "data", "model")),
    ("blocks/mlp/w_down/w", (60, 20480, 7168), True, (None, "model", "data")),
    ("moe_blocks/moe/experts/w_gate", (58, 256, 7168, 2048), False,
     (None, "model", None, None)),
    ("moe_blocks/moe/experts/w_down", (58, 256, 2048, 7168), False,
     (None, "model", None, None)),
    ("embed/table", (128256, 2048), False, ("model", None)),
    ("embed/table", (51865, 768), False, (None, "model")),      # whisper's odd vocab
    ("weird/custom/w", (81, 112, 64), False, (None, "model", None)),
    ("weird/custom/w", (81, 113, 64), False, (None, None, "model")),
    ("blocks/mamba/a_log", (81, 112), False, (None, "model")),
    ("blocks/mamba/dt_bias", (81, 7), False, (None, None)),
    ("final_norm/scale", (4096,), False, (None,)),
    ("step", (), False, ()),
]


@pytest.mark.parametrize("path,shape,fsdp,want", EDGE_CASES)
def test_reference_edge_cases(path, shape, fsdp, want):
    got = sharding.param_spec(path, shape, model=16, data=16, fsdp=fsdp)
    assert got == want
    assert got == tuple(jsh.param_spec(path, shape, model=16, data=16, fsdp=fsdp))


def test_greedy_never_shards_indivisible():
    assert sharding._greedy_spec((7, 9, 11), 16, 16, False) == (None, None, None)
    assert sharding._greedy_spec((7, 9, 11), 16, 16, True) == \
        tuple(jsh._greedy_spec((7, 9, 11), 16, 16, True))


@pytest.mark.parametrize("shape", sorted(api.INPUT_SHAPES))
@pytest.mark.parametrize("arch", J_ASSIGNED)
def test_input_specs_match_reference(arch, shape):
    specs = api.input_specs(get_config(arch), api.INPUT_SHAPES[shape])
    for mesh in MESHES.values():
        m = mesh_override_shape(mesh)
        jm = _JMesh(m)
        got = sharding.input_specs_of(specs, m)
        assert sorted(got) == sorted("/".join(p) for p, _ in tree_paths(specs))
        for p, x in tree_paths(specs):
            path, dims = "/".join(p), tuple(x.shape)
            want = jsh.cache_spec(dims, jm) if "cache" in p else jsh.batch_spec(dims, jm)
            assert got[path] == tuple(want), (path, dims)
        sharding.per_device_bytes(specs, got, m)        # every layout divides


def test_long_context_cache_is_sequence_parallel():
    m = MeshShape((16, 16))
    specs = api.input_specs(get_config("llama3.2-1b"), api.INPUT_SHAPES["long_500k"])
    got = sharding.input_specs_of(specs, m)
    k = got["cache/blocks/k"]
    assert k[1] is None and k[2] == "data"               # batch 1: the sequence on data


def test_placements_and_local_shards():
    m = MeshShape((2, 2, 4), ("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.placements(("clients",), m)
    t = torch.arange(8 * 3 * 8).reshape(8, 3, 8)
    spec = (("pod", "data"), None, "model")
    assert sharding.local_shape(tuple(t.shape), spec, m) == (2, 3, 2)
    blk = sharding.local_shard(t, spec, m, {"pod": 1, "data": 0, "model": 3})
    assert torch.equal(blk, t[4:6, :, 6:8])
    with pytest.raises(ValueError):
        sharding.local_shape((7, 3), ("model", None), m)


def test_mesh_names_and_sizes():
    two = mesh_override_shape("32,8")
    three = mesh_override_shape("2,16,16")
    assert two.mesh_dim_names == ("data", "model") and two.size() == 256
    assert three.mesh_dim_names == ("pod", "data", "model") and three.size() == 512
    assert dp_axes(two) == ("data",) and dp_axes(three) == ("pod", "data")
    assert axis_size(three, "pod") == 2 and axis_size(two, "pod") == 1
    assert mesh_override_shape("8").mesh_dim_names == ("model",)
    with pytest.raises(ValueError):
        mesh_override_shape("1,2,3,4")
