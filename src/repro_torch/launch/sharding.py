"""Per-parameter / per-input sharding rules for the data x model mesh (port
of ``repro.launch.sharding``).

Strategy, the reference's:

1. Named rules for the big matmuls: megatron-style tensor parallelism over
   the "model" axis (attention hidden, FFN hidden, expert axis), with an
   optional FSDP extension sharding d_model over "data" for the largest
   archs.
2. A greedy fallback for everything else: the largest divisible dim over
   "model" (and under FSDP the largest remaining one over "data"), so
   every leaf of every arch has a layout, including the awkward cases
   (whisper's 51,865 vocab, zamba2's 112 SSM heads) where no named rule
   divides.

Activations: batch over the data-parallel axes ("pod", "data");
``long_500k`` (batch 1) shards the cache's *sequence* axis over "data"
instead.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dim, an axis name, a tuple of names (the DP axes
``("pod", "data")``; one axis is written by its name, as ``PartitionSpec``
normalises it) or ``None``.
``placements`` turns it into ``torch.distributed.tensor`` placements on a
mesh (``Shard(i)`` on each mesh dim that a tensor dim ``i`` names,
``Replicate()`` elsewhere); ``shard_params`` places a tree with
``distribute_tensor``.  Every rule shards only dims that divide, so a
rank's shard is the tensor's shape divided by the sizes of the axes of
each dim (``local_shape``), and ``per_device_bytes`` is exact.  The
functions read a mesh's names and sizes only, so a ``launch.mesh.MeshShape``
serves where no process group exists (the dry run's reckoning, tests).
"""

from __future__ import annotations

import math
import re

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import axis_size, dp_axes, dp_size
from repro_torch.tree import PyTree, tree_map_with_path, tree_paths

Spec = tuple


# ---------------------------------------------------------------------------
# Named rules: (path regex, spec builder).  Specs are given for the *unstacked*
# suffix dims; a leading layer-stack dim (if present) is prepended as None.
# A rule returns None to decline (e.g. when dims don't divide).
# ---------------------------------------------------------------------------

def _col(model: int, fsdp: bool, data: int):
    """(d_in, d_out) column-parallel: out on model, in on data under FSDP."""

    def rule(shape):
        if shape[-1] % model:
            return None
        din = "data" if (fsdp and shape[-2] % data == 0) else None
        return (din, "model")

    return rule


def _row(model: int, fsdp: bool, data: int):
    """(d_in, d_out) row-parallel: in on model, out on data under FSDP."""

    def rule(shape):
        if shape[-2] % model:
            return None
        dout = "data" if (fsdp and shape[-1] % data == 0) else None
        return ("model", dout)

    return rule


def _expert_col(model: int, fsdp: bool, data: int):
    """(E, d, f): experts on model (expert parallelism)."""

    def rule(shape):
        if shape[-3] % model:
            return None
        return ("model", "data" if (fsdp and shape[-2] % data == 0) else None, None)

    return rule


def _expert_row(model: int, fsdp: bool, data: int):
    def rule(shape):
        if shape[-3] % model:
            return None
        return ("model", None, "data" if (fsdp and shape[-1] % data == 0) else None)

    return rule


def _vocab_embed(model: int, fsdp: bool, data: int):
    """(V, d): shard vocab on model when divisible, else d."""

    def rule(shape):
        if shape[-2] % model == 0:
            return ("model", None)
        if shape[-1] % model == 0:
            return (None, "model")
        return None

    return rule


def param_rules(model: int, data: int, fsdp: bool):
    col = _col(model, fsdp, data)
    row = _row(model, fsdp, data)
    return [
        # attention projections
        (r"(attn|self_attn|cross_attn)/(wq|wk|wv|wq_b|wkv_b)/w$", col),
        (r"(attn|self_attn|cross_attn)/wo/w$", row),
        (r"attn/(wq_a|wkv_a)/w$", col),
        # dense MLPs (incl. shared experts)
        (r"(mlp|shared)/(w_gate|w_up|w_in)/w$", col),
        (r"(mlp|shared)/(w_down|w_out)/w$", row),
        # MoE experts
        (r"experts/(w_gate|w_up)$", _expert_col(model, fsdp, data)),
        (r"experts/w_down$", _expert_row(model, fsdp, data)),
        (r"router/w$", lambda shape: (None, None)),
        # SSM family
        (r"(mamba|mlstm)/(in_proj|up_proj|wq|wk|wv)/w$", col),
        (r"(mamba|mlstm)/(out_proj|down_proj)/w$", row),
        (r"slstm/w_x/w$", col),
        (r"slstm/out_proj/w$", row),
        # embeddings / heads
        (r"embed/table$", _vocab_embed(model, fsdp, data)),
        (r"head/w$", col),
    ]


def _greedy_spec(shape: tuple[int, ...], model: int, data: int, fsdp: bool) -> Spec:
    """Fallback: largest dim divisible by ``model`` gets "model"; under FSDP
    the largest remaining dim divisible by ``data`` gets "data"."""
    spec: list = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] >= model and shape[i] % model == 0:
            spec[i] = "model"
            break
    if fsdp:
        for i in order:
            if spec[i] is None and shape[i] >= data and shape[i] % data == 0:
                spec[i] = "data"
                break
    return tuple(spec)


def param_spec(
    path: str,
    shape: tuple[int, ...],
    *,
    model: int,
    data: int,
    fsdp: bool = False,
    stacked: bool = True,
) -> Spec:
    """The spec of one parameter leaf."""
    if len(shape) == 0:
        return ()
    for pattern, rule in param_rules(model, data, fsdp):
        if re.search(pattern, path):
            base = rule(shape)
            if base is None:
                continue
            pad = len(shape) - len(base)
            if pad < 0:   # rule written for more dims than leaf has
                continue
            return (*([None] * pad), *base)
    if len(shape) == 1:
        return (None,)
    # >=3D leaves are treated as layer-stacked: never shard the leading dim.
    inner = shape[1:] if (stacked and len(shape) >= 3) else shape
    spec = _greedy_spec(inner, model, data, fsdp)
    if len(inner) != len(shape):
        spec = (None, *spec)
    return spec


# ---------------------------------------------------------------------------
# Specs -> placements, shards and bytes
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dim that tensor dim ``i`` names, ``Replicate()`` on the others.  A dim
    named by several axes (the DP axes ``("pod", "data")``) is split by
    them in mesh order, as ``PartitionSpec`` splits it major to minor."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for ax in _axes(entry):
            if ax not in names:
                raise ValueError(f"spec {spec} names {ax!r}, not an axis of {names}")
            out[names.index(ax)] = Shard(i)
    return tuple(out)


def local_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """One rank's shard of a ``shape`` tensor laid out by ``spec``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(axis_size(mesh, a) for a in _axes(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {entry}")
        out[i] //= n
    return tuple(out)


def local_shard(t: torch.Tensor, spec: Spec, mesh, coords: dict[str, int]) -> torch.Tensor:
    """The shard of the full tensor ``t`` that the rank at mesh coordinates
    ``coords`` (axis name -> index) holds under ``spec``: a view."""
    local_shape(tuple(t.shape), spec, mesh)          # raises where a dim does not divide
    for i, entry in enumerate(spec):
        idx, n = 0, 1
        for a in _axes(entry):                       # major to minor
            idx = idx * axis_size(mesh, a) + coords.get(a, 0)
            n *= axis_size(mesh, a)
        if n > 1:
            t = t.chunk(n, dim=i)[idx]
    return t


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's index along each named dim of a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def _nbytes(shape: tuple[int, ...], dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def per_device_bytes(tree: PyTree, specs: dict[str, Spec], mesh) -> int:
    """Bytes of one rank's shards of every leaf of ``tree`` (tensors or
    meta / fake tensors) under ``specs`` (path -> spec)."""
    return sum(_nbytes(local_shape(tuple(x.shape), specs["/".join(p)], mesh), x.dtype)
               for p, x in tree_paths(tree))


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

def params_specs(params: PyTree, mesh, *, fsdp: bool = False) -> dict[str, Spec]:
    """Path -> spec of every leaf of a params(-like) tree."""
    model = axis_size(mesh, "model")
    data = axis_size(mesh, "data")
    return {"/".join(p): param_spec("/".join(p), tuple(x.shape), model=model, data=data,
                                    fsdp=fsdp)
            for p, x in tree_paths(params)}


def params_shardings(params: PyTree, mesh, *, fsdp: bool = False) -> dict[str, tuple]:
    """Path (the ``/``-joined ``tree_paths`` keys) -> DTensor placements of
    every leaf on ``mesh``."""
    return {p: placements(s, mesh) for p, s in params_specs(params, mesh, fsdp=fsdp).items()}


def shard_params(params: PyTree, mesh, *, fsdp: bool = False) -> PyTree:
    """``params`` as DTensors on ``mesh`` (a ``DeviceMesh``), each leaf
    placed by its rule: every rank passes the same full tree and keeps its
    shards (cut locally, no collective)."""
    pl = params_shardings(params, mesh, fsdp=fsdp)
    return tree_map_with_path(
        lambda p, x: distribute_tensor(x, mesh, pl[p], src_data_rank=None), params)


# ---------------------------------------------------------------------------
# Activation / input shardings
# ---------------------------------------------------------------------------


def dp_entry(mesh):
    """The DP axes as one spec entry, normalised as ``PartitionSpec`` does:
    a single axis by its name, none by ``None``."""
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_spec(shape: tuple[int, ...], mesh) -> Spec:
    """Token/label/embedding inputs: batch over the DP axes when divisible."""
    dp = dp_entry(mesh)
    if shape and shape[0] % dp_size(mesh) == 0 and shape[0] > 0:
        return (dp, *([None] * (len(shape) - 1)))
    return tuple([None] * len(shape))


def cache_spec(shape: tuple[int, ...], mesh) -> Spec:
    """KV/SSM cache leaves.  Layout conventions (dims from the left):
    (L, B, S, ...) attention caches; (L, B, ...) state caches.

    batch -> DP axes when divisible; else the sequence axis (long_500k,
    batch=1) -> "data"; heads/feature dims -> "model" greedily."""
    dp = dp_entry(mesh)
    model = axis_size(mesh, "model")
    data = axis_size(mesh, "data")
    spec: list = [None] * len(shape)
    if len(shape) < 2:
        return tuple(spec)
    # dim 0 is the layer stack for stacked caches; batch is dim 1 when the
    # cache is stacked, dim 0 otherwise.
    b_dim = 1 if len(shape) >= 3 else 0
    if shape[b_dim] % dp_size(mesh) == 0:
        spec[b_dim] = dp
    elif len(shape) > b_dim + 1 and shape[b_dim + 1] % data == 0 and shape[b_dim + 1] >= data:
        spec[b_dim + 1] = "data"   # sequence-parallel cache
    # "model" on the largest remaining divisible dim (prefer trailing dims).
    for i in range(len(shape) - 1, b_dim, -1):
        if spec[i] is None and shape[i] >= model and shape[i] % model == 0:
            spec[i] = "model"
            break
    return tuple(spec)


def input_specs_of(specs: dict, mesh) -> dict[str, Spec]:
    """Path -> spec of an ``api.input_specs`` dict: cache rules for anything
    under a "cache" key, batch rules for the rest."""
    out = {}
    for p, x in tree_paths(specs):
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) else ()
        out["/".join(p)] = cache_spec(shape, mesh) if "cache" in p else batch_spec(shape, mesh)
    return out


def input_shardings(specs: dict, mesh) -> dict[str, tuple]:
    """Path -> DTensor placements of every input of ``specs`` on ``mesh``."""
    return {p: placements(s, mesh) for p, s in input_specs_of(specs, mesh).items()}
