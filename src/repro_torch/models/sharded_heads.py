"""Attention and the chunked scans on DTensor activations: each rank runs
the plain code, or launches the hand-written kernel, on its own heads
through ``torch.distributed.tensor.experimental.local_map``.

The reference lets GSPMD partition ``_sdpa``'s einsums, MLA's and the
SSD scan's over the "model" axis.  DTensor's propagation of those einsums
flattens (B, H) into one batch axis for ``bmm``; with batch on "data" and
heads on "model" that axis is a ``_StridedShard``, whose propagation
fails under the dry run's ``FakeTensorMode``, and the kernels (ctypes
launches on raw pointers) take no DTensor at all.  So the head-parallel
part, scores to output (or the whole scan), is one ``local_map`` region
with explicit layouts, the layouts GSPMD gives it:

* **Batch** keeps q's layout on the data-parallel axes: ``Shard(0)`` where
  q's batch is sharded there, else replicated.  K / V (and MLA's shared
  ``k_rope``) take the same.
* **Query heads** are ``Shard(2)`` over "model" when H divides it.  K / V
  heads are ``Shard(2)`` too when Hkv divides it; otherwise each rank
  takes K / V replicated over "model" (an all-gather of the (B, T, Hkv, D)
  K / V where they were sharded) and picks the kv heads its query heads
  read, by the GQA mapping ``h // (H / Hkv)`` of the *global* head ``h``
  (``kv_for_heads``; MQA, Hkv 1, included).
* **Where H does not divide** "model" (LLaVA's 56, Llama-4's 40 at 16)
  the heads are replicated over "model", as GSPMD replicates them: every
  model rank computes every head, so the region's FLOPs and its (B, H,
  Sq, Skv) scores are not divided over "model" there.  Under
  ``act_sharding.activation_sharding(mesh)`` the layout is the
  reference's ``constrain_scores`` spec (``act_sharding.scores_spec``)
  instead: heads when they divide, else the query positions over
  "model" (``Shard(1)`` of q and of the output, K / V replicated), which
  divides the scores again.
* A mesh dim of size 1 is left replicated (no redistribution, no copy).

Gradients: where a K / V input is replicated over "model" but the ranks
read different parts of it (sharded query heads or positions), each
rank's gradient of it is a partial sum, so its gradient placement over
"model" is ``Partial()``; everything else flows back in its own layout.

The kernel wrappers refuse a DTensor (``kernels.refuse_dtensor``): a
kernel runs inside such a region or not at all.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch.mesh import dp_axes
from repro_torch.models import act_sharding

MODEL = "model"


def _batch_sharded(x: DTensor, i: int) -> bool:
    p = x.placements[i]
    return isinstance(p, Shard) and p.dim == 0


def layout(q: DTensor, heads: int, kv_heads: int, *,
           positions: bool = True) -> tuple[list, list, list]:
    """(q / output placements, K / V placements, K / V gradient placements)
    of a head-parallel region over q (B, S, H, ·) and K / V (B, T, Hkv, ·)
    on q's mesh, as the module docstring says.  ``positions=False`` (a
    scan, sequential over positions) never shards the query positions."""
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    dp = dp_axes(mesh)
    spec = None
    if positions and act_sharding.enabled() and MODEL in names:
        spec = act_sharding.scores_spec((q.shape[0], heads, q.shape[1], 1), mesh)
    qp, kvp, kvg = [], [], []
    for i, name in enumerate(names):
        n = mesh.size(i)
        if n == 1:
            p = kv = g = Replicate()
        elif name in dp:
            p = kv = g = Shard(0) if _batch_sharded(q, i) else Replicate()
        elif name != MODEL:
            p = kv = g = Replicate()
        elif spec is not None and spec[2] == MODEL and spec[1] != MODEL:
            p, kv, g = Shard(1), Replicate(), Partial()
        elif heads % n == 0:
            p = Shard(2)
            kv, g = (p, p) if kv_heads % n == 0 else (Replicate(), Partial())
        else:
            p = kv = g = Replicate()
        qp.append(p)
        kvp.append(kv)
        kvg.append(g)
    return qp, kvp, kvg


def offsets(x: DTensor, placements: list) -> tuple[int, ...]:
    """Global offset of this rank's block of ``x`` laid out by
    ``placements`` (``torch.chunk``'s blocks, mesh dims major to minor, as
    DTensor cuts them).  Integer arithmetic on the mesh coordinates: DTensor's
    own helper builds index tensors, which fail under ``FakeTensorMode``."""
    mesh = x.device_mesh
    size, off = list(x.shape), [0] * x.ndim
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n, r = mesh.size(i), mesh.get_local_rank(i)
            chunk = -(-size[p.dim] // n)
            off[p.dim] += min(r * chunk, size[p.dim])
            size[p.dim] = max(0, min(chunk, size[p.dim] - r * chunk))
    return tuple(off)


def kv_for_heads(k, v, h0: int, h_loc: int, heads: int, kv_heads: int):
    """The local (B, T, ·, D) K / V that local query heads ``h0 ..
    h0 + h_loc - 1`` read, from the whole ``kv_heads`` (GQA group
    ``heads // kv_heads``): all of them for all the heads, one kv head (a
    view) when the local heads sit inside one group, else one kv head per
    query head (a copy).  (Local heads that cover whole groups do not come
    here: ``layout`` then shards the kv heads too.)"""
    group = heads // kv_heads
    if h_loc == heads:
        return k, v
    if h0 // group == (h0 + h_loc - 1) // group:
        sl = slice(h0 // group, h0 // group + 1)
        return k[:, :, sl], v[:, :, sl]
    idx = [(h0 + j) // group for j in range(h_loc)]
    return k[:, :, idx], v[:, :, idx]


def _slice_mask(mask, b_off: int, b_loc: int, s_off: int, s_loc: int):
    """The rows of a plain (S, T) or (B, S, T) mask that this rank's
    queries read."""
    if mask is None:
        return None
    if isinstance(mask, DTensor):
        raise TypeError("the attention mask must be a plain tensor (it is built from "
                        "positions); a DTensor mask has no layout here")
    if mask.dim() == 3:
        if mask.shape[0] > 1:
            mask = mask[b_off:b_off + b_loc]
        return mask[:, s_off:s_off + s_loc]
    return mask[s_off:s_off + s_loc]


def sdpa(core, q: DTensor, k: DTensor, v: DTensor, mask, *, positions: bool = True):
    """``core(q, k, v, mask)`` (the plain ``_sdpa`` math or the flash
    kernel, on local tensors with k / v already mapped to the local
    query heads) over each rank's heads; returns the (B, S, H, D)
    output as a DTensor in q's region layout.  ``positions=False`` keeps
    the query positions whole (the flash kernel's causal and window masks
    count positions from each call's first query, so a rank's block of
    positions would be masked as if it started at 0)."""
    mesh = q.device_mesh
    heads, kv_heads = q.shape[2], k.shape[2]
    qp, kvp, kvg = layout(q, heads, kv_heads, positions=positions)
    b_off, s_off, h0, _ = offsets(q, qp)
    kv_sharded = any(isinstance(p, Shard) and p.dim == 2 for p in kvp)

    def run(ql, kl, vl):
        return rank_sdpa(core, ql, kl, vl, mask, (b_off, s_off, h0), heads, kv_heads,
                         kv_sharded)

    return local_map(run, out_placements=qp, in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kvg, kvg), device_mesh=mesh,
                     redistribute_inputs=True)(on_mesh(q, mesh), on_mesh(k, mesh), on_mesh(v, mesh))


def rank_sdpa(core, ql, kl, vl, mask, off: tuple[int, int, int], heads: int,
              kv_heads: int, kv_sharded: bool):
    """One rank's part of ``sdpa``: ``core`` on its local q (B, S, H, D)
    block at global offset ``off`` (batch, position, head) and its local
    K / V, mapped to its query heads unless they are its own kv shard."""
    b_off, s_off, h0 = off
    b_loc, s_loc, h_loc = ql.shape[:3]
    if not kv_sharded:
        kl, vl = kv_for_heads(kl, vl, h0, h_loc, heads, kv_heads)
    return core(ql, kl, vl, _slice_mask(mask, b_off, b_loc, s_off, s_loc))


def mla(core, q: DTensor, k_nope: DTensor, v: DTensor, k_rope: DTensor, mask):
    """MLA's ``core(q, k_nope, v, k_rope, mask)`` over each rank's heads
    (every head has its own k_nope / v, so they shard as q does; the
    (B, T, rope) ``k_rope`` is shared by every head and is replicated over
    "model"); returns the (B, S, H, vd) output."""
    mesh = q.device_mesh
    heads = q.shape[2]
    qp, kvp, kvg = layout(q, heads, heads)
    b_off, s_off, _, _ = offsets(q, qp)
    rp = [Replicate() if isinstance(p, Shard) and p.dim != 0 else p for p in kvp]
    rg = [Partial() if isinstance(p, Shard) and p.dim != 0 else g
          for p, g in zip(qp, kvg)]

    def run(ql, kl, vl, rl):
        b_loc, s_loc = ql.shape[:2]
        return core(ql, kl, vl, rl, _slice_mask(mask, b_off, b_loc, s_off, s_loc))

    return local_map(run, out_placements=qp, in_placements=(qp, kvp, kvp, rp),
                     in_grad_placements=(qp, kvg, kvg, rg), device_mesh=mesh,
                     redistribute_inputs=True)(
        on_mesh(q, mesh), on_mesh(k_nope, mesh), on_mesh(v, mesh), on_mesh(k_rope, mesh))


def head_parallel(fn, args: tuple, dims: tuple, out_dims, heads: int):
    """``fn(*locals)`` over each rank's heads, for a region whose heads are
    independent (a scan, a recurrence, a one-token state update).
    ``dims[i]`` is (batch dim or None, head dim or None) of ``args[i]``;
    ``out_dims`` the same for each output (a tuple of them for several).
    The batch follows ``args[0]``'s layout on the data-parallel axes, the
    heads are ``Shard`` over "model" when ``heads`` divides it, else
    replicated there.  An argument without a batch dim (a weight) gets its
    gradient as a partial sum over a data axis that shards the batch, one
    without a head dim over "model" when the heads are sharded."""
    lead = args[0]
    mesh = lead.device_mesh
    names = tuple(mesh.mesh_dim_names)
    dp = dp_axes(mesh)
    batch_on = [name in dp and mesh.size(i) > 1 and _batch_sharded(lead, i)
                for i, name in enumerate(names)]
    heads_on = [name == MODEL and mesh.size(i) > 1 and heads % mesh.size(i) == 0
                for i, name in enumerate(names)]

    def pl(bd, hd, grad=False):
        out = []
        for b_on, h_on in zip(batch_on, heads_on):
            if b_on:
                out.append(Shard(bd) if bd is not None else
                           (Partial() if grad else Replicate()))
            elif h_on:
                out.append(Shard(hd) if hd is not None else
                           (Partial() if grad else Replicate()))
            else:
                out.append(Replicate())
        return out

    in_pl = tuple(pl(*d) for d in dims)
    in_g = tuple(pl(*d, grad=True) for d in dims)
    out_pl = (tuple(pl(*d) for d in out_dims) if isinstance(out_dims[0], tuple)
              else pl(*out_dims))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=in_g, device_mesh=mesh,
                     redistribute_inputs=True)(*(on_mesh(a, mesh) for a in args))


def scan(run, q: DTensor, k, v, log_a):
    """``run(q, k, v, log_a) -> (y, state)`` (the chunked scan, plain or
    the SSD kernel) over each rank's heads: q / k (B, S, H, N), v (B, S, H,
    P), log_a (B, S, H) and y ``Shard(2)`` over "model" when H divides it,
    the (B, H, N, P) state ``Shard(1)``; else all replicated over "model"."""
    return head_parallel(run, (q, k, v, log_a), ((0, 2),) * 4, ((0, 2), (0, 1)),
                         q.shape[2])


def split_heads(x, n: int, hd: int):
    """(..., n * hd) -> (..., n, hd).  A DTensor goes through ``local_map``
    in explicit layouts both ways: its last axis stays sharded where ``n``
    divides the mesh dim (whole heads a rank), else it is replicated there
    first (an all-gather, as GSPMD replicates heads that do not divide),
    and the gradient comes back to that layout before the local view
    (DTensor cannot split or merge a shard boundary inside a head)."""
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-1], n, hd)
    mesh, last = x.device_mesh, x.ndim - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim == last and n % mesh.size(i) else p
          for i, p in enumerate(x.placements)]
    return local_map(lambda t: t.reshape(*t.shape[:-1], t.shape[-1] // hd, hd),
                     out_placements=pl, in_placements=(pl,), device_mesh=mesh,
                     redistribute_inputs=True)(x)


def merge_heads(y):
    """(..., n, hd) -> (..., n * hd), the inverse of ``split_heads``: heads
    sharded stay sharded (whole heads a rank), a sharded head dim is
    replicated first."""
    if not isinstance(y, DTensor):
        return y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1])
    last = y.ndim - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim == last else p
          for p in y.placements]
    return local_map(lambda t: t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1]),
                     out_placements=pl, in_placements=(pl,), device_mesh=y.device_mesh,
                     redistribute_inputs=True)(y)


def pad(x, widths: list, dims: tuple):
    """``F.pad(x, widths)``, which pads ``dims``; a DTensor is padded on each
    rank's block, ``dims`` made whole first (DTensor's own rule for
    ``constant_pad_nd`` gives the output one placement for a two-dim mesh
    on some torch versions, which a later ``stack`` refuses)."""
    if not isinstance(x, DTensor):
        return F.pad(x, widths)
    pl = [Replicate() if p.is_partial() or (isinstance(p, Shard) and p.dim in dims) else p
          for p in x.placements]
    return local_map(lambda t: F.pad(t, widths), out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def pointwise(fn, x: DTensor) -> DTensor:
    """An elementwise ``fn`` with no DTensor rule for its backward (e.g.
    ``logsigmoid``) on each rank's block of ``x``, in ``x``'s layout (a
    partial sum is reduced first)."""
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def on_mesh(x, mesh):
    """``x`` as a DTensor on ``mesh`` (a plain tensor, e.g. a position-built
    one, is replicated)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
