"""Optional activation-sharding constraints (port of
``repro.models.act_sharding``).

The reference adds these because GSPMD fully replicated llava-34b's
(B, H, Sq, Skv) attention scores where its 56 heads do not divide a
16-way model axis.  Under ``activation_sharding(mesh)`` the score layout
shards batch over the DP axes when it divides, and heads over "model"
when they divide, else the query positions; a residual-stream tensor
(B, S, d) shards batch over the DP axes.

The port applies a layout only to a tensor that is a DTensor on the mesh
(``DTensor.redistribute``).  A plain tensor is returned unchanged, in the
context as outside it, where the reference is a no-op.  ``scores_spec`` /
``resid_spec`` are the layout decisions, as specs (``launch.sharding``).

In a DTensor step the scores exist only inside a head-parallel
``local_map`` region (``models.sharded_heads``), where they are plain local
tensors: there the context acts through ``scores_spec``, which picks the
region's layout (heads over "model" when they divide, else the query
positions), and ``constrain_scores`` on the local scores is the identity.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import axis_size, dp_axes, dp_size
from repro_torch.launch.sharding import dp_entry, placements

_CTX: list = [None]


@contextmanager
def activation_sharding(mesh):
    prev, _CTX[0] = _CTX[0], mesh
    try:
        yield
    finally:
        _CTX[0] = prev


def enabled() -> bool:
    return _CTX[0] is not None



def scores_spec(shape: tuple[int, ...], mesh) -> tuple:
    """The (B, H, Sq, Skv) scores' layout: batch over the DP axes when it
    divides; heads on "model" when they divide, else query positions."""
    dp = dp_axes(mesh)
    model = axis_size(mesh, "model")
    b, h, sq, _ = shape
    spec = [None, None, None, None]
    if dp and b % dp_size(mesh) == 0:
        spec[0] = dp_entry(mesh)
    if h % model == 0 and h >= model:
        spec[1] = "model"            # heads divide: the natural layout
    elif sq % model == 0 and sq >= model:
        spec[2] = "model"            # heads don't: shard query positions
    return tuple(spec)


def resid_spec(shape: tuple[int, ...], mesh) -> tuple | None:
    """The (B, S, d) residual stream's layout: batch over the DP axes, or
    None (no constraint) where there are none or the batch does not
    divide."""
    if not dp_axes(mesh) or shape[0] % dp_size(mesh) != 0:
        return None
    return (dp_entry(mesh), None, None)


def _constrain(x: torch.Tensor, spec) -> torch.Tensor:
    mesh = _CTX[0]
    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


def constrain_scores(x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, Sq, Skv) attention scores/probs."""
    mesh = _CTX[0]
    if mesh is None or x.dim() != 4:
        return x
    return _constrain(x, scores_spec(tuple(x.shape), mesh))


def constrain_resid(x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) residual-stream activations: batch over DP axes."""
    mesh = _CTX[0]
    if mesh is None or x.dim() != 3:
        return x
    return _constrain(x, resid_spec(tuple(x.shape), mesh))
