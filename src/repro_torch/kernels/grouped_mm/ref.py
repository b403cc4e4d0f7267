"""Plain PyTorch versions of the grouped products (``kernel.py``), the CPU's
path and what the card's kernels are checked against.

Rows are grouped: group ``g`` of client ``c`` is rows ``ends[c, g - 1]`` to
``ends[c, g] - 1`` (from 0 for ``g = 0``) of ``x[c]``, and rows at or past
``ends[c, -1]`` belong to no group.  Each group is masked out of one dense
product per group, so nothing is read back to the host.
"""

from __future__ import annotations

import torch


def group_masks(ends: torch.Tensor, rows: int) -> torch.Tensor:
    """(C, G, rows) bool: row ``r`` of client ``c`` is in group ``g``."""
    ends = ends.long()
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    r = torch.arange(rows, device=ends.device)
    return (r >= starts[..., None]) & (r < ends[..., None])


def grouped_mm_ref(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """x (C, N, d_in), w (C, G, d_in, d_out), ends (C, G) -> (C, N, d_out):
    each group's rows times its group's weight; rows in no group are 0."""
    m = group_masks(ends, x.shape[1]).to(x.dtype)                     # (C, G, N)
    return torch.einsum("cgn,cgno->cno", m, torch.einsum("cni,cgio->cgno", x, w))


def grouped_mm_wgrad_ref(x: torch.Tensor, dy: torch.Tensor,
                         ends: torch.Tensor) -> torch.Tensor:
    """x (C, N, d_in), dy (C, N, d_out), ends (C, G) -> (C, G, d_in, d_out):
    each group's ``x_gᵀ dy_g`` (zero for an empty group)."""
    m = group_masks(ends, x.shape[1]).to(x.dtype)
    return torch.einsum("cgn,cni,cno->cgio", m, x, dy)
