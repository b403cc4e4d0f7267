"""Plain PyTorch versions of the fused masked Adam (port of
``repro/kernels/masked_adam/ref.py`` ``masked_adam_ref``), for one client
and for a cohort's local step (``masked_adam_cohort_ref``), and the
per-(client, block) training bit (``plan_block_mask``).

The CPU tests use it, and ``chip_smoke.py`` holds the CUDA kernel against it
on the card.  It is functional (returns new tensors); the kernel wrapper
updates in place.  Nothing on the main path calls it when a card is present.
"""

from __future__ import annotations

import torch


def masked_adam_ref(
    p: torch.Tensor,            # (rows, 128)
    g: torch.Tensor,
    m: torch.Tensor,            # f32
    v: torch.Tensor,            # f32
    block_mask: torch.Tensor,   # (num_blocks,) int32
    scalars: torch.Tensor,      # [lr, bc1, bc2, eps]
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    block_rows: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lr, bc1, bc2, eps = scalars[0], scalars[1], scalars[2], scalars[3]
    g32 = g.float()
    m_new = b1 * m + (1 - b1) * g32
    v_new = b2 * v + (1 - b2) * g32 * g32
    p_new = p.float() - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)

    mask_rows = torch.repeat_interleave(block_mask != 0, block_rows)[:, None]
    p_out = torch.where(mask_rows, p_new.to(p.dtype), p)
    m_out = torch.where(mask_rows, m_new, m)
    v_out = torch.where(mask_rows, v_new, v)
    return p_out, m_out, v_out


def plan_block_mask(
    gids,                       # (num_blocks,) group ids, -1 = never trained
    gmask: torch.Tensor,        # (groups,) or (clients, groups) 0 / 1
    valid: torch.Tensor | None = None,   # (clients,): 0 = a padded step
) -> torch.Tensor:
    """Per-block int32 mask on ``gmask``'s device (port of the reference's
    ``ops.plan_block_mask``): block ``b`` is trained iff ``gids[b] >= 0``
    and ``gmask[..., gids[b]] > 0``; a ``(clients, groups)`` bitmask gives
    ``(clients, num_blocks)``, and ``valid`` zeroes the rows of clients
    whose step is padding (the reference's ``where(keep, ...)``).  This is
    the bit the cohort kernel decides per (client, block)."""
    gid = torch.as_tensor(gids, device=gmask.device)
    bits = (gmask[..., gid.clamp(min=0).long()] > 0) & (gid >= 0)
    if valid is not None:
        bits = bits & (valid != 0)[:, None]
    return bits.to(torch.int32)


def masked_adam_cohort_ref(
    p: torch.Tensor,            # (clients, rows, 128)
    g: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    gid: torch.Tensor,          # (rows // block_rows,) int32
    gmask: torch.Tensor,        # (clients, groups) int32
    valid: torch.Tensor,        # (clients,) int32
    scalars: torch.Tensor,      # [lr, bc1, bc2, eps], shared by the cohort
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    block_rows: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the cohort launch: ``masked_adam_ref`` over the
    folded ``(clients·rows, 128)`` buffers with ``plan_block_mask``;
    elementwise, so each client's result equals its own single-client call
    bit for bit."""
    clients, rows, lanes = p.shape
    bm = plan_block_mask(gid, gmask, valid).reshape(-1)

    def fold(x):
        return x.reshape(clients * rows, lanes)

    out = masked_adam_ref(fold(p), fold(g), fold(m), fold(v), bm, scalars,
                          b1=b1, b2=b2, block_rows=block_rows)
    return tuple(x.reshape(clients, rows, lanes) for x in out)
