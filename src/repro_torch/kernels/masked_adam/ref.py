"""Plain PyTorch version of the fused masked Adam (port of
``repro/kernels/masked_adam/ref.py`` ``masked_adam_ref``).

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
