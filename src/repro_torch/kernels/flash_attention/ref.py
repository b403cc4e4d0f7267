"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py`` ``attention_ref``).

The CPU takes it, the CPU tests hold it against the JAX oracle, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.  Nothing on
the main path calls it when a card is present.  Scores and softmax are f32,
masked scores are ``NEG_INF``, the output is in q's dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,            # (B, H, Sq, D)
    k: torch.Tensor,            # (B, Hkv, Skv, D)
    v: torch.Tensor,            # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    rep = h // hkv
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_idx = torch.arange(sq, device=q.device)[:, None]
    k_idx = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_idx <= q_idx)
    if window > 0:
        mask = mask & (k_idx > q_idx - window)
    s = torch.where(mask[None, None], s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
