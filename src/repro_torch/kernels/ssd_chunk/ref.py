"""Plain PyTorch version of the SSD chunk kernel (port of
``repro/kernels/ssd_chunk/ref.py`` ``ssd_ref``): the direct sequential
recurrence

    S_t = a_t · S_{t-1} + k_t ⊗ v_t,   a_t = exp(log_a_t),   y_t = q_t · S_t

from a zero state, computed in f32.  ``y`` comes back in v's dtype, the
final state in f32.  The CPU takes it, the CPU tests hold it against the
JAX oracle, and ``chip_smoke.py`` holds the CUDA kernel against it on the
card.  Nothing on the main path calls it when a card is present.
"""

from __future__ import annotations

import torch


def ssd_ref(
    q: torch.Tensor,          # (B, H, S, N)
    k: torch.Tensor,          # (B, H, S, N)
    v: torch.Tensor,          # (B, H, S, P)
    log_a: torch.Tensor,      # (B, H, S)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B,H,S,P) in v's dtype, final_state: (B,H,N,P) f32)."""
    b, h, s, n = q.shape
    p = v.shape[-1]
    a = torch.exp(log_a.float())
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=v.device)
    y = torch.empty((b, h, s, p), dtype=torch.float32, device=v.device)
    for t in range(s):
        kt = k[:, :, t].float()
        vt = v[:, :, t].float()
        state = a[:, :, t, None, None] * state + kt[..., :, None] * vt[..., None, :]
        y[:, :, t] = torch.einsum("bhn,bhnp->bhp", q[:, :, t].float(), state)
    return y.to(v.dtype), state
