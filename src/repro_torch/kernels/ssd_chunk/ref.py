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


# Chunks whose total log-decay lies at or above -2·FACTOR_SPAN take the
# factorised decay exp(cum_i - c)·exp(c - cum_j), c = total / 2: both
# factors stay within exp(±FACTOR_SPAN), far from f32's overflow at
# exp(88.7).  Mirrored by kFactorSpan in csrc/ssd_chunk.cu.
FACTOR_SPAN = 80.0


def _split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as two bf16 terms, hi + lo (returned in f32): hi = bf16(x),
    lo = bf16(x - hi), about 16 significant bits together."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def ssd_rounded(
    q: torch.Tensor,          # (B, H, S, N)
    k: torch.Tensor,          # (B, H, S, N)
    v: torch.Tensor,          # (B, H, S, P)
    log_a: torch.Tensor,      # (B, H, S)
    chunk: int,
    *,
    split_kdec: bool = True,
    split_state: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan with the operand roundings of the kernel's bf16
    ``wgmma`` body, in plain PyTorch (f32 products of the rounded operands):
    the decayed scores W, k ⊙ exp(total − cum) and the carried state S_prev
    each enter their product as bf16 hi + lo (``split_kdec`` /
    ``split_state`` False: as one bf16 term), q, k and v as they are; the
    decay is factorised or taken per element as the body branches.
    Tests hold it against the reference to show the rounding plan keeps the
    checks' limits; nothing on the main path calls it.  Returns (y in v's
    dtype, final state f32) as ``ssd_ref`` does."""
    b, h, s, n = q.shape
    p = v.shape[-1]
    chunk = min(chunk, s)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=v.device)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=v.device).tril()
    ys = []
    for s0 in range(0, s, chunk):
        qc, kc, vc = (t[:, :, s0:s0 + chunk].float() for t in (q, k, v))
        cum = torch.cumsum(log_a[:, :, s0:s0 + chunk].float(), dim=-1)
        total = cum[..., -1:]
        half = 0.5 * total
        factored = torch.exp(cum - half)[..., :, None] * torch.exp(half - cum)[..., None, :]
        per_elem = torch.exp(cum[..., :, None] - cum[..., None, :])
        decay = torch.where((total >= -2 * FACTOR_SPAN)[..., None], factored, per_elem)
        w = torch.where(causal, (qc @ kc.transpose(-1, -2)) * decay, 0.0)
        w_hi, w_lo = _split_bf16(w)
        y = w_hi @ vc + w_lo @ vc
        s_parts = _split_bf16(state) if split_state else (state.bfloat16().float(),)
        y = y + torch.exp(cum)[..., None] * sum(qc @ x for x in s_parts)
        ys.append(y)
        kdec = kc * torch.exp(total - cum)[..., None]
        parts = _split_bf16(kdec) if split_kdec else (kdec.bfloat16().float(),)
        state = torch.exp(total)[..., None] * state + sum(x.transpose(-1, -2) @ vc
                                                           for x in parts)
    return torch.cat(ys, dim=2).to(v.dtype), state
