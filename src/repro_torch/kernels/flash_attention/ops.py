"""Public wrappers for the flash-attention kernel (port of
``repro/kernels/flash_attention/ops.py``).

* ``flash_attention_bhsd`` — ``(B, H, S, D)`` layout, the kernel's own.
* ``flash_attention`` — the model's ``(B, S, H, D)`` layout.  The kernel
  reads ``transpose(1, 2)`` views and writes the ``(B, S, H, D)`` output
  through one, so no layout copy is made.

Neither pads anything: the reference pads D to 128 lanes and S to its block
size for the TPU, the CUDA kernel masks ragged edges itself.  Unlike the
reference's ``flash_attention``, which takes ``mask=`` "for API parity" and
ignores it, ``causal`` and ``window`` are the only masks and both are
honoured.  A CUDA tensor launches the kernel, a CPU tensor takes the plain
version (``kernel.flash_attention_kernel``).  Neither has a backward:
both raise when an input requires grad with grad mode on
(``kernels.refuse_grad``); training differentiates ``impl="plain"``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention_bhsd(
    q: torch.Tensor,            # (B, H, Sq, D)
    k: torch.Tensor,            # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    return flash_attention_kernel(q, k, v, causal=causal, window=window)


def flash_attention(
    q: torch.Tensor,            # (B, S, H, D) — model layout
    k: torch.Tensor,            # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention_kernel(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           causal=causal, window=window, out=out.transpose(1, 2))
    return out


def attention_reference(q, k, v, *, causal=True, window=0):
    """(B,S,H,D)-layout plain version, for tests."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window)
    return out.transpose(1, 2)
