"""Model-layout wrappers for the SSD chunk kernel (port of
``repro/kernels/ssd_chunk/ops.py``).

* ``ssd_scan`` — the model's ``(B, S, H, ·)`` layout.  The kernel reads
  ``transpose(1, 2)`` views of q, k, v and log_a and writes ``y`` through
  one, so no layout copy is made; head-broadcast q and k stay views.
* ``ssd_reference`` — the same layout over the plain version, for tests.

The reference pads N and P to 128 lanes and swaps axes for the TPU; the
CUDA kernel takes strides and ragged sizes, so neither is ported.  A CUDA
tensor launches the kernel, a CPU tensor takes the plain version
(``kernel.ssd_chunk_kernel``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_ref


def ssd_scan(
    q: torch.Tensor,             # (B, S, H, N) — model layout
    k: torch.Tensor,             # (B, S, H, N)
    v: torch.Tensor,             # (B, S, H, P)
    log_a: torch.Tensor,         # (B, S, H) float32
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B,S,H,P) in v's dtype, final_state: (B,H,N,P) f32).
    No backward: raises when an input requires grad with grad mode on
    (``kernels.refuse_grad``)."""
    y = torch.empty_like(v, memory_format=torch.contiguous_format)
    _, state = ssd_chunk_kernel(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                log_a.transpose(1, 2), chunk=chunk,
                                out=y.transpose(1, 2))
    return y, state


def ssd_reference(q, k, v, log_a):
    """(B,S,H,·)-layout plain version."""
    y, state = ssd_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       log_a.transpose(1, 2))
    return y.transpose(1, 2), state
