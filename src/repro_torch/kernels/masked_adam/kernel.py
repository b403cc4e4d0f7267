"""Fused block-masked Adam: the wrapper around the CUDA kernel
``csrc/masked_adam.cu`` (port of the Pallas ``masked_adam_kernel`` /
``masked_adam_stacked`` in ``repro/kernels/masked_adam/kernel.py``).

    w ← w − γ·S ⊙ AdamDir(∇L)

over packed ``(rows, 128)`` f32 buffers, one mask bit per
``block_rows × 128`` block.  The update is **in place** on ``p``, ``m`` and
``v`` (the reference's outputs alias its inputs; here they are the inputs),
and a block whose bit is 0 is never read or written.

A CUDA tensor launches the kernel — built from source with nvcc at first use
(``kernels/build.py``) — or raises; a CPU tensor takes the plain PyTorch
version (``ref.masked_adam_ref``), the only path the CPU tests can run.
There is no fallback from one to the other.  ``masked_adam_.launches``
counts kernel launches (CUDA only) so a run can show that its local steps
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.masked_adam.ref import masked_adam_ref

LANES = 128


def _lib() -> ctypes.CDLL:
    lib = build.load("masked_adam")
    fn = lib.masked_adam_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(p, g, m, v, block_mask, scalars, block_rows: int) -> int:
    """Validate what the kernel takes; returns the number of blocks."""
    if p.dim() != 2 or p.shape[1] != LANES:
        raise ValueError(f"p must be (rows, {LANES}), got {tuple(p.shape)}")
    if block_rows < 1 or p.shape[0] % block_rows:
        raise ValueError(f"rows {p.shape[0]} is not a multiple of "
                         f"block_rows {block_rows}")
    nb = p.shape[0] // block_rows
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != p shape {tuple(p.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != p.device:
            raise ValueError(f"{name} on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel moves float4s)")
    if block_mask.shape != (nb,) or block_mask.dtype != torch.int32:
        raise ValueError(f"block_mask must be ({nb},) int32, got "
                         f"{tuple(block_mask.shape)} {block_mask.dtype}")
    if scalars.shape != (4,) or scalars.dtype != torch.float32:
        raise ValueError(f"scalars must be (4,) float32, got "
                         f"{tuple(scalars.shape)} {scalars.dtype}")
    for name, t in (("block_mask", block_mask), ("scalars", scalars)):
        if t.device != p.device:
            raise ValueError(f"{name} on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return nb


def masked_adam_(
    p: torch.Tensor,          # (rows, 128) f32, updated in place
    g: torch.Tensor,          # (rows, 128) f32
    m: torch.Tensor,          # (rows, 128) f32, updated in place
    v: torch.Tensor,          # (rows, 128) f32, updated in place
    block_mask: torch.Tensor, # (rows // block_rows,) int32
    scalars: torch.Tensor,    # (4,) f32: [lr, 1-b1**t, 1-b2**t, eps]
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    block_rows: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused masked Adam step, in place; returns ``(p, m, v)``."""
    nb = _check(p, g, m, v, block_mask, scalars, block_rows)
    if p.device.type == "cpu":
        p_new, m_new, v_new = masked_adam_ref(p, g, m, v, block_mask, scalars,
                                              b1=b1, b2=b2, block_rows=block_rows)
        with torch.no_grad():
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
        return p, m, v
    if p.device.type != "cuda":
        raise ValueError(f"masked_adam_ runs on cuda or cpu, not {p.device}")
    fn = _lib().masked_adam_launch
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                block_mask.data_ptr(), scalars.data_ptr(),
                b1, 1.0 - b1, b2, 1.0 - b2, block_rows, nb, stream)
    if rc != 0:
        raise RuntimeError(f"masked_adam launch failed: cudaError {rc}")
    masked_adam_.launches += 1
    return p, m, v


masked_adam_.launches = 0


def masked_adam_stacked_(
    p: torch.Tensor,           # (clients, rows, 128)
    g: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    block_masks: torch.Tensor, # (clients, rows // block_rows) int32
    scalars: torch.Tensor,     # (4,) f32, shared across clients
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    block_rows: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Client-stacked variant: each client's ``rows`` is a block multiple, so
    client boundaries are block boundaries and the folded
    ``(clients·rows, 128)`` view is one ``masked_adam_`` launch."""
    clients, rows, lanes = p.shape
    if block_masks.shape != (clients, rows // block_rows):
        raise ValueError(f"block_masks {tuple(block_masks.shape)} does not match "
                         f"p {tuple(p.shape)} at block_rows {block_rows}")

    def fold(x):
        if x.shape != p.shape:
            raise ValueError(f"stacked shape {tuple(x.shape)} != {tuple(p.shape)}")
        return x.view(clients * rows, lanes)

    masked_adam_(fold(p), fold(g), fold(m), fold(v), block_masks.reshape(-1),
                 scalars, b1=b1, b2=b2, block_rows=block_rows)
    return p, m, v
