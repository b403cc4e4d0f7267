"""Fused block-masked Adam: the wrapper around the CUDA kernel of
``csrc/masked_adam.cu`` (port of the Pallas ``masked_adam_kernel`` and
``masked_adam_stacked`` in ``repro/kernels/masked_adam/kernel.py``).
``MaskedAdamCohort`` takes one local step of a bucket of clients — or of
one client, the sequential engine's — in one launch; ``masked_adam_`` and
``masked_adam_stacked_`` are one-call forms of it with a plain per-block
mask.

    w ← w − γ·S ⊙ AdamDir(∇L)

over packed ``(rows, 128)`` f32 buffers, one mask bit per
``block_rows × 128`` block.  The update is **in place** on ``p``, ``m`` and
``v`` (the reference's outputs alias its inputs; here they are the inputs),
and a block whose bit is 0 is never read or written.

A CUDA tensor launches the kernel — built from source with nvcc at first use
(``kernels/build.py``) — or raises; a CPU tensor takes the plain PyTorch
version (``ref.masked_adam_cohort_ref``), the only path the CPU tests can
run.  There is no fallback from one to the other.
``MaskedAdamCohort.launches`` counts kernel launches (CUDA only) so a run
can show that its local steps went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.masked_adam.ref import masked_adam_cohort_ref

LANES = 128
MAX_CLIENTS = 65535  # the cohort launch's grid is (blocks, clients)


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
    """One fused masked Adam step of one client, in place; returns
    ``(p, m, v)``: ``masked_adam_stacked_`` with one client."""
    if p.dim() != 2 or block_mask.dim() != 1:
        raise ValueError(f"p must be (rows, {LANES}) and block_mask (blocks,), got "
                         f"{tuple(p.shape)} and {tuple(block_mask.shape)}")
    masked_adam_stacked_(p[None], g[None], m[None], v[None], block_mask[None], scalars,
                         b1=b1, b2=b2, block_rows=block_rows)
    return p, m, v


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
    """Client-stacked step with one block mask per client: one cohort
    launch (``MaskedAdamCohort``) in which every block is its own group —
    ``gid`` the block index, ``gmask`` the masks."""
    if p.dim() != 3 or block_rows < 1 or p.shape[1] % block_rows:
        raise ValueError(f"p must be (clients, rows, {LANES}) with rows a multiple of "
                         f"block_rows {block_rows}, got {tuple(p.shape)}")
    clients, nb = p.shape[0], p.shape[1] // block_rows
    if block_masks.shape != (clients, nb):
        raise ValueError(f"block_masks {tuple(block_masks.shape)} does not match "
                         f"p {tuple(p.shape)} at block_rows {block_rows}")
    if scalars.shape != (4,):
        raise ValueError(f"scalars must be (4,), got {tuple(scalars.shape)}")
    gid = torch.arange(nb, dtype=torch.int32, device=p.device)
    MaskedAdamCohort(p, m, v, gid, block_masks, np.ones((clients, 1), np.int32),
                     scalars.reshape(1, 4), b1=b1, b2=b2,
                     block_rows=block_rows).step(0, g)
    return p, m, v


# ---------------------------------------------------------------------------
# Cohort launch: one launch per local step for every client of a bucket
# ---------------------------------------------------------------------------

class _CohortParams(ctypes.Structure):
    """``struct CohortParams`` of ``csrc/masked_adam.cu``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("p", "g", "m", "v", "gid", "gmask", "valid", "scalars")] + [
        (name, ctypes.c_float) for name in ("b1", "omb1", "b2", "omb2")] + [
        (name, ctypes.c_int) for name in
        ("block_rows", "num_blocks", "clients", "groups")] + [
        ("client_elems", ctypes.c_longlong)]


def _cohort_launcher():
    fn = build.load("masked_adam").masked_adam_cohort_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


class MaskedAdamCohort:
    """A bucket's cohort masked Adam: every client of the bucket takes its
    local step ``t`` in one launch of ``masked_adam_cohort_kernel``.

    Port of ``masked_adam_stacked`` (the client axis folded into one call)
    with the reference's per-client plan mask (``ref.plan_block_mask``) and
    its pad-and-mask ``where(keep, ...)`` decided inside the kernel: block
    ``b`` of client ``c`` is trained at step ``t`` iff ``gid[b] >= 0``,
    ``gmask[c, gid[b]] != 0`` and ``step_valid[c, t] != 0``.  ``p``, ``m``
    and ``v`` are updated in place; what is not trained is never read or
    written.

    Everything is checked once, here — shapes, float32, contiguity, the
    16-byte alignment of every client's slice, devices, group ids, and that
    ``step_valid`` pads only at the tail (so every valid step ``t`` has the
    same Adam count ``t + 1`` in every client, and the cohort shares one
    scalar row, as the reference's stacked kernel does).  ``step`` then
    only checks the gradient's layout, launches and checks the return code.
    A CPU ``p`` takes the plain version (``ref.masked_adam_cohort_ref``);
    a CUDA one launches on the stream current at construction.
    ``MaskedAdamCohort.launches`` counts kernel launches (CUDA only);
    ``MaskedAdamCohort.plain_steps`` counts the steps the plain version
    took instead (CPU only), so the CPU tests can count a path's steps."""

    launches = 0
    plain_steps = 0

    def __init__(
        self,
        p: torch.Tensor,            # (clients, rows, 128) f32, updated in place
        m: torch.Tensor,            # (clients, rows, 128) f32, updated in place
        v: torch.Tensor,            # (clients, rows, 128) f32, updated in place
        gid: torch.Tensor,          # (rows // block_rows,) int32, -1 = never
        gmask: torch.Tensor,        # (clients, groups) int32 0 / 1
        step_valid,                 # (clients, steps) host array, 1 = real step
        scalars: torch.Tensor,      # (steps, 4) f32: row t for step t + 1
        *,
        b1: float = 0.9,
        b2: float = 0.999,
        block_rows: int = 8,
    ):
        if p.dim() != 3 or p.shape[2] != LANES:
            raise ValueError(f"p must be (clients, rows, {LANES}), got {tuple(p.shape)}")
        clients, rows, _ = p.shape
        if clients > MAX_CLIENTS:
            raise ValueError(f"{clients} clients in one cohort; the launch takes at "
                             f"most {MAX_CLIENTS} (its grid's y extent)")
        if block_rows < 1 or rows % block_rows:
            raise ValueError(f"rows {rows} is not a multiple of block_rows {block_rows}")
        nb = rows // block_rows
        dev = p.device
        for name, t in (("p", p), ("m", m), ("v", v)):
            _check_stack(name, t, p.shape, dev)
        sv = np.asarray(step_valid)
        if sv.ndim != 2 or sv.shape[0] != clients or not np.isin(sv, (0, 1)).all():
            raise ValueError(f"step_valid must be a ({clients}, steps) 0 / 1 array, "
                             f"got shape {sv.shape}")
        if (np.diff(sv, axis=1) > 0).any():
            raise ValueError("step_valid pads a client's steps before a real one; "
                             "the cohort shares its Adam count per step, so "
                             "padding must be at the tail only")
        steps = sv.shape[1]
        if gid.shape != (nb,) or gid.dtype != torch.int32:
            raise ValueError(f"gid must be ({nb},) int32, got {tuple(gid.shape)} {gid.dtype}")
        if gmask.dim() != 2 or gmask.shape[0] != clients or gmask.dtype != torch.int32:
            raise ValueError(f"gmask must be ({clients}, groups) int32, got "
                             f"{tuple(gmask.shape)} {gmask.dtype}")
        if nb and int(gid.max()) >= gmask.shape[1]:
            raise ValueError(f"gid names group {int(gid.max())}, gmask has "
                             f"{gmask.shape[1]}")
        if scalars.shape != (steps, 4) or scalars.dtype != torch.float32:
            raise ValueError(f"scalars must be ({steps}, 4) float32, got "
                             f"{tuple(scalars.shape)} {scalars.dtype}")
        for name, t in (("gid", gid), ("gmask", gmask), ("scalars", scalars)):
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {dev}")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"masked Adam runs on cuda or cpu, not {dev}")
        self.p, self.m, self.v, self.gid, self.gmask = p, m, v, gid, gmask
        self.scalars = scalars
        # row t is step t's (clients,) column, contiguous for the kernel
        self.valid = torch.as_tensor(np.ascontiguousarray(sv.T), dtype=torch.int32,
                                     device=dev)
        self.b1, self.b2, self.block_rows = b1, b2, block_rows
        self.steps, self._shape = steps, p.shape
        self._fn = None
        if dev.type == "cuda":
            if dev.index is not None and dev.index != torch.cuda.current_device():
                raise ValueError(f"p is on {dev}, the current CUDA device is "
                                 f"{torch.cuda.current_device()}")
            self._fn = _cohort_launcher()
            self._stream = torch.cuda.current_stream(dev).cuda_stream
            self._args = _CohortParams(
                p.data_ptr(), 0, m.data_ptr(), v.data_ptr(), gid.data_ptr(),
                gmask.data_ptr(), 0, 0, b1, 1.0 - b1, b2, 1.0 - b2, block_rows,
                nb, clients, gmask.shape[1], rows * LANES)
            self._args_ref = ctypes.byref(self._args)
            self._valid_ptr = self.valid.data_ptr()
            self._scalars_ptr = scalars.data_ptr()

    def step(self, t: int, g: torch.Tensor) -> None:
        """Local step ``t`` (0-based) of every client, with gradients ``g``
        (``(clients, rows, 128)`` f32, contiguous, on ``p``'s device)."""
        if not 0 <= t < self.steps:
            raise IndexError(f"step {t} outside the bucket's {self.steps} steps")
        if (g.shape != self._shape or g.dtype != torch.float32
                or g.device != self.p.device or not g.is_contiguous()
                or g.data_ptr() % 16):
            raise ValueError(f"g must be a contiguous 16-byte aligned float32 "
                             f"{tuple(self._shape)} on {self.p.device}, got "
                             f"{tuple(g.shape)} {g.dtype} {g.device}")
        if self._fn is None:
            out = masked_adam_cohort_ref(
                self.p, g, self.m, self.v, self.gid, self.gmask, self.valid[t],
                self.scalars[t], b1=self.b1, b2=self.b2, block_rows=self.block_rows)
            with torch.no_grad():
                for dst, src in zip((self.p, self.m, self.v), out):
                    dst.copy_(src)
            MaskedAdamCohort.plain_steps += 1
            return
        a = self._args
        a.g = g.data_ptr()
        a.valid = self._valid_ptr + 4 * self._shape[0] * t
        a.scalars = self._scalars_ptr + 16 * t
        rc = self._fn(self._args_ref, self._stream)
        if rc != 0:
            raise RuntimeError(f"masked_adam_cohort launch failed: cudaError {rc}")
        MaskedAdamCohort.launches += 1


def _check_stack(name: str, t: torch.Tensor, shape, device) -> None:
    if t.shape != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, p on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:     # then every client's slice is: rows of 128 lanes
        raise ValueError(f"{name}: every client's slice must start on a 16-byte "
                         "boundary (the kernel moves float4s)")
