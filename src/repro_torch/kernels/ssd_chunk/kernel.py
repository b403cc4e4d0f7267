"""SSD chunk scan: the wrapper around the CUDA kernel ``csrc/ssd_chunk.cu``
(port of the Pallas ``ssd_chunk_kernel`` in
``repro/kernels/ssd_chunk/kernel.py``).

    S_t = a_t · S_{t-1} + k_t ⊗ v_t,   a_t = exp(log_a_t),   y_t = q_t · S_t

per (batch, head) from a zero state, over ``(B, H, S, N)`` q and k,
``(B, H, S, P)`` v and ``(B, H, S)`` f32 log-decays, computed chunk by chunk
(``chunk`` rows, clamped to S as the reference clamps it; S must be a
multiple of it) in f32.  Returns ``y`` in v's dtype and the final state
``(B, H, N, P)`` in f32.

The tensors may be strided views with any strides, zero included: the
model's head-broadcast q and k (``expand`` over heads) and its
``(B, S, H, ·)`` layout go in as views with no copy, and ``out`` may be such
a view of the caller's buffer.  The kernel takes N ≤ 192, any P (split
over CTAs in tiles of ``P_TILE`` columns, one launch per call) and chunks up
to 256 rows whose working set fits in the 227 KB of shared memory a block
may use; the wrapper raises for anything else, on either device.

A CUDA tensor launches the kernel — built from source with nvcc at first use
(``kernels/build.py``) — or raises; a CPU tensor takes the plain PyTorch
version (``ref.ssd_ref``).  There is no fallback from one to the other.

The kernel has two bodies, and ``body_for`` picks one from the shapes and
strides before the launch (``wgmma_ok`` in the CUDA source is the same
test): ``"wgmma"`` (bf16, N and P ≤ 64, chunk ≤ 128, every view one a TMA
tensor map can describe — the Zamba2 path) and ``"cuda_core"`` (f32 and
every other call).  ``ssd_chunk_kernel.launches`` counts kernel launches
(CUDA only), ``ssd_chunk_kernel.launches_by_body`` the same per body.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_dtensor, refuse_grad
from repro_torch.kernels.ssd_chunk.ref import ssd_ref

MAX_N = 192                    # N: each CTA holds all of it
P_TILE = 64                    # P columns per CTA of the CUDA-core body
MAX_P_TILES = 65_535           # the grid's y axis
MAX_CHUNK = 256
MAX_SMEM_BYTES = 232_448       # 227 KB, Hopper's per-block limit
# query rows per tile, the largest that fits; at Zamba2's N = P = 64, chunk
# 128, 32 rows take 112 KB (two CTAs per SM), 64 rows 137 KB (one); at
# xLSTM's N 192, P tile 64, chunk 128, 32 rows take 230,912 bytes (one)
TILE_Q = (32, 16, 8, 4)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("cuda_core", "wgmma")   # SsdParams.body 0, 1
WGMMA_MAX_DIM = 64             # N and P of the wgmma body: one 128-byte row of bf16
WGMMA_MAX_CHUNK = 128          # its chunk: one 128-row box
TMA_MAX_STRIDE_BYTES = 2 ** 40


class _Params(ctypes.Structure):
    """``struct SsdParams`` of ``csrc/ssd_chunk.cu``, field for field."""
    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("log_a", ctypes.c_void_p), ("y", ctypes.c_void_p), ("state", ctypes.c_void_p),
        ("q_stride", ctypes.c_longlong * 4), ("k_stride", ctypes.c_longlong * 4),
        ("v_stride", ctypes.c_longlong * 4), ("y_stride", ctypes.c_longlong * 4),
        ("la_stride", ctypes.c_longlong * 3),
        ("batch", ctypes.c_int), ("heads", ctypes.c_int), ("seq", ctypes.c_int),
        ("n", ctypes.c_int), ("p", ctypes.c_int), ("chunk", ctypes.c_int),
        ("tile_q", ctypes.c_int), ("dtype", ctypes.c_int), ("body", ctypes.c_int),
    ]


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk")
    fn = lib.ssd_chunk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def _smem_bytes(n: int, p: int, chunk: int, tile_q: int) -> int:
    """Shared memory of one CTA of the CUDA-core body at P ``p`` (its P tile
    is the first ``min(p, P_TILE)`` columns): k transposed, the tile's v
    and state, the query tile's q transposed and its score block, three
    per-row vectors (``smem_floats`` in the CUDA source)."""
    np_, pp, qp = _round4(n), _round4(min(p, P_TILE)), _round4(chunk)
    return 4 * (np_ * (qp + 4) + qp * pp + np_ * pp + np_ * (tile_q + 4)
                + qp * (tile_q + 4) + 3 * qp)


def tile_rows(n: int, p: int, chunk: int) -> int:
    """The query-row tile the kernel runs at: the largest of ``TILE_Q`` (at
    most the padded chunk) whose working set fits; raises if none does."""
    for t in TILE_Q:
        t = min(t, _round4(chunk))
        if _smem_bytes(n, p, chunk, t) <= MAX_SMEM_BYTES:
            return t
    raise ValueError(f"chunk {chunk} at N {n}, P {p} needs "
                     f"{_smem_bytes(n, p, chunk, 4)} bytes of shared memory, more "
                     f"than the {MAX_SMEM_BYTES} a block may use")


def _tma_view(t: torch.Tensor) -> bool:
    """A tensor map can describe the (B, H, rows, cols) bf16 view ``t``:
    16-byte-aligned base, unit-stride columns, the other strides 16-byte
    multiples (0 included) below 2**40 bytes (``tma_view`` in the CUDA
    source)."""
    e = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(0 <= st * e < TMA_MAX_STRIDE_BYTES and st * e % 16 == 0
                    for st in t.stride()[:3]))


def body_for(q, k, v, chunk: int, out) -> str:
    """The body that runs the (checked, clamped-chunk) call writing ``out``:
    ``"wgmma"`` for bf16 with N, P ≤ 64, chunk ≤ 128 and q, k, v and out
    views a tensor map can describe, else ``"cuda_core"``."""
    if (v.dtype == torch.bfloat16 and q.shape[-1] <= WGMMA_MAX_DIM
            and v.shape[-1] <= WGMMA_MAX_DIM and chunk <= WGMMA_MAX_CHUNK
            and all(_tma_view(t) for t in (q, k, v, out))):
        return "wgmma"
    return "cuda_core"


def _check(q, k, v, log_a, chunk: int, out) -> tuple[int, int]:
    """Raises on what the kernel does not take; returns the clamped chunk
    and the query-row tile."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d (B, H, S, ·), got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != v.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != v dtype {v.dtype}")
    if log_a.dim() != 3 or log_a.dtype != torch.float32:
        raise TypeError(f"log_a must be (B, H, S) float32, got "
                        f"{tuple(log_a.shape)} {log_a.dtype}")
    for name, t in (("q", q), ("k", k), ("log_a", log_a)):
        if t.device != v.device:
            raise ValueError(f"{name} on {t.device}, v on {v.device}")
    b, h, s, n = q.shape
    p = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (b, h, s) or log_a.shape != (b, h, s):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} log_a {tuple(log_a.shape)}")
    if min(b, h, s) < 1:
        raise ValueError(f"empty input: B {b}, H {h}, S {s}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"N {n} must lie in 1..{MAX_N}")
    if not 1 <= p <= MAX_P_TILES * P_TILE:
        raise ValueError(f"P {p} must lie in 1..{MAX_P_TILES * P_TILE}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} above the kernel's {MAX_CHUNK}")
    tile = tile_rows(n, p, chunk)
    if out is not None and (out.shape != v.shape or out.dtype != v.dtype
                            or out.device != v.device):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} {out.device} does "
                         f"not match v {tuple(v.shape)} {v.dtype} {v.device}")
    return chunk, tile


def ssd_chunk_kernel(
    q: torch.Tensor,             # (B, H, S, N)
    k: torch.Tensor,             # (B, H, S, N)
    v: torch.Tensor,             # (B, H, S, P)
    log_a: torch.Tensor,         # (B, H, S) float32
    *,
    chunk: int = 128,
    out: torch.Tensor | None = None,   # (B, H, S, P), written in place
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: ``out`` or a new (B,H,S,P) tensor in v's dtype,
    final_state: (B,H,N,P) f32).  Refuses inputs that require grad while
    grad mode is on (``kernels.refuse_grad``), on every device."""
    refuse_grad("ssd_chunk_kernel", q, k, v, log_a)
    refuse_dtensor("ssd_chunk_kernel", q, k, v, log_a, out)
    chunk, tile = _check(q, k, v, log_a, chunk, out)
    if v.device.type == "cpu":
        y, state = ssd_ref(q, k, v, log_a)
        return (y if out is None else out.copy_(y)), state
    if v.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cuda or cpu, not {v.device}")
    if out is None:
        out = torch.empty_like(v, memory_format=torch.contiguous_format)
    return _launch(q, k, v, log_a, chunk, tile, out, body_for(q, k, v, chunk, out))


def ssd_chunk_body(q, k, v, log_a, *, body: str, chunk: int = 128, out=None):
    """``ssd_chunk_kernel`` on CUDA tensors through the named body (one of
    ``BODIES``), for timing one body against the other; raises where that
    body cannot take the call.  Nothing on the main path calls it."""
    refuse_grad("ssd_chunk_body", q, k, v, log_a)
    refuse_dtensor("ssd_chunk_body", q, k, v, log_a, out)
    chunk, tile = _check(q, k, v, log_a, chunk, out)
    if v.device.type != "cuda":
        raise ValueError(f"ssd_chunk_body runs on cuda, not {v.device}")
    if out is None:
        out = torch.empty_like(v, memory_format=torch.contiguous_format)
    if body not in BODIES or (body == "wgmma" and body_for(q, k, v, chunk, out) != body):
        raise ValueError(f"the {body!r} body cannot take this call")
    return _launch(q, k, v, log_a, chunk, tile, out, body)


_ERRORS = {-1: "bad parameters", -2: "libcuda has no cuTensorMapEncodeTiled"}


def _launch(q, k, v, log_a, chunk: int, tile: int, out, body: str):
    b, h, s, n = q.shape
    p = v.shape[-1]
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=v.device)
    prm = _Params(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
                  out.data_ptr(), state.data_ptr(),
                  (ctypes.c_longlong * 4)(*q.stride()),
                  (ctypes.c_longlong * 4)(*k.stride()),
                  (ctypes.c_longlong * 4)(*v.stride()),
                  (ctypes.c_longlong * 4)(*out.stride()),
                  (ctypes.c_longlong * 3)(*log_a.stride()),
                  b, h, s, n, p, chunk, tile, _DTYPES[v.dtype], BODIES.index(body))
    fn = _lib().ssd_chunk_launch
    with torch.cuda.device(v.device):
        rc = fn(ctypes.byref(prm), torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        why = _ERRORS.get(rc) or (f"tensor map encoding failed (CUresult {-1000 - rc})"
                                  if rc <= -1000 else f"cudaError {rc}")
        raise RuntimeError(f"ssd_chunk launch ({body} body) failed: {why}")
    ssd_chunk_kernel.launches += 1
    ssd_chunk_kernel.launches_by_body[body] += 1
    return out, state


ssd_chunk_kernel.launches = 0
ssd_chunk_kernel.launches_by_body = dict.fromkeys(BODIES, 0)
