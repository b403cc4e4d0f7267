"""Forward flash attention: the wrapper around the CUDA kernel
``csrc/flash_attention.cu`` (port of the Pallas ``flash_attention_kernel``
in ``repro/kernels/flash_attention/kernel.py``).

    o = softmax(q kᵀ / √D  masked) v

over ``(B, H, Sq, D)`` queries and ``(B, Hkv, Skv, D)`` keys and values,
kv head ``h // (H/Hkv)``, causal aligned top-left (``k ≤ q``), an optional
sliding window (``k > q − window``), f32 scores and accumulators, output in
q's dtype.  bf16 inputs run on Hopper's tensor cores (``wgmma``, with K and
V tiles brought in by TMA for two consumer warpgroups; P is rounded to bf16
for the P·V product), f32 inputs on the CUDA cores in full f32.
Unlike the reference kernel it needs no padding: any sequence lengths (the
kernel masks ragged edges itself) and any head dim ``D ≤ 256`` that is a
multiple of 8, the head dims the configs have (32, 64, 96, 112, 128, 256).
The kernel rounds D up to 64, 128 or 256 with zero lanes (D 136–256 run at
256, where the bf16 body takes 64-key K / V tiles).

The tensors may be strided views, so the model's ``(B, S, H, D)``
activations go in as ``transpose(1, 2)`` views with no copy, and ``out`` may
be such a view of the caller's buffer.  The head dim must be unit-stride,
and every row of q, k and v must start on a 16-byte boundary; q, k and v
must also fit what a TMA tensor map takes (every dim below 2**31, every
byte stride below 2**40).  The wrapper checks all of it, on either device,
so a view the kernel cannot take raises ``ValueError`` before any launch.

A CUDA tensor launches the kernel — built from source with nvcc at first use
(``kernels/build.py``) — or raises; a CPU tensor takes the plain PyTorch
version (``ref.attention_ref``).  There is no fallback from one to the other.
``flash_attention_kernel.launches`` counts kernel launches (CUDA only),
``flash_attention_kernel.launches_by_head_dim`` the same per head dim D.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_dtensor, refuse_grad
from repro_torch.kernels.flash_attention.ref import attention_ref

MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 8
ROW_ALIGN_BYTES = 16
MAX_DIM = 2**31             # the C struct's int fields (TMA itself takes up to 2**32)
MAX_STRIDE_BYTES = 2**40    # a TMA tensor map's limit on each byte stride
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Params(ctypes.Structure):
    """``struct FlashParams`` of ``csrc/flash_attention.cu``, field for field."""
    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("o", ctypes.c_void_p),
        ("q_stride", ctypes.c_longlong * 3), ("k_stride", ctypes.c_longlong * 3),
        ("v_stride", ctypes.c_longlong * 3), ("o_stride", ctypes.c_longlong * 3),
        ("batch", ctypes.c_int), ("heads", ctypes.c_int), ("kv_heads", ctypes.c_int),
        ("sq", ctypes.c_int), ("skv", ctypes.c_int), ("head_dim", ctypes.c_int),
        ("kv_len", ctypes.c_int), ("causal", ctypes.c_int), ("window", ctypes.c_int),
        ("dtype", ctypes.c_int), ("scale", ctypes.c_float),
    ]


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch_error(rc: int) -> str:
    """What ``flash_attention_launch``'s return code means."""
    if rc == -1:
        return "bad parameters"
    if rc == -2:
        return "libcuda has no cuTensorMapEncodeTiled"
    if rc <= -1000:
        return f"cuTensorMapEncodeTiled failed with CUresult {-1000 - rc}"
    return f"cudaError {rc}"


def _check(q, k, v, out, window: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d (B, heads, S, D), got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    b, h, sq, d = q.shape
    bk, hkv, skv, dk = k.shape
    if v.shape != k.shape:
        raise ValueError(f"v shape {tuple(v.shape)} != k shape {tuple(k.shape)}")
    if bk != b or dk != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if not 1 <= d <= MAX_HEAD_DIM or d % HEAD_DIM_MULTIPLE:
        raise ValueError(f"head dim {d} not supported (a multiple of "
                         f"{HEAD_DIM_MULTIPLE} up to {MAX_HEAD_DIM})")
    if sq < 1 or skv < 1:
        raise ValueError(f"empty sequence: Sq {sq}, Skv {skv}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if out is not None:
        if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
            raise ValueError(f"out {tuple(out.shape)} {out.dtype} {out.device} does "
                             f"not match q {tuple(q.shape)} {q.dtype} {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t is None:
            continue
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be unit-stride, strides "
                             f"{t.stride()}")
        if name != "out" and (t.data_ptr() % ROW_ALIGN_BYTES or any(
                st * t.element_size() % ROW_ALIGN_BYTES for st in t.stride()[:3])):
            raise ValueError(f"{name}'s rows must start on {ROW_ALIGN_BYTES}-byte "
                             f"boundaries (strides {t.stride()})")
        if name != "out" and (max(t.shape) >= MAX_DIM or any(
                st * t.element_size() >= MAX_STRIDE_BYTES for st in t.stride())):
            raise ValueError(f"{name} {tuple(t.shape)} strides {t.stride()}: a TMA "
                             f"tensor map takes dims below {MAX_DIM} and byte strides "
                             f"below {MAX_STRIDE_BYTES}")


def flash_attention_kernel(
    q: torch.Tensor,             # (B, H, Sq, D)
    k: torch.Tensor,             # (B, Hkv, Skv, D)
    v: torch.Tensor,             # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: int = 0,
    out: torch.Tensor | None = None,   # (B, H, Sq, D), written in place
) -> torch.Tensor:
    """Attention of ``q`` over ``k`` / ``v``; returns ``out`` (allocated
    contiguous when not given).  Refuses inputs that require grad while
    grad mode is on (``kernels.refuse_grad``), on every device."""
    refuse_grad("flash_attention_kernel", q, k, v)
    refuse_dtensor("flash_attention_kernel", q, k, v, out)
    _check(q, k, v, out, window)
    if q.device.type == "cpu":
        o = attention_ref(q, k, v, causal=causal, window=window)
        return o if out is None else out.copy_(o)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    p = _Params(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                (ctypes.c_longlong * 3)(*q.stride()[:3]),
                (ctypes.c_longlong * 3)(*k.stride()[:3]),
                (ctypes.c_longlong * 3)(*v.stride()[:3]),
                (ctypes.c_longlong * 3)(*out.stride()[:3]),
                b, h, hkv, sq, skv, d, skv, int(causal), int(window),
                _DTYPES[q.dtype], 1.0 / d ** 0.5)
    fn = _lib().flash_attention_launch
    with torch.cuda.device(q.device):
        rc = fn(ctypes.byref(p), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: {_launch_error(rc)}")
    flash_attention_kernel.launches += 1
    by_d = flash_attention_kernel.launches_by_head_dim
    by_d[d] = by_d.get(d, 0) + 1
    return out


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by_head_dim = {}
