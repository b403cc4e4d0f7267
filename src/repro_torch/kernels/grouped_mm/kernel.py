"""Grouped float32 products over rows sorted by group, with the group bounds
on the device: the wrappers around the CUDA kernels of
``csrc/grouped_mm.cu`` (the expert products of the dropless MoE layer,
``models.moe.moe_apply_dropless``; no TPU kernel of ``repro.kernels`` has
this job, see the source's note).

* ``grouped_mm``: ``y[c, rows of g] = x[c, rows of g] @ w[c, g]`` for every
  client ``c`` and group ``g``; the forward products and the input gradient
  (``dy @ w[c, g]ᵀ``, the same kernel on a transposed view).  Rows in no
  group are 0.
* ``grouped_mm_wgrad``: ``dw[c, g] = x[c, rows of g]ᵀ @ dy[c, rows of g]``,
  the weight gradient.

A CUDA tensor launches the kernel — built from source with nvcc at first use
(``kernels/build.py``) — or raises; a CPU tensor takes the plain version
(``ref.py``).  ``GroupedMM.launches`` counts launches (CUDA only).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_mm.ref import grouped_mm_ref, grouped_mm_wgrad_ref

CTAS_PER_SM = 2            # grouped_mm's persistent grid: two CTAs on every SM
_TOO_MANY_GROUPS = 10000   # the launchers' own return code

_I64 = ctypes.c_longlong


class _GroupedParams(ctypes.Structure):
    """``struct GroupedParams`` of ``csrc/grouped_mm.cu``, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "w", "y", "ends")] + [
        (n, _I64) for n in ("sxc", "sxm", "sxk", "swc", "swg", "swk", "swn",
                            "syc", "sym", "syn")] + [
        (n, ctypes.c_int) for n in ("clients", "groups", "rows", "k", "n")]


class _WgradParams(ctypes.Structure):
    """``struct WgradParams`` of ``csrc/grouped_mm.cu``, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "dy", "dw", "ends")] + [
        (n, _I64) for n in ("sxc", "sxm", "sxk", "syc", "sym", "syn",
                            "swc", "swg", "swk", "swn")] + [
        (n, ctypes.c_int) for n in ("clients", "groups", "rows", "m", "n")]


class GroupedMM:
    """Launch counter of the grouped products (both kernels)."""

    launches = 0


_LAUNCHERS: dict = {}


def _launchers():
    if not _LAUNCHERS:
        lib = build.load("grouped_mm")
        mm, wgrad = lib.grouped_mm_launch, lib.grouped_wgrad_launch
        mm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        wgrad.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        mm.restype = wgrad.restype = ctypes.c_int
        _LAUNCHERS.update(mm=mm, wgrad=wgrad)
    return _LAUNCHERS


_CTAS: dict = {}


def _ctas(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CTAS:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _CTAS[index] = CTAS_PER_SM * sms
    return _CTAS[index]


def _raise_on(rc: int, what: str, groups: int) -> None:
    if rc == _TOO_MANY_GROUPS:
        raise ValueError(f"{what}: {groups} client-groups in one launch, over the kernel's "
                         "2,048")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _check(x: torch.Tensor, other: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or other.dtype != torch.float32:
        raise TypeError(f"grouped products take float32, got {x.dtype} and {other.dtype}")
    if x.device != other.device or x.device != ends.device:
        raise ValueError("x, the other operand and ends must share a device")
    if ends.dim() != 2 or ends.shape[0] != x.shape[0]:
        raise ValueError(f"ends must be (C, G) for C = {x.shape[0]}, got {tuple(ends.shape)}")
    return ends.to(torch.int32).contiguous()


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """x (C, N, d_in), w (C, G, d_in, d_out) (any strides), ends (C, G)
    cumulative group ends -> y (C, N, d_out), rows in no group 0."""
    ends = _check(x, w, ends)
    c, n, d_in = x.shape
    g, d_out = w.shape[1], w.shape[3]
    if w.shape[0] != c or w.shape[2] != d_in or ends.shape[1] != g:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"ends {tuple(ends.shape)}")
    if x.device.type != "cuda":
        return grouped_mm_ref(x, w, ends)
    y = torch.zeros(c, n, d_out, dtype=x.dtype, device=x.device)
    p = _GroupedParams(x.data_ptr(), w.data_ptr(), y.data_ptr(), ends.data_ptr(),
                       *x.stride(), *w.stride(), *y.stride(), c, g, n, d_in, d_out)
    rc = _launchers()["mm"](ctypes.byref(p), _ctas(x.device),
                            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "grouped_mm", c * g)
    GroupedMM.launches += 1
    return y


def grouped_mm_wgrad(x: torch.Tensor, dy: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """x (C, N, d_in), dy (C, N, d_out), ends (C, G) -> dw (C, G, d_in, d_out)."""
    ends = _check(x, dy, ends)
    c, n, d_in = x.shape
    d_out = dy.shape[2]
    g = ends.shape[1]
    if dy.shape[:2] != (c, n):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    if x.device.type != "cuda":
        return grouped_mm_wgrad_ref(x, dy, ends)
    dw = torch.empty(c, g, d_in, d_out, dtype=x.dtype, device=x.device)
    p = _WgradParams(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), ends.data_ptr(),
                     *x.stride(), *dy.stride(), *dw.stride(), c, g, n, d_in, d_out)
    rc = _launchers()["wgrad"](ctypes.byref(p),
                               torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "grouped_mm_wgrad", c * g)
    GroupedMM.launches += 1
    return dw
