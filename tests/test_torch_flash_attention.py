"""The port's flash attention against the JAX package's.

* the plain PyTorch version (what the wrapper runs for a CPU tensor) against
  the jnp oracle ``attention_ref`` over the reference's seven kernel cases,
  four ragged ones (lengths off the 64-row tiles, Sq != Skv both ways,
  GQA 3:1 with a window) and two at head dims above 128 (D 256 MQA, D 192),
  f32 and bf16, and against the Pallas ``flash_attention`` in interpret mode
  on the causal, window-0 cases (the only ones that path honours);
* both layouts (``flash_attention`` on ``(B,S,H,D)``, ``flash_attention_bhsd``)
  and a caller's strided ``out``;
* the wrapper's checks and its C interface (``struct FlashParams`` in the
  CUDA source, field for field);
* the CUDA kernel against the plain version, on a card only (``gpu``).

Tolerance: 2e-5 abs + rel in f32, the reference's own kernel-vs-oracle
bound; 2e-2 in bf16, its ``test_dtypes`` bound (scores and sums are f32 on
both sides; the output rounds to bf16).  On the card each bf16 output row
is also held to 1e-2 of its norm (``chip_smoke.py`` ``FLASH_ROW_TOL``).
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro_torch import bridge
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (attention_ref, flash_attention_kernel,
                                                 kernel as fa_kernel, ops, phase_timing)

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

CASES = [
    # (b, h, hkv, sq, skv, d, causal, window) — tests/test_kernels_flash.py
    (1, 2, 2, 128, 128, 64, True, 0),
    (2, 4, 2, 256, 256, 64, True, 0),      # GQA 2:1
    (1, 4, 1, 128, 256, 128, True, 0),     # MQA
    (1, 2, 2, 128, 384, 64, False, 0),     # cross-attention shape
    (2, 2, 2, 256, 256, 32, True, 64),     # sliding window
    (1, 2, 2, 128, 128, 96, True, 0),      # non-128 head dim
    (1, 2, 2, 192, 192, 64, True, 0),      # non-block seq
]
# ragged shapes the reference's cases miss (chip_smoke.py FLASH_EXTRA)
EXTRA = [
    (1, 4, 2, 100, 77, 32, False, 0),
    (2, 3, 1, 130, 130, 96, True, 50),
    (1, 2, 2, 70, 200, 128, True, 0),
    (1, 2, 1, 200, 70, 64, True, 0),
]
# head dims above 128, which the kernel runs at DP 256 (Gemma-2b's D 256, MQA)
WIDE = [
    (1, 8, 1, 128, 256, 256, True, 0),
    (1, 2, 2, 128, 128, 192, True, 0),
]
# ragged shapes at each of the bf16 body's three widths, DP 64, DP 128 with
# D 112, DP 256 with its 64-key tiles (chip_smoke.py FLASH_HOPPER); run on a
# card only
HOPPER = [
    (2, 2, 2, 129, 257, 32, False, 0),
    (1, 2, 1, 200, 333, 112, True, 0),
    (1, 3, 1, 130, 255, 128, True, 40),
    (1, 2, 1, 129, 257, 256, False, 0),
    (2, 8, 1, 130, 255, 256, True, 0),
    (1, 3, 1, 200, 333, 192, True, 40),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ROW_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _inputs(case, dtype, seed=0):
    """q (B,S,H,D), k / v (B,S,Hkv,D) as numpy arrays of ``dtype`` (bf16 as
    ``ml_dtypes.bfloat16``, rounded by JAX)."""
    b, h, hkv, sq, skv, d, _, _ = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    return [np.asarray(jnp.asarray(a, dtype)) for a in arrs]


def _torch(arrs):
    return [bridge.from_numpy_tree({"x": a})["x"] for a in arrs]


def _close(out: torch.Tensor, ref: np.ndarray, dtype: str) -> None:
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + EXTRA + WIDE)
def test_plain_matches_jax_oracle(case, dtype):
    causal, window = case[6], case[7]
    q, k, v = _inputs(case, jnp.dtype(dtype), seed=hash(case) % 2**31)
    ref = jops.attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal,
                                   window=window)
    out = ops.flash_attention(*_torch((q, k, v)), causal=causal, window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    assert out.is_contiguous()
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [c for c in CASES + WIDE if c[6] and c[7] == 0])
def test_plain_matches_jax_pallas_interpret(case, dtype):
    """Causal, window 0: the cases where the Pallas path computes what it is
    asked (its wrapper drops ``mask``; ``causal=True, window=0`` are its
    defaults)."""
    q, k, v = _inputs(case, jnp.dtype(dtype), seed=1)
    ref = jops.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    out = ops.flash_attention(*_torch((q, k, v)), causal=True, window=0)
    _close(out, ref, dtype)


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[4]])
def test_bhsd_layout_and_strided_out(case):
    causal, window = case[6], case[7]
    q, k, v = (t.transpose(1, 2) for t in _torch(_inputs(case, jnp.float32, seed=2)))
    ref = attention_ref(q, k, v, causal=causal, window=window)
    out = ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    buf = torch.full((q.shape[0], q.shape[2], q.shape[1], q.shape[3]), float("nan"))
    got = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 out=buf.transpose(1, 2))
    assert got.data_ptr() == buf.data_ptr()
    torch.testing.assert_close(buf.transpose(1, 2), ref, rtol=0, atol=0)


def test_window_equals_full_when_large():
    q, k, v = _torch(_inputs(CASES[0], jnp.float32, seed=3))
    full = ops.flash_attention(q, k, v, causal=True, window=0)
    big = ops.flash_attention(q, k, v, causal=True, window=4096)
    torch.testing.assert_close(full, big, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", ["dim", "dtype", "mixed", "heads", "head_dim",
                                 "window", "empty", "out", "head_dim_not_8",
                                 "misaligned_rows", "strided_head_dim",
                                 "tma_dim", "tma_stride"])
def test_wrapper_rejects(bad):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 16)
    kw = {}
    if bad == "dim":
        q = q[0]
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "heads":
        k, v = torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16)
    elif bad == "head_dim":   # past MAX_HEAD_DIM (256), a multiple of 8
        q, k, v = (torch.zeros(*t.shape[:3], 264) for t in (q, k, v))
    elif bad == "window":
        kw["window"] = -1
    elif bad == "empty":
        k, v = torch.zeros(1, 2, 0, 16), torch.zeros(1, 2, 0, 16)
    elif bad == "out":
        kw["out"] = torch.zeros(1, 4, 8, 8)
    elif bad == "head_dim_not_8":
        q, k, v = (torch.zeros(*t.shape[:3], 20) for t in (q, k, v))
    elif bad == "misaligned_rows":   # rows 4 bytes off a 16-byte boundary
        k = torch.zeros(1 * 2 * 8 * 16 + 1)[1:].view(1, 2, 8, 16)
    elif bad == "strided_head_dim":
        v = torch.zeros(1, 2, 8, 32)[..., ::2]
    elif bad == "tma_dim":       # 2**31 keys: past the C int and a tensor map's dims
        k = torch.zeros(1, 2, 1, 16).expand(1, 2, 2**31, 16)
        v = k
    elif bad == "tma_stride":    # a batch stride of 2**40 bytes: past a tensor map's strides
        q = torch.zeros(512).as_strided((1, 4, 8, 16), (2**38, 128, 16, 1))
    with pytest.raises((ValueError, TypeError)):
        flash_attention_kernel(q, k, v, **kw)


def test_params_struct_matches_cuda_source():
    """``_Params`` is ``struct FlashParams`` field for field: same names in
    the same order, pointers / long long[3] / int / float as declared."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    body = re.search(r"struct FlashParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = re.match(r"(long long|(?:const )?\w+\*?)\s+(.*)", decl).groups()
        for name in names.split(","):
            name = name.strip()
            arr = re.match(r"(\w+)\[(\d+)\]", name)
            c_fields.append((arr.group(1) if arr else name,
                             f"{ctype}[{arr.group(2)}]" if arr else ctype))
    expect = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
              "long long[3]": ctypes.c_longlong * 3, "int": ctypes.c_int,
              "float": ctypes.c_float}
    py_fields = fa_kernel._Params._fields_
    assert [n for n, _ in c_fields] == [n for n, _ in py_fields]
    for (name, ctype), (_, pytype) in zip(c_fields, py_fields):
        assert expect[ctype] == pytype, name


def test_launcher_declares_its_c_signature(monkeypatch):
    launch = type("Launch", (), {"argtypes": None, "restype": ctypes.c_int})()
    lib = type("Lib", (), {"flash_attention_launch": launch})()
    monkeypatch.setattr(build, "load", lambda name: lib)
    fn = fa_kernel._lib().flash_attention_launch
    assert fn.argtypes == [ctypes.POINTER(fa_kernel._Params), ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


def test_phase_timing_instruments_every_step():
    """The on-card phase-timing tool finds each place it instruments in the
    kernel source exactly once (it raises otherwise)."""
    src = phase_timing.instrumented_source(4096)
    # the start mark, five step ends, the producer's two; the included
    # hopper.cuh's wait loop reads its clock inside its PTX, not by clock64()
    assert '#include "hopper.cuh"' in src
    hopper = (build.CSRC / "hopper.cuh").read_text()
    assert hopper.count("clock64()") == 0 and hopper.count("%%clock64") == 2
    assert src.count("clock64()") == 8
    assert "g_dbg[4096 * 2 * 5]" in src and "flash_dbg_read" in src


def test_phase_timing_counts_the_key_tiles_of_a_causal_grid():
    # grid x 0 runs the last query tile, which walks every key tile
    assert phase_timing._tiles(4, 512).tolist() == [4, 3, 2, 1]
    # at DP 256 the bf16 body walks 64-key tiles: two per 128-row query tile
    assert phase_timing._tiles(4, 512, keys=phase_timing.key_tile(256)).tolist() == \
        [8, 6, 4, 2]
    assert phase_timing.key_tile(128) == 128


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_wrapper_accepts_every_head_dim_up_to_256(d):
    """Every multiple of 8 up to MAX_HEAD_DIM runs (the plain version on the
    CPU) and agrees with the jnp oracle."""
    case = (1, 2, 1, 9, 11, d, True, 0)
    q, k, v = _inputs(case, jnp.float32, seed=d)
    ref = jops.attention_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    out = ops.flash_attention(*_torch((q, k, v)), causal=True)
    _close(out, ref, "float32")


def test_flash_attention_is_built_with_the_port():
    assert "flash_attention" in build.KERNELS
    assert (build.CSRC / "flash_attention.cu").is_file()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = TOL[str(dtype)[6:]]
    for b, h, hkv, sq, skv, d, causal, window in CASES + EXTRA + WIDE + HOPPER:
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        before = flash_attention_kernel.launches
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_attention_kernel.launches == before + 1
        ref = ops.attention_reference(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        row = (out.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1)
        assert float(row.max()) <= ROW_TOL[str(dtype)[6:]]
