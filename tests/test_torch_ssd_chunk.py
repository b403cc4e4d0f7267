"""The port's SSD chunk scan against the JAX package's.

* the plain PyTorch version ``ssd_ref`` (what the wrapper runs for a CPU
  tensor) against the jnp oracle ``ssd_ref``;
* ``ops.ssd_scan`` in the model layout against the Pallas ``ssd_scan`` in
  interpret mode, over the reference's four kernel cases, Zamba2's smoke
  shape, a ragged chunk (S 12 < chunk 16), odd N / P / chunk (5 / 7 / 13),
  a slow decay over 8 chunks
  (log_a in (-0.01, 0): the state carried between chunks matters), the
  mLSTM's N = P = 192 and its N 192, P 1 normaliser at chunk 128, and a P
  of 130 (two full P tiles of the kernel and a ragged one), in f32 and
  bf16;
* ``chunked_decay_attention(impl="kernel")`` is ``ssd_scan`` (the plain
  chunked form is held against the reference in ``test_torch_ssm.py``);
* head-broadcast (stride-0) q and k against contiguous copies; the
  wrapper's checks (N up to 192 and any P taken, N 193 and a working set
  beyond the 227 KB refused), its tile choice and shared-memory budget
  (pinned at N 192, P tile 64, chunk 128) and its C interface (``struct
  SsdParams`` in the CUDA source, field for field); the phase-timing
  tool's markers in the CUDA source;
* the bf16 ``wgmma`` body's rounding plan (``ref.ssd_rounded``: W, k_dec
  and S_prev as bf16 hi + lo, the decay factorised or per element) against
  the JAX oracle at Zamba2's widths, at the unchanged limits, and one bf16
  k_dec breaking the state's limit, one bf16 S_prev y's; which body
  ``body_for`` picks for the Zamba2 layer's views and for the layouts it
  leaves to the CUDA cores; the build hashing the shared Hopper header;
* the CUDA kernel against the plain version, on a card only (``gpu``).

Tolerances: ``ssd_ref`` ≤ 5e-5 (f32, sums in another order; rounding
builds up over up to 512 sequential steps with states up to ~10);
``ssd_scan`` ≤ 2e-4 abs + rel in f32 (the reference's own
kernel-vs-oracle bound) and the final state ≤ 2e-4 for both dtypes (f32 on
both sides); in bf16 each element of ``y`` ≤ 2e-2 abs + rel and each output
row within 1e-2 of its norm (both sides compute in f32 and round ``y``
once).
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ops as jops
from repro.kernels.ssd_chunk.ref import ssd_ref as j_ssd_ref
from repro_torch import bridge
from repro_torch.kernels import build
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.kernels.ssd_chunk import ops, phase_timing, ssd_chunk_kernel, ssd_ref
from repro_torch.kernels.ssd_chunk.ref import FACTOR_SPAN, ssd_rounded
from repro_torch.models import ssm

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

CASES = [
    # (b, h, s, n, p, chunk) — tests/test_kernels_ssd.py
    (1, 2, 128, 128, 128, 64),
    (2, 3, 256, 128, 128, 128),
    (1, 2, 128, 64, 128, 32),
    (1, 1, 256, 128, 64, 128),
]
SMOKE = (2, 8, 32, 16, 32, 16)      # zamba2-7b smoke: 8 heads, N 16, P 32, chunk 16
RAGGED = (2, 3, 12, 16, 32, 16)     # S 12 < chunk 16: one chunk of 12
ODD = (1, 3, 52, 5, 7, 13)          # odd N, P and chunk: padded in the kernel
SLOW = (1, 2, 512, 32, 32, 64)      # log_a in (-0.01, 0) over 8 chunks
XLSTM = (1, 2, 256, 192, 192, 128)  # xlstm-125m's mLSTM: N = P = 192, chunk 128
XLSTM_NORM = (1, 2, 256, 192, 1, 128)   # its normaliser scan: P 1
WIDE_P = (1, 2, 64, 32, 130, 32)    # P tiles of 64, 64 and a ragged 2
ALL = CASES + [SMOKE, RAGGED, ODD, SLOW, XLSTM, XLSTM_NORM, WIDE_P]
SEQ_TOL = 5e-5                      # ssd_ref: 512 sequential f32 steps, |S| up to ~10
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
ROW_TOL = 1e-2                      # bf16, of the row's norm over P
STATE_TOL = 2e-4


def _inputs(case, dtype="float32", seed=0):
    """q, k (B,S,H,N), v (B,S,H,P) as numpy arrays of ``dtype`` (bf16 as
    ``ml_dtypes.bfloat16``, rounded by JAX), log_a (B,S,H) f32: the
    reference's regime (decays in (0.8, 1)), or (0.99, 1) for ``SLOW``."""
    b, h, s, n, p, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, n)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, s, h, n)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if case == SLOW:
        log_a = -rng.uniform(0.0, 0.01, (b, s, h)).astype(np.float32)
    else:
        log_a = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.2
    cast = [np.asarray(jnp.asarray(a, jnp.dtype(dtype))) for a in (q, k, v)]
    return (*cast, log_a)


def _torch(arrs):
    return [bridge.from_numpy_tree({"x": a})["x"] for a in arrs]


def _close(out: torch.Tensor, ref, tol: float, msg: str = "") -> None:
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


@pytest.mark.parametrize("case", ALL)
def test_ref_matches_jax_ref(case):
    q, k, v, la = _inputs(case, seed=1)
    bhs = [np.swapaxes(a, 1, 2) for a in (q, k, v, la)]
    y_j, st_j = j_ssd_ref(*map(jnp.asarray, bhs))
    y, st = ssd_ref(*_torch(bhs))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close(y, y_j, SEQ_TOL)
    _close(st, st_j, SEQ_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ALL)
def test_scan_matches_jax_pallas_interpret(case, dtype):
    chunk = case[-1]
    q, k, v, la = _inputs(case, dtype, seed=hash(case) % 2**31)
    y_j, st_j = jops.ssd_scan(*map(jnp.asarray, (q, k, v, la)), chunk=chunk,
                              interpret=True)
    y, st = ops.ssd_scan(*_torch((q, k, v, la)), chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and y.shape == v.shape and y.is_contiguous()
    assert st.dtype == torch.float32 and st.shape == (case[0], case[1], case[3], case[4])
    _close(y, y_j, TOL[dtype])
    _close(st, st_j, STATE_TOL)
    if dtype == "bfloat16":
        ref = torch.from_numpy(np.asarray(y_j, np.float32))
        row = (y.float() - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
        assert float(row.max()) <= ROW_TOL


def test_slow_decay_carries_the_state():
    """The slow-decay case depends on the carried state: dropping it (each
    chunk from zero) moves the output far beyond the tolerance."""
    q, k, v, la = _torch(_inputs(SLOW, seed=2))
    chunk = SLOW[-1]
    y, _ = ops.ssd_scan(q, k, v, la, chunk=chunk)
    pieces = [ops.ssd_scan(*(t[:, i:i + chunk] for t in (q, k, v, la)), chunk=chunk)[0]
              for i in range(0, SLOW[2], chunk)]
    assert float((y - torch.cat(pieces, dim=1)).abs().max()) > 100 * TOL["float32"]


def test_kernel_impl_is_the_scan():
    q, k, v, la = _torch(_inputs(SMOKE, seed=7))
    y, st = ssm.chunked_decay_attention(q, k, v, la, SMOKE[-1], impl="kernel")
    y2, st2 = ops.ssd_scan(q, k, v, la, chunk=SMOKE[-1])
    assert torch.equal(y, y2) and torch.equal(st, st2)
    with pytest.raises(ValueError, match="impl"):
        ssm.chunked_decay_attention(q, k, v, la, SMOKE[-1], impl="pallas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_broadcast_views_equal_copies(dtype):
    """q and k as ``expand`` views over heads (stride 0, as ``mamba2_forward``
    passes them) give what contiguous copies give."""
    b, h, s, n, p, chunk = SMOKE
    q, k, v, la = _torch(_inputs(SMOKE, dtype, seed=8))
    qb = q[:, :, :1].expand(b, s, h, n)
    kb = k[:, :, :1].expand(b, s, h, n)
    assert qb.stride(2) == 0 and kb.stride(2) == 0
    y, st = ops.ssd_scan(qb, kb, v, la, chunk=chunk)
    y2, st2 = ops.ssd_scan(qb.contiguous(), kb.contiguous(), v, la, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)


def test_kernel_layout_and_strided_out():
    q, k, v, la = (t.transpose(1, 2) for t in _torch(_inputs(SMOKE, seed=9)))
    y_ref, st_ref = ssd_ref(q, k, v, la)
    y, st = ssd_chunk_kernel(q, k, v, la, chunk=SMOKE[-1])
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)
    buf = torch.full((v.shape[0], v.shape[2], v.shape[1], v.shape[3]), float("nan"))
    got, _ = ssd_chunk_kernel(q, k, v, la, chunk=SMOKE[-1], out=buf.transpose(1, 2))
    assert got.data_ptr() == buf.data_ptr()
    assert torch.equal(buf.transpose(1, 2), y_ref)


@pytest.mark.parametrize("bad", ["dim", "dtype", "mixed", "log_a_dtype", "log_a_shape",
                                 "shape", "n", "p", "chunk_zero", "not_divisible",
                                 "chunk_too_long", "no_fit", "no_fit_n192", "out",
                                 "empty"])
def test_wrapper_rejects(bad):
    b, h, s, n, p = 1, 2, 32, 16, 8
    q, k = torch.zeros(b, h, s, n), torch.zeros(b, h, s, n)
    v, la = torch.zeros(b, h, s, p), torch.zeros(b, h, s)
    kw = {"chunk": 16}
    if bad == "dim":
        q = q[0]
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "log_a_dtype":
        la = la.to(torch.bfloat16)
    elif bad == "log_a_shape":
        la = torch.zeros(b, h, s + 1)
    elif bad == "shape":
        k = torch.zeros(b, h, s, n + 1)
    elif bad == "n":           # one past the N a CTA holds
        q, k = torch.zeros(b, h, s, sk.MAX_N + 1), torch.zeros(b, h, s, sk.MAX_N + 1)
    elif bad == "p":           # one column past the grid's P tiles (a stride-0 view)
        v = torch.zeros(1, 1, 1, 1).expand(b, h, s, sk.MAX_P_TILES * sk.P_TILE + 1)
    elif bad == "chunk_zero":
        kw["chunk"] = 0
    elif bad == "not_divisible":
        kw["chunk"] = 12
    elif bad == "chunk_too_long":
        q, k = torch.zeros(b, h, 512, n), torch.zeros(b, h, 512, n)
        v, la = torch.zeros(b, h, 512, p), torch.zeros(b, h, 512)
        kw["chunk"] = 512
    elif bad == "no_fit":      # N = P = 128 at chunk 256: 246,784 bytes at TQ 4
        q, k = torch.zeros(b, h, 256, 128), torch.zeros(b, h, 256, 128)
        v, la = torch.zeros(b, h, 256, 128), torch.zeros(b, h, 256)
        kw["chunk"] = 256
    elif bad == "no_fit_n192":   # the mLSTM's N 192 at chunk 256: 331,776 bytes
        q, k = torch.zeros(b, h, 256, 192), torch.zeros(b, h, 256, 192)
        v, la = torch.zeros(b, h, 256, 192), torch.zeros(b, h, 256)
        kw["chunk"] = 256
    elif bad == "out":
        kw["out"] = torch.zeros(b, h, s, p + 1)
    elif bad == "empty":
        q, k = torch.zeros(b, h, 0, n), torch.zeros(b, h, 0, n)
        v, la = torch.zeros(b, h, 0, p), torch.zeros(b, h, 0)
    with pytest.raises((ValueError, TypeError)):
        ssd_chunk_kernel(q, k, v, la, **kw)


@pytest.mark.parametrize("case", ["n130", "p129", "n192_p200"])
def test_wrapper_accepts_wide_n_and_p(case):
    """N up to 192 and any P (P 129 and 200: a ragged last P tile on the
    card) pass the checks; on the CPU the call is the plain version."""
    n, p = {"n130": (130, 8), "p129": (16, 129), "n192_p200": (192, 200)}[case]
    b, h, s = 1, 2, 32
    gen = torch.Generator().manual_seed(4)
    q, k = (torch.randn(b, h, s, n, generator=gen) * 0.3 for _ in range(2))
    v = torch.randn(b, h, s, p, generator=gen)
    la = -0.2 * torch.rand(b, h, s, generator=gen)
    y, st = ssd_chunk_kernel(q, k, v, la, chunk=16)
    y_ref, st_ref = ssd_ref(q, k, v, la)
    assert y.shape == (b, h, s, p) and st.shape == (b, h, n, p)
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)


def test_tile_choice():
    """Zamba2's layer (N 64, P 64, chunk 128) runs 32-row query tiles in
    112,128 bytes of shared memory (two CTAs fit in an SM's 228 KB); the
    reference's N = P = chunk = 128 cases, one 64-column P tile per CTA,
    fit at 32 rows too; ragged chunks pad to a multiple of 4."""
    assert sk.tile_rows(64, 64, 128) == 32
    assert sk._smem_bytes(64, 64, 128, 32) == 112_128
    assert 2 * (112_128 + 1024) <= 228 * 1024
    assert sk.tile_rows(128, 128, 128) == 32
    assert sk._smem_bytes(128, 128, 128, 32) == sk._smem_bytes(128, 64, 128, 32) \
        <= sk.MAX_SMEM_BYTES
    assert sk.tile_rows(16, 32, 12) == 12
    assert sk.tile_rows(16, 32, 13) == 16


def test_smem_budget_at_the_mlstm_width():
    """The mLSTM's N 192 at chunk 128: a CTA holds all of N and one P tile
    of 64, 230,912 of the 232,448 bytes a block may use at 32 query rows
    (64 rows would not fit); the P 1 normaliser scan fits at 32 rows too; a
    P tile of 32 would take 189,952.  At chunk 256 no tile fits."""
    assert sk.P_TILE == 64 and sk.MAX_N == 192
    assert sk._smem_bytes(192, 192, 128, 32) == sk._smem_bytes(192, 64, 128, 32) == 230_912
    assert 230_912 <= sk.MAX_SMEM_BYTES < sk._smem_bytes(192, 64, 128, 64)
    assert sk.tile_rows(192, 192, 128) == sk.tile_rows(192, 1, 128) == 32
    assert sk._smem_bytes(192, 32, 128, 32) == 189_952
    with pytest.raises(ValueError, match="shared memory"):
        sk.tile_rows(192, 192, 256)


def test_params_struct_matches_cuda_source():
    """``_Params`` is ``struct SsdParams`` field for field: same names in the
    same order, pointers / long long[4] / long long[3] / int as declared."""
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    body = re.search(r"struct SsdParams \{(.*?)\};", src, re.S).group(1)
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
              "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
              "long long[4]": ctypes.c_longlong * 4,
              "long long[3]": ctypes.c_longlong * 3, "int": ctypes.c_int}
    py_fields = sk._Params._fields_
    assert [n for n, _ in c_fields] == [n for n, _ in py_fields]
    for (name, ctype), (_, pytype) in zip(c_fields, py_fields):
        assert expect[ctype] == pytype, name


def _cuda_consts() -> dict[str, int]:
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_cuda_limits_match_the_wrapper():
    consts = _cuda_consts()
    assert consts["kMaxN"] == sk.MAX_N
    assert consts["kPTile"] == sk.P_TILE
    assert consts["kMaxPTiles"] == sk.MAX_P_TILES
    assert consts["kMaxChunk"] == sk.MAX_CHUNK
    assert consts["kMaxSmem"] == sk.MAX_SMEM_BYTES
    assert consts["kWgmmaDim"] == sk.WGMMA_MAX_DIM
    assert consts["kWgmmaChunk"] == sk.WGMMA_MAX_CHUNK
    assert consts["kFactorSpan"] == FACTOR_SPAN


def test_wgmma_body_fits_shared_memory():
    """The wgmma body's ring of q / k / v boxes and k_dec hi / lo tiles, two
    S_prev hi / lo buffers, the per-stage vectors and barriers fit in the
    227 KB a block may use (``WgSmem`` in the CUDA source), one CTA per SM."""
    c = _cuda_consts()
    tile, state = c["kWgmmaChunk"] * c["kRowBytes"], c["kWgmmaDim"] * c["kRowBytes"]
    assert (c["kRowBytes"], tile, state) == (128, 16_384, 8_192)
    st = c["kStages"]
    total = (5 * st * tile + 4 * state + st * 5 * c["kWgmmaChunk"] * 4
             + st * 8 + 8 * 4 * st + 1024)
    assert 116 * 1024 < total <= sk.MAX_SMEM_BYTES


def test_launcher_declares_its_c_signature(monkeypatch):
    launch = type("Launch", (), {"argtypes": None, "restype": ctypes.c_int})()
    lib = type("Lib", (), {"ssd_chunk_launch": launch})()
    monkeypatch.setattr(build, "load", lambda name: lib)
    fn = sk._lib().ssd_chunk_launch
    assert fn.argtypes == [ctypes.POINTER(sk._Params), ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


def test_phase_timing_instruments_every_phase():
    """The on-card phase-timing tool finds each place it instruments in the
    kernel source exactly once (it raises otherwise): the CUDA-core body's
    five phase ends, the wgmma body's ten steps per consumer warpgroup and
    the producer's wait for a free stage."""
    src = phase_timing.instrumented_source(448)
    n_ph = len(phase_timing.WG_PHASES)
    assert n_ph == 10
    # CUDA-core: the start mark and five phase ends; wgmma: the start mark,
    # ten step ends, and the two clocks around the producer's wait
    assert src.count("clock64()") == (1 + 5) + (1 + n_ph + 2)
    for slot in range(n_ph):
        assert src.count(f"ph[{slot}] += t - t_mark") == 1
    assert "g_dbg[448 * 5]" in src and f"g_ph[448 * 2 * {n_ph}]" in src
    assert "g_wait[448]" in src and "ssd_dbg_read" in src


def test_ssd_chunk_is_built_with_the_port():
    assert "ssd_chunk" in build.KERNELS
    assert (build.CSRC / "ssd_chunk.cu").is_file()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    name = str(dtype)[6:]
    for b, h, s, n, p, chunk in ALL:
        q = (torch.randn(b, s, h, n, device="cuda", generator=gen) * 0.3).to(dtype)
        k = (torch.randn(b, s, h, n, device="cuda", generator=gen) * 0.3).to(dtype)
        v = torch.randn(b, s, h, p, device="cuda", generator=gen).to(dtype)
        la = -torch.rand(b, s, h, device="cuda", generator=gen) * 0.2
        before = ssd_chunk_kernel.launches
        y, st = ops.ssd_scan(q, k, v, la, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_chunk_kernel.launches == before + 1
        y_ref, st_ref = ops.ssd_reference(q, k, v, la)
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=TOL[name],
                                   atol=TOL[name])
        torch.testing.assert_close(st, st_ref, rtol=STATE_TOL, atol=STATE_TOL)


# -- the bf16 wgmma body: rounding plan, route, build -------------------------

ZAMBA2_WIDTH = (1, 4, 1024, 64, 64, 128)   # N = P = 64, chunk 128, 4 heads, 8 chunks
# log_a ranges: the reference's draw; slow decays (the state grows to ~30);
# totals near -128 (the factorised decay's rebased range); totals below
# -2·FACTOR_SPAN (the per-element decay)
DECAYS = {"ref": None, "slow": (0.0, 0.01), "steep": (0.9, 1.1), "steeper": (1.8, 2.2)}


def _zamba2_width_inputs(decay: str, seed: int = 21):
    """Head-broadcast q, k (B,H,S,N) and v (B,H,S,P) bf16 as numpy arrays
    rounded by JAX, log_a (B,H,S) f32, in the kernel's (B, H, S, ·) layout."""
    b, h, s, n, p, _ = ZAMBA2_WIDTH
    rng = np.random.default_rng(seed)
    q = np.broadcast_to(rng.standard_normal((b, 1, s, n)).astype(np.float32) * 0.3,
                        (b, h, s, n))
    k = np.broadcast_to(rng.standard_normal((b, 1, s, n)).astype(np.float32) * 0.3,
                        (b, h, s, n))
    v = rng.standard_normal((b, h, s, p)).astype(np.float32)
    if DECAYS[decay] is None:
        log_a = -np.abs(rng.standard_normal((b, h, s))).astype(np.float32) * 0.2
    else:
        log_a = -rng.uniform(*DECAYS[decay], (b, h, s)).astype(np.float32)
    cast = [np.ascontiguousarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v)]
    return (*cast, log_a)


def _rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((out.float() - ref).abs() / (1 + ref.abs())).max())


@pytest.mark.parametrize("decay", list(DECAYS))
def test_rounding_plan_holds_the_limits(decay):
    """The wgmma body's operand rounding, emulated by ``ssd_rounded``, keeps
    y within ``TOL["bfloat16"]`` per element and ``ROW_TOL`` per row, and the
    f32 final state within ``STATE_TOL``, of the JAX oracle at Zamba2's
    widths, for the factorised decay and the per-element one."""
    arrs = _zamba2_width_inputs(decay)
    totals = arrs[3].reshape(*arrs[3].shape[:2], -1, ZAMBA2_WIDTH[-1]).sum(-1)
    assert (totals >= -2 * FACTOR_SPAN).all() == (decay != "steeper")
    y_j, st_j = j_ssd_ref(*map(jnp.asarray, arrs))
    y, st = ssd_rounded(*_torch(arrs), ZAMBA2_WIDTH[-1])
    ref = torch.from_numpy(np.asarray(y_j, np.float32))
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y.float()).all())
    assert _rel(y, ref) <= TOL["bfloat16"]
    row = (y.float() - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    assert float(row.max()) <= ROW_TOL
    assert _rel(st, torch.from_numpy(np.array(st_j))) <= STATE_TOL


def test_single_bf16_kdec_breaks_the_state_limit():
    """Why k_dec enters the state product as bf16 hi + lo: one bf16 term
    puts the f32 final state past ``STATE_TOL``, compounding over chunks."""
    arrs = _zamba2_width_inputs("ref")
    _, st_j = j_ssd_ref(*map(jnp.asarray, arrs))
    _, st = ssd_rounded(*_torch(arrs), ZAMBA2_WIDTH[-1], split_kdec=False)
    assert _rel(st, torch.from_numpy(np.array(st_j))) > 5 * STATE_TOL


def test_single_bf16_state_breaks_the_element_limit():
    """Why S_prev enters q·S_prev as bf16 hi + lo: under slow decays the
    state grows, and one bf16 copy of it puts y past ``TOL["bfloat16"]``."""
    arrs = _zamba2_width_inputs("slow")
    y_j, _ = j_ssd_ref(*map(jnp.asarray, arrs))
    y, _ = ssd_rounded(*_torch(arrs), ZAMBA2_WIDTH[-1], split_state=False)
    assert _rel(y, torch.from_numpy(np.asarray(y_j, np.float32))) > TOL["bfloat16"]


def _meta(shape, dtype=torch.bfloat16, offset: int = 0):
    return torch.empty(int(np.prod(shape)) + offset, dtype=dtype,
                       device="meta")[offset:].view(shape)


def test_route_takes_the_zamba2_layer_views():
    """The Zamba2 layer as ``ops.ssd_scan`` hands it over: head-broadcast
    q / k (stride 0), v and y as (B, H, S, P) views of (B, S, H, P)."""
    b, h, s, n, p = 4, 112, 4096, 64, 64
    q = _meta((b, s, 1, n)).expand(b, s, h, n).transpose(1, 2)
    k = _meta((b, s, 1, n)).expand(b, s, h, n).transpose(1, 2)
    v, y = (_meta((b, s, h, p)).transpose(1, 2) for _ in range(2))
    assert q.stride(1) == 0 and v.stride(2) == h * p
    assert sk.body_for(q, k, v, 128, y) == "wgmma"


@pytest.mark.parametrize("case", ["odd", "unaligned_stride", "unaligned_base",
                                  "float32", "wide", "long_chunk", "strided_cols"])
def test_route_leaves_the_rest_to_the_cuda_cores(case):
    b, h, s, n, p, chunk = 1, 4, 256, 64, 64, 128
    dtype, offset, row_pad = torch.bfloat16, 0, 0
    if case == "odd":            # rows of 10 / 14 bytes
        b, h, s, n, p, chunk = 1, 3, 52, 5, 7, 13
    elif case == "unaligned_stride":   # rows 68 elements apart: 136 bytes
        row_pad = 4
    elif case == "unaligned_base":
        offset = 1
    elif case == "float32":
        dtype = torch.float32
    elif case == "wide":
        p = 128
    elif case == "long_chunk":
        chunk = 256
    q = _meta((b, h, s, n + row_pad), dtype, offset)[..., :n]
    k = _meta((b, h, s, n), dtype)
    v, y = _meta((b, h, s, p), dtype), _meta((b, h, s, p), dtype)
    if case == "strided_cols":
        v = _meta((b, h, s, 2 * p), dtype)[..., ::2]
    assert sk.body_for(q, k, v, chunk, y) == "cuda_core"


def test_body_helper_needs_a_card():
    q, k, v, la = (t.transpose(1, 2) for t in _torch(_inputs(SMOKE, "bfloat16", seed=3)))
    with pytest.raises(ValueError, match="cuda"):
        sk.ssd_chunk_body(q, k, v, la, body="wgmma", chunk=SMOKE[-1])


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited ``.cuh`` header renames (so rebuilds) every library whose
    source includes it, and no other."""
    (tmp_path / "hopper.cuh").write_text("// helpers v1\n")
    (tmp_path / "a.cu").write_text('#include "hopper.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("a"), build.library_path("b")
    assert build.headers(tmp_path / "a.cu") == [tmp_path / "hopper.cuh"]
    (tmp_path / "hopper.cuh").write_text("// helpers v2\n")
    assert build.library_path("a") != before[0]
    assert build.library_path("b") == before[1]


def test_both_hopper_kernels_include_the_shared_header(monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    for name in ("flash_attention", "ssd_chunk"):
        assert build.headers(build.CSRC / f"{name}.cu") == [build.CSRC / "hopper.cuh"]
    cmd = build.nvcc_command(build.CSRC / "ssd_chunk.cu", build.BUILD_DIR / "x.so")
    assert cmd[cmd.index("-I") + 1] == str(build.CSRC)


@pytest.mark.gpu
def test_cuda_zamba2_width_call_takes_the_wgmma_body():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h, s, n, p, chunk = 2, 8, 512, 64, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = (torch.randn(b, s, 1, n, device="cuda", generator=gen) * 0.3).bfloat16()
    k = (torch.randn(b, s, 1, n, device="cuda", generator=gen) * 0.3).bfloat16()
    q, k = q.expand(b, s, h, n), k.expand(b, s, h, n)
    v = torch.randn(b, s, h, p, device="cuda", generator=gen).bfloat16()
    la = -torch.rand(b, s, h, device="cuda", generator=gen) * 0.2
    before = dict(ssd_chunk_kernel.launches_by_body)
    y, st = ops.ssd_scan(q, k, v, la, chunk=chunk)
    torch.cuda.synchronize()
    after = ssd_chunk_kernel.launches_by_body
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["cuda_core"] == before["cuda_core"]
    y_ref, st_ref = ops.ssd_reference(q, k, v, la)
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])
    torch.testing.assert_close(st, st_ref, rtol=STATE_TOL, atol=STATE_TOL)
