"""Where the SSD chunk kernel spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_chunk.phase_timing

Builds a copy of ``csrc/ssd_chunk.cu`` with ``clock64`` counters at the
block-wide barriers that end each phase (thread 0 reads the clock after
every ``__syncthreads``), runs it once at Zamba2's layer (B 4, H 112,
S 4,096, N 64, P 64, chunk 128, bf16, head-broadcast q / k) and prints the
mean cycles per chunk and CTA of each phase: staging k / v and the prefix
sum, staging the q tiles, the score products W, the y products, the state
update (the last chunk's is not counted).  It also times the real kernel
(CUDA events) at each query-tile size that fits.  The copy goes to
``build/kernels/`` and is never the kernel the port runs.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.kernels.ssd_chunk import ops

SHAPE = (4, 112, 4096, 64, 64, 128)       # B, H, S, N, P, chunk
PHASES = ("stage k/v/cum", "stage q", "W", "y", "S update")


def _mark(slot: str) -> str:
    return (f"\n    if (threadIdx.x == 0) {{ long long t = clock64(); {slot} += t - t_mark; "
            f"t_mark = t; }}")


# text in the kernel -> the counter that the interval ending there adds to
_MARKS = {
    "    __syncthreads();   // the previous chunk is done with kT, vs, S":
        _mark("if (s0 > 0) dbg[4]"),
    "      __syncthreads();   // kT / vs / cum staged; the previous tile is done with qT, WT":
        _mark("dbg[i0 > 0 ? 3 : 0]"),
    "                     prm.q_stride[3], tq, NP, Q - i0, n);\n      __syncthreads();":
        _mark("dbg[1]"),
    "              make_float4(out[0], out[1], out[2], out[3]);\n        }\n      }\n"
    "      __syncthreads();": _mark("dbg[2]"),
    "    __syncthreads();   // every tile has read S": _mark("dbg[3]"),
}


def instrumented_source(ctas: int) -> str:
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    for text, mark in _MARKS.items():
        if src.count(text) != 1:
            raise RuntimeError(f"marker not found once in ssd_chunk.cu: {text!r}")
        src = src.replace(text, text + mark)
    start = "  for (int e = tid; e < NP * PP; e += kThreads) S[e] = 0.f;"
    end = "  float* out = prm.state"
    for text in (start, end, "namespace {\n"):
        if src.count(text) != 1:
            raise RuntimeError(f"marker not found once in ssd_chunk.cu: {text!r}")
    src = src.replace(start, "  long long dbg[5] = {}; long long t_mark = clock64();\n" + start)
    src = src.replace(end, "  if (threadIdx.x == 0)\n    for (int z = 0; z < 5; ++z) "
                           "g_dbg[blockIdx.x * 5 + z] = dbg[z];\n" + end)
    src = src.replace("namespace {\n", f"__device__ long long g_dbg[{ctas} * 5];\n"
                                       "namespace {\n", 1)
    return src + ('\nextern "C" int ssd_dbg_read(void* host) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_dbg, sizeof(g_dbg));\n}\n')


def _build_instrumented(ctas: int) -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "ssd_chunk_phases.cu"
    lib = build.BUILD_DIR / "libssd_chunk_phases.so"
    src.write_text(instrumented_source(ctas))
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(lib))


def _ms(fn, reps: int = 5, repeats: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_timing: needs a CUDA card", file=sys.stderr)
        return 2
    b, h, s, n, p, chunk = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = (torch.randn(b, s, 1, n, device="cuda", generator=gen) * 0.3).bfloat16()
    k = (torch.randn(b, s, 1, n, device="cuda", generator=gen) * 0.3).bfloat16()
    q, k = q.expand(b, s, h, n), k.expand(b, s, h, n)
    v = torch.randn(b, s, h, p, device="cuda", generator=gen).bfloat16()
    la = -0.2 * torch.randn(b, s, h, device="cuda", generator=gen).abs()
    print(f"[phase_timing] {torch.cuda.get_device_name(0)}; B{b} H{h} S{s} N{n} P{p} "
          f"chunk {chunk} bf16, stride-0 q/k")
    tiles = [t for t in (64, 32, 16)
             if sk._smem_bytes(n, p, chunk, t) <= sk.MAX_SMEM_BYTES]
    default = sk.TILE_Q
    lib = _build_instrumented(b * h)
    real = build.load("ssd_chunk")
    try:
        for t in tiles:
            sk.TILE_Q = (t,)
            build._loaded["ssd_chunk"] = real
            ms = _ms(lambda: ops.ssd_scan(q, k, v, la, chunk=chunk))
            build._loaded["ssd_chunk"] = lib
            ops.ssd_scan(q, k, v, la, chunk=chunk)
            torch.cuda.synchronize()
            buf = np.zeros(b * h * 5, np.int64)
            rc = lib.ssd_dbg_read(ctypes.c_void_p(buf.ctypes.data))
            if rc != 0:
                raise RuntimeError(f"reading the counters failed: cudaError {rc}")
            cycles = buf.reshape(b * h, 5).mean(axis=0) / (s // chunk)
            parts = ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, cycles))
            print(f"[phase_timing] {t}-row query tiles ({sk._smem_bytes(n, p, chunk, t)} "
                  f"bytes of shared memory): kernel {ms:.6f} ms; cycles per chunk and "
                  f"CTA: {parts}; sum {cycles.sum():.0f}")
    finally:
        sk.TILE_Q = default
        build._loaded["ssd_chunk"] = real
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
