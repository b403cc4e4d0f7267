"""Where the SSD chunk kernel spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_chunk.phase_timing

Builds a copy of ``csrc/ssd_chunk.cu`` with ``clock64`` counters in both
bodies and runs each once at Zamba2's layer (B 4, H 112, S 4,096, N 64,
P 64, chunk 128, bf16, head-broadcast q / k):

* the bf16 ``wgmma`` body: the first thread of each consumer warpgroup reads
  the clock after each step of a chunk (waiting for q / k, Q·Kᵀ, the decay
  and select with W's hi / lo split, waiting for v, W·V, waiting for the
  state, q·S_prev, storing y, then for warpgroup 0 waiting for the k_dec
  tiles and the state update, for warpgroup 1 the stage's release); the
  producer's thread adds up the cycles it waits for a free stage;
* the CUDA-core body: thread 0 reads the clock after every block-wide
  barrier that ends a phase (staging k / v and the prefix sum, staging the
  q tiles, the score products W, the y products, the state update; the
  last chunk's update is not counted).

It prints the mean cycles per chunk and CTA of each step, and times both
real bodies (CUDA events) on the same inputs.  The copy goes to
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

SHAPE = (4, 112, 4096, 64, 64, 128)       # B, H, S, N, P, chunk
PHASES = ("stage k/v/cum", "stage q", "W", "y", "S update")
WG_PHASES = ("wait q/k", "Q K^T", "decay+select", "wait v", "W V", "wait state",
             "q S_prev", "store y", "wait k_dec", "state update / release")


def _mark(slot: str) -> str:
    return (f"\n    if (threadIdx.x == 0) {{ long long t = clock64(); {slot} += t - t_mark; "
            f"t_mark = t; }}")


def _wg_mark(slot: int) -> str:
    return (f"\n    if (threadIdx.x % kWG == 0) {{ long long t = clock64(); ph[{slot}] += "
            f"t - t_mark; t_mark = t; }}")


# CUDA-core body: text in the kernel -> the counter that the interval ending there adds to
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

# wgmma body: the end of each step of a chunk, per consumer warpgroup
_WG_MARKS = {
    "    mbar_wait(bars.qk_full(st), phase);   // wait q/k": _wg_mark(0),
    "    fence_acc(s);   // Q K^T done": _wg_mark(1),
    "      }   // decay and select done": _wg_mark(2),
    "    mbar_wait(bars.v_full(st), phase);   // wait v": _wg_mark(3),
    "    fence_acc(yi);   // W V done": _wg_mark(4),
    "      bar_sync(kStateBar, 2 * kWG);   // wait state": _wg_mark(5),
    "    }   // q S_prev done": _wg_mark(6),
    "    }   // y stored": _wg_mark(7),
    "      mbar_wait(bars.kdec_full(st), phase);": _wg_mark(8),
    "    }   // state update done (warpgroup 0), stage released (1)": _wg_mark(9),
}


def _replace_once(src: str, text: str, new: str) -> str:
    if src.count(text) != 1:
        raise RuntimeError(f"marker not found once in ssd_chunk.cu: {text!r}")
    return src.replace(text, new)


def instrumented_source(ctas: int) -> str:
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    for text, mark in {**_MARKS, **_WG_MARKS}.items():
        src = _replace_once(src, text, text + mark)
    # the CUDA-core body's counters
    start = "  for (int e = tid; e < NP * PP; e += kThreads) S[e] = 0.f;"
    src = _replace_once(src, start, "  long long dbg[5] = {}; long long t_mark = clock64();\n"
                        + start)
    end = ("  float* out = prm.state + (static_cast<long long>(b) * prm.heads + h) * n * prm.p"
           " + p_lo;")
    src = _replace_once(src, end, "  if (threadIdx.x == 0)\n    for (int z = 0; z < 5; ++z) "
                                  "g_dbg[blockIdx.x * 5 + z] = dbg[z];\n" + end)
    # the wgmma body's: per consumer warpgroup, and the producer's waits
    n_ph = len(WG_PHASES)
    acc = "  float acc_s[32];                             // W = 0: the state, rows n, columns p"
    src = _replace_once(src, acc, f"  long long ph[{n_ph}] = {{}}; long long t_mark = clock64();\n"
                        + acc)
    tail = "  if constexpr (W == 0) {\n    float* out = prm.state"
    src = _replace_once(src, tail, f"  if (threadIdx.x % kWG == 0)\n    for (int z = 0; z < "
                                   f"{n_ph}; ++z) g_ph[(blockIdx.x * 2 + W) * {n_ph} + z] = "
                                   "ph[z];\n" + tail)
    wait = ("        mbar_wait(bars.empty(st), ((c / kStages) & 1) ^ 1);   "
            "// wait free stage; the first round passes")
    src = _replace_once(src, wait, "        const long long w0 = clock64();\n" + wait +
                        "\n        waited += clock64() - w0;")
    loop = "    if (ptid == 0) {\n      for (int c = 0; c < nch; ++c) {"
    src = _replace_once(src, loop, "    if (ptid == 0) {\n      long long waited = 0;\n"
                                   "      for (int c = 0; c < nch; ++c) {")
    after = ("        tma_load_4d(base + WgSmem::kV + st * kTileBytes, &tm_v, bars.v_full(st), "
             "0, c * Q, h, b);\n      }")
    src = _replace_once(src, after, after + "\n      g_wait[blockIdx.x] = waited;")
    src = _replace_once(src, "namespace {\n", f"__device__ long long g_dbg[{ctas} * 5];\n"
                                              f"__device__ long long g_ph[{ctas} * 2 * {n_ph}];\n"
                                              f"__device__ long long g_wait[{ctas}];\n"
                                              "namespace {\n")
    return src + ('\nextern "C" int ssd_dbg_read(void* dbg, void* ph, void* wait) {\n'
                  '  int e = (int)cudaMemcpyFromSymbol(dbg, g_dbg, sizeof(g_dbg));\n'
                  '  if (!e) e = (int)cudaMemcpyFromSymbol(ph, g_ph, sizeof(g_ph));\n'
                  '  if (!e) e = (int)cudaMemcpyFromSymbol(wait, g_wait, sizeof(g_wait));\n'
                  '  return e;\n}\n')


def _build_instrumented(ctas: int) -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "ssd_chunk_phases.cu"
    lib = build.BUILD_DIR / "libssd_chunk_phases.so"
    src.write_text(instrumented_source(ctas))
    out = subprocess.run(build.nvcc_command(src, lib), capture_output=True, text=True)
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
    ctas, nch, n_ph = b * h, s // chunk, len(WG_PHASES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = (torch.randn(b, s, 1, n, device="cuda", generator=gen) * 0.3).bfloat16()
    k = (torch.randn(b, s, 1, n, device="cuda", generator=gen) * 0.3).bfloat16()
    q, k = q.expand(b, s, h, n), k.expand(b, s, h, n)
    v = torch.randn(b, s, h, p, device="cuda", generator=gen).bfloat16()
    la = -0.2 * torch.randn(b, s, h, device="cuda", generator=gen).abs()
    y = torch.empty_like(v)
    views = [t.transpose(1, 2) for t in (q, k, v, la)]

    def run(body):
        return sk.ssd_chunk_body(*views, body=body, chunk=chunk, out=y.transpose(1, 2))

    print(f"[ssd_phases] {torch.cuda.get_device_name(0)}; B{b} H{h} S{s} N{n} P{p} "
          f"chunk {chunk} bf16, stride-0 q/k; cycles from clock64 on each SM")
    real = build.load("ssd_chunk")
    lib = _build_instrumented(ctas)
    try:
        build._loaded["ssd_chunk"] = real
        turns = [(body, _ms(lambda: run(body)))
                 for body in ("cuda_core", "wgmma", "wgmma", "cuda_core")]
        build._loaded["ssd_chunk"] = lib
        for body in sk.BODIES:
            run(body)
        torch.cuda.synchronize()
        dbg = np.zeros(ctas * 5, np.int64)
        ph = np.zeros(ctas * 2 * n_ph, np.int64)
        wait = np.zeros(ctas, np.int64)
        rc = lib.ssd_dbg_read(ctypes.c_void_p(dbg.ctypes.data), ctypes.c_void_p(ph.ctypes.data),
                              ctypes.c_void_p(wait.ctypes.data))
        if rc != 0:
            raise RuntimeError(f"reading the counters failed: cudaError {rc}")
    finally:
        build._loaded["ssd_chunk"] = real
    print("[ssd_phases] kernel ms in turns: " + ", ".join(f"{body} {t:.6f}"
                                                          for body, t in turns))
    ms = {body: min(t for bb, t in turns if bb == body) for body in sk.BODIES}
    per_wg = ph.reshape(ctas, 2, n_ph).mean(axis=0) / nch
    for wg in range(2):
        parts = ", ".join(f"{name} {c:.0f}" for name, c in zip(WG_PHASES, per_wg[wg]))
        print(f"[ssd_phases] wgmma body: kernel {ms['wgmma']:.6f} ms; consumer warpgroup "
              f"{wg}, cycles per chunk: {parts}; sum {per_wg[wg].sum():.0f}")
    print(f"[ssd_phases] wgmma body: producer waits for a free stage "
          f"{wait.mean() / nch:.0f} cycles per chunk")
    cycles = dbg.reshape(ctas, 5).mean(axis=0) / nch
    parts = ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, cycles))
    print(f"[ssd_phases] cuda_core body ({sk.tile_rows(n, p, chunk)}-row query tiles): "
          f"kernel {ms['cuda_core']:.6f} ms; cycles per chunk and CTA: {parts}; sum "
          f"{cycles.sum():.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
