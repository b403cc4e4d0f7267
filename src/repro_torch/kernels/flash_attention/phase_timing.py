"""Where the bf16 flash kernel spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.phase_timing

Builds a copy of ``csrc/flash_attention.cu`` with ``clock64`` counters in
the bf16 body: the first thread of each consumer warpgroup reads the clock
after each step of a key tile (waiting for K, S = Q Kᵀ issued and retired,
the softmax and the packing of P, waiting for V, P·V issued and retired),
and the producer's thread adds up the cycles it waits for a free stage.
For the heaviest query tile of head 0, batch 0 it also keeps the clock at
which each warpgroup starts each tile's S product, so the two warpgroups'
offset shows whether they take turns on the tensor cores or run in step.
It runs once at TinyLlama's, Zamba2's and Gemma's prefill layers (B 4,
S 4,096, causal, bf16; Gemma's D 256 walks 64-key tiles) and prints the mean
cycles per key tile and warpgroup of each step, the producer's waits, and
the offsets; it also times the real kernel (CUDA events).  The copy goes to
``build/kernels/`` and is never the kernel the port runs; it prints the
copy's spills, since a copy that spills is slower than the kernel.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops

SHAPES = {"tinyllama": (4, 32, 4, 4096, 64), "zamba2": (4, 32, 32, 4096, 112),
          "gemma": (4, 8, 1, 4096, 256)}  # B, H, Hkv, S, D
PHASES = ("wait K", "S = QK^T", "softmax", "wait V", "P V")
MAX_TILES = 256   # key tiles whose S start is kept for the traced CTA


def _mark(slot: int) -> str:
    return (f"\n      if (threadIdx.x % kWG == 0) {{ long long t = clock64(); "
            f"dbg[{slot}] += t - t_mark; t_mark = t; }}")


# text in the kernel -> what follows it in the instrumented copy
_MARKS = {
    "      mbar_wait(k_full(st), phase);":
        _mark(0) + "\n      if (traced && threadIdx.x % kWG == 0 && i < MAX_TILES) "
                   "g_ts[wg * MAX_TILES + i] = t_mark;",
    "      wgmma_wait_all();\n      fence_acc(s);": _mark(1),
    "      mbar_wait(v_full(st), phase);": _mark(3),
    "      wgmma_wait_all();\n      fence_acc(o);": _mark(4),
}


def instrumented_source(ctas: int) -> str:
    src = (build.CSRC / "flash_attention.cu").read_text()
    before_v = "      mbar_wait(v_full(st), phase);"
    wait_empty = "        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);   // the first round passes"
    start = "    if (n_tiles > 0) mbar_wait(bar_q, 0);"
    end = "    // O / l, rounded to bf16, into the strided output"
    for text in (*_MARKS, wait_empty, start, end, "namespace {\n"):
        if src.count(text) != 1:
            raise RuntimeError(f"marker not found once in flash_attention.cu: {text!r}")
    # the softmax ends where the wait for V begins
    src = src.replace(before_v, _mark(2).lstrip("\n") + "\n" + before_v)
    for text, mark in _MARKS.items():
        src = src.replace(text, text + mark)
    src = src.replace(wait_empty, "        { const long long w0 = clock64();\n" + wait_empty +
                      "\n          wait_cycles += clock64() - w0; }")
    src = src.replace("    if (threadIdx.x == 2 * kWG && n_tiles > 0) {",
                      "    long long wait_cycles = 0;\n"
                      "    if (threadIdx.x == 2 * kWG && n_tiles > 0) {", 1)
    src = src.replace("    setmaxnreg_inc<kConsumerRegs>();",
                      "    setmaxnreg_inc<kConsumerRegs>();\n    long long dbg[5] = {};\n"
                      "    const bool traced = blockIdx.x == 0 && blockIdx.y == 0 && "
                      "blockIdx.z == 0;", 1)
    src = src.replace(start, start + "\n    long long t_mark = clock64();")
    src = src.replace(end, "    if (threadIdx.x % kWG == 0)\n      for (int z = 0; z < 5; ++z)\n"
                           "        g_dbg[(cta_id() * 2 + wg) * 5 + z] = dbg[z];\n" + end)
    # the producer's waits, stored as it leaves
    src = src.replace("  } else {\n    // ---- consumers",
                      "    if (threadIdx.x == 2 * kWG) g_wait[cta_id()] = wait_cycles;\n"
                      "  } else {\n    // ---- consumers", 1)
    src = src.replace("namespace {\n",
                      f"__device__ long long g_dbg[{ctas} * 2 * 5];\n"
                      f"__device__ long long g_wait[{ctas}];\n"
                      f"__device__ long long g_ts[2 * {MAX_TILES}];\n"
                      f"constexpr int MAX_TILES = {MAX_TILES};\n"
                      "__device__ __forceinline__ int cta_id() {\n"
                      "  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
                      "}\nnamespace {\n", 1)
    return src + ('\nextern "C" int flash_dbg_read(void* dbg, void* wait, void* ts) {\n'
                  '  int e = (int)cudaMemcpyFromSymbol(dbg, g_dbg, sizeof(g_dbg));\n'
                  '  if (!e) e = (int)cudaMemcpyFromSymbol(wait, g_wait, sizeof(g_wait));\n'
                  '  if (!e) e = (int)cudaMemcpyFromSymbol(ts, g_ts, sizeof(g_ts));\n'
                  '  return e;\n}\n')


def _build_instrumented(ctas: int) -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "flash_attention_phases.cu"
    lib = build.BUILD_DIR / "libflash_attention_phases.so"
    src.write_text(instrumented_source(ctas))
    out = subprocess.run(build.nvcc_command(src, lib), capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    body = None
    for line in (out.stdout + out.stderr).splitlines():
        if "Compiling entry" in line:
            body = line.split("ILi")[1].split("E")[0] if "flash_fwd_bf16" in line else None
        elif body and "spill" in line:
            print(f"[flash_phases] instrumented copy, DP {body}: {line.strip()}")
    return ctypes.CDLL(str(lib))


def _ms(fn, reps: int = 10, repeats: int = 5) -> float:
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


def key_tile(d: int) -> int:
    """Keys per K / V tile of the bf16 body at head dim ``d`` (64 at DP 256)."""
    return 128 if d <= 128 else 64


def _tiles(q_tiles: int, s: int, tile: int = 128, keys: int = 128) -> np.ndarray:
    """Key tiles of ``keys`` keys each CTA of a causal S x S layer walks, by
    grid x index (grid x 0 runs the last query tile of ``tile`` rows)."""
    q0 = (q_tiles - 1 - np.arange(q_tiles)) * tile
    return (np.minimum(s, q0 + tile) + keys - 1) // keys


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_timing: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"[flash_phases] {torch.cuda.get_device_name(0)}; bf16, causal; cycles from "
          f"clock64 on each SM")
    ctas = max(b * h * (s // 128) for b, h, _, s, _ in SHAPES.values())
    lib = _build_instrumented(ctas)
    real = build.load("flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for name, (b, h, hkv, s, d) in SHAPES.items():
            q = torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16()
            k = torch.randn(b, s, hkv, d, device="cuda", generator=gen).bfloat16()
            v = torch.randn(b, s, hkv, d, device="cuda", generator=gen).bfloat16()
            build._loaded["flash_attention"] = real
            ms = _ms(lambda: ops.flash_attention(q, k, v, causal=True))
            build._loaded["flash_attention"] = lib
            ops.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            dbg = np.zeros(ctas * 2 * 5, np.int64)
            wait = np.zeros(ctas, np.int64)
            ts = np.zeros(2 * MAX_TILES, np.int64)
            rc = lib.flash_dbg_read(ctypes.c_void_p(dbg.ctypes.data),
                                    ctypes.c_void_p(wait.ctypes.data),
                                    ctypes.c_void_p(ts.ctypes.data))
            if rc != 0:
                raise RuntimeError(f"reading the counters failed: cudaError {rc}")
            n = b * h * (s // 128)
            kt = key_tile(d)
            tiles = int(_tiles(s // 128, s, keys=kt).sum()) * b * h   # key tiles walked, all CTAs
            per_tile = dbg[:n * 10].reshape(n, 2, 5).sum(axis=0) / tiles
            for wg in range(2):
                parts = ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, per_tile[wg]))
                print(f"[flash_phases] {name} B{b} H{h} Hkv{hkv} S{s} D{d}: kernel {ms:.6f} ms; "
                      f"consumer warpgroup {wg}, cycles per key tile: {parts}; "
                      f"sum {per_tile[wg].sum():.0f}")
            print(f"[flash_phases] {name}: producer waits for a free stage "
                  f"{wait[:n].sum() / tiles:.0f} cycles per key tile")
            nt = int(_tiles(s // 128, s, keys=kt)[0])
            t0, t1 = ts[:nt], ts[MAX_TILES:MAX_TILES + nt]
            off = t1 - t0
            step = np.diff(t0)
            print(f"[flash_phases] {name}: heaviest CTA ({nt} key tiles), warpgroup 1's S "
                  f"start minus warpgroup 0's: median {np.median(off):.0f} cycles (|.| "
                  f"median {np.median(np.abs(off)):.0f}), against {np.median(step):.0f} "
                  f"cycles per tile")
            del q, k, v
            torch.cuda.empty_cache()
    finally:
        build._loaded["flash_attention"] = real
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
