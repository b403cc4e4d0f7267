"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

Drives the port only (``src/repro_torch``; no JAX, nothing of ``repro``).
Phases, in order; any failure raises and the script exits non-zero:

1. env      — torch / CUDA versions, the card's name and power limit; TF32 off.
2. build    — nvcc builds every CUDA kernel of the port from ``csrc/``
              (``masked_adam``, ``flash_attention`` and ``ssd_chunk``, in
              parallel).
3. kernel   — the masked-Adam kernel (one CUDA kernel for both TPU
              functions) against its plain PyTorch version on the card.  One
              client (``masked_adam_``) at the ResNet-8 shape (1,576 rows)
              and at 2**20 rows, several masks, steps 1 and 1000; frozen
              blocks must be bit-exact and the client-stacked launch must
              equal per-client launches.  Then the cohort launch
              (``MaskedAdamCohort``) at ResNet-8 x 8 clients: FNU, each
              FedPart group, a nested plan, every client valid and one
              padded, steps 1 and 1000; bit-identical, untrained blocks and
              the padded client bit-exact to their inputs, and equal to 8
              one-client launches.  Times (CUDA events, cycling through
              enough buffer sets that each launch finds its data outside the
              50 MB L2, as the main path does after a forward and backward),
              host microseconds per wrapper call, the bound and
              ``torch.optim.Adam(fused=True)`` on the same buffers as a
              yardstick.
4. fedpart  — the main path: sync FedPart on ResNet-8 at the paper's width,
              8 iid clients x 500 samples, batch 64, one local epoch, FedAvg,
              ``fused_adam=True``: 12 FedPart rounds, then the matched FNU
              baseline's 12.  Every local step must launch the kernel once
              (a one-client cohort).  Then fused-vs-unfused cross-checks for
              FedAvg / FedProx / MOON.
   fedpart_vmap — the same runs through ``engine="vmap"``: one cohort
              launch per bucket and local step (168, against ``fedpart``'s
              1,344 one-client launches); seconds per round beside
              ``fedpart``'s; one FNU round under ``torch.profiler``; then
              vmap-vs-sequential cross-checks for FedAvg / FedProx / MOON
              and a nested plan at ``adam_eps=1e-3``, with deterministic
              cuDNN convolutions.
5. profile  — one FNU round under ``torch.profiler``: device time by kernel.
6. flash    — ``flash_attention`` against its plain PyTorch version on the
              card: the reference's seven cases, four ragged ones and three
              ragged ones at the bf16 body's two widths (DP 64, DP 128 with
              D 112), f32 and bf16, and TinyLlama's prefill layer (B 4, H 32,
              Hkv 4, S 4,096, D 64, bf16) causal and with a 1,024 window, and
              Zamba2's shared-attention layer (B 4, H 32, Hkv 32, S 4,096,
              D 112, bf16, causal), each element and each output row held
              to its limit.  The bf16 body's ``HGMMA`` / ``UTMALDG`` / ``HMMA``
              instruction counts from ``cuobjdump -sass``.  Times (CUDA
              events) at both layers, achieved TFLOP/s, their bounds, and
              ``F.scaled_dot_product_attention`` as a yardstick.
7. serve    — the serving path: ``serve_session`` on tinyllama-1.1b at full
              width, bf16, random weights from a seed, B 4 x 4,096 prompt,
              32 greedy tokens; every prefill layer must launch the flash
              kernel once (22).  One prefill under ``torch.profiler``.  Then
              the f32 cross-check: kernel vs plain prefill attention at full
              width (B 4 x 512, 4 tokens, TF32 off), every step's logits
              within 1e-3 and the same tokens.
8. ssd      — ``ssd_chunk`` against its plain PyTorch version (``ssd_ref``)
              on the card, f32 and bf16: the reference's four cases,
              Zamba2's smoke shape, a ragged chunk, head-broadcast
              (stride-0) q and k, odd N / P / chunk (the kernel's
              element-wise loads), a slow decay over 8 chunks, steep decays
              (chunk totals near -128, and below -160: the per-element
              decay), Zamba2's widths without the broadcast, and Zamba2's
              layer (B 4, H 112, S 4,096, N 64, P 64, chunk 128); each
              element, each output row and the final state held to its
              limit, and the body that ran each case named.  The bf16
              ``wgmma`` body's ``HGMMA`` / ``UTMALDG`` / ``HMMA`` counts from
              ``cuobjdump -sass``.  Times (CUDA events) at Zamba2's layer:
              the CUDA-core and ``wgmma`` bodies in turns, against the bound
              and the tensor FLOPs the ``wgmma`` body issues, the plain
              chunked form and ``ssd_ref``; registers and spills from nvcc.
9. serve_hybrid — ``serve_session`` on zamba2-7b at full width, bf16,
              random weights from a seed, B 4 x 4,096 prompt, 32 greedy
              tokens: every Mamba2 prefill scan must launch the SSD kernel
              once (81), all through its ``wgmma`` body, and every
              shared-attention prefill the flash kernel once (13).  One prefill under ``torch.profiler``.  Then the
              f32 cross-check at full width (B 4 x 512, 4 tokens, TF32
              off): kernel path against plain PyTorch, every step's logits
              within 1e-3 and the same tokens.

The line before the last carries ``nvidia-smi``'s name and power limit, the
one before it the ``kernels`` JSON; the last line is the ``ok`` JSON.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, non-tensor-core (data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense (data sheet)
ADAM_FLOPS_PER_ELEM = 12       # two EMAs, bias corrections, sqrt, eps, div, scale, sub
KERNEL_TOL = 1e-6              # kernel vs plain: same f32 ops, IEEE sqrt/div, no FMA
CROSS_TOL = 1e-4               # fused vs unfused, vmap vs sequential FL runs at adam_eps=1e-3
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 (data sheet)
# flash kernel vs plain, per element: |k - p| <= tol + tol*|p|; f32 is the
# reference's own kernel-vs-oracle tolerance, bf16 its test_dtypes tolerance
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# and per output row (b, h, query): ||k - p|| / ||p|| over D.  In bf16 the
# per-element limit is as large as a typical output at S 4,096 (|o| ~ 0.03),
# so it cannot see a dropped, doubled or stale K/V tile; the row limit can.
# A sound bf16 kernel differs from the plain version by P rounded to bf16
# (<= 2^-8 relative per probability, of random sign) and the output's bf16
# rounding (<= 2^-7 relative): a few 1e-3 of the row's norm.  One wrong tile
# of 64 among n kept keys moves a row by about sqrt(64 / n) of its norm
# (0.125 at n = 4,096).  f32 keeps its element tolerance.
FLASH_ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# tests/test_kernels_flash.py CASES: (b, h, hkv, sq, skv, d, causal, window)
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, True, 0),
    (2, 4, 2, 256, 256, 64, True, 0),
    (1, 4, 1, 128, 256, 128, True, 0),
    (1, 2, 2, 128, 384, 64, False, 0),
    (2, 2, 2, 256, 256, 32, True, 64),
    (1, 2, 2, 128, 128, 96, True, 0),
    (1, 2, 2, 192, 192, 64, True, 0),
]
# shapes those cases miss: lengths not multiples of the 64-row tiles,
# Sq != Skv both ways, GQA 3:1 with a window; every row keeps at least one key
FLASH_EXTRA = [
    (1, 4, 2, 100, 77, 32, False, 0),
    (2, 3, 1, 130, 130, 96, True, 50),
    (1, 2, 2, 70, 200, 128, True, 0),
    (1, 2, 1, 200, 70, 64, True, 0),
]
# ragged shapes at the bf16 body's two widths: DP 64 (D 32), DP 128 (D 112,
# D 128 with a window); every row keeps a key (test_torch_flash_attention HOPPER)
FLASH_HOPPER = [
    (2, 2, 2, 129, 257, 32, False, 0),
    (1, 2, 1, 200, 333, 112, True, 0),
    (1, 3, 1, 130, 255, 128, True, 40),
]
# tinyllama-1.1b's prefill attention at the serve phase's prompt: B 4, H 32,
# Hkv 4, S 4,096, D 64, bf16
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
TINYLLAMA_ATTN = (SERVE_BATCH, 32, 4, SERVE_PROMPT, SERVE_PROMPT, 64)
SERVE_CROSS_TOL = 1e-3         # f32 full width, kernel vs plain attention, TF32 off
# zamba2-7b's shared attention at the serve prompt: B 4, H 32, Hkv 32, S 4,096, D 112
ZAMBA2_ATTN = (SERVE_BATCH, 32, 32, SERVE_PROMPT, SERVE_PROMPT, 112)
# ssd_chunk kernel vs ssd_ref, per element: |k - p| <= tol·(1 + |p|); f32 is the
# reference's own kernel-vs-oracle tolerance (tests/test_kernels_ssd.py)
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# per output row (b, t, h) over P: ||k - p|| / ||p||.  Both sides compute in
# f32; in bf16 each rounds y once (2^-8 relative at most), so a sound kernel
# sits near 2^-9 on average and below 2^-8; one wrong chunk moves its rows by
# their whole size.  The final state is f32 on both sides for either dtype.
SSD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_STATE_TOL = 2e-4
# (b, h, s, n, p, chunk, broadcast q/k over heads, decay: "ref" as the
# reference's tests draw it, "slow" in (-0.01, 0), "steep" in (-1.1, -0.9)
# (chunk totals near -128: the factorised decay's rebased range), "steeper"
# in (-2.2, -1.8) (totals below -160: the per-element decay))
SSD_CASES = [
    (1, 2, 128, 128, 128, 64, False, "ref"),    # tests/test_kernels_ssd.py CASES
    (2, 3, 256, 128, 128, 128, False, "ref"),
    (1, 2, 128, 64, 128, 32, False, "ref"),
    (1, 1, 256, 128, 64, 128, False, "ref"),
    (2, 8, 32, 16, 32, 16, False, "ref"),       # zamba2-7b smoke: N 16, P 32, chunk 16
    (2, 8, 12, 16, 32, 16, False, "ref"),       # ragged: S 12 < chunk 16
    (2, 8, 64, 16, 32, 16, True, "ref"),        # stride-0 q / k, as mamba2_forward
    (1, 3, 52, 5, 7, 13, False, "ref"),         # odd N, P, chunk: element-wise staging
    (1, 4, 1024, 64, 64, 128, True, "slow"),    # log_a in (-0.01, 0) over 8 chunks
    (1, 4, 512, 64, 64, 128, True, "steep"),
    (1, 4, 512, 64, 64, 128, True, "steeper"),
    (2, 8, 1024, 64, 64, 128, False, "ref"),    # zamba2's widths, q / k per head
]
# zamba2-7b's Mamba2 layer at the serve prompt, as the main path calls it
ZAMBA2_SSD = (SERVE_BATCH, 112, SERVE_PROMPT, 64, 64, 128, True, "ref")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds per call of ``fn`` (enqueue only), ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def cold_sets(make, set_bytes: int) -> list:
    """Enough results of ``make()`` (each a fresh set of buffers of
    ``set_bytes``) that cycling through them moves more than twice the L2
    between two uses of one set: a timed launch then finds its data in HBM,
    as the main path's optimizer step does after a forward and backward."""
    return [make() for _ in range(max(1, math.ceil(2 * L2_BYTES / set_bytes)))]


def cycling(fns):
    """One callable that calls ``fns`` in turn, one per call."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def cuda_ms(fn, reps: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean CUDA-event time of ``reps`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_env() -> str:
    from repro_torch.device import strict_fp32
    smi = nvidia_smi()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")
    strict_fp32()
    log(f"[env] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        log(f"[build] {name}: {os.path.relpath(path, ROOT)}")
        log_path = path.with_suffix(".log")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if line.strip():
                    log(f"[build]   {line.strip()}")


def _bound_ms(trained_elems: int, blocks: int) -> tuple[float, str]:
    """Least time for one masked step: p, g, m, v read and p, m, v written
    once per trained element, the mask read once, against the op count."""
    nbytes = 7 * 4 * trained_elems + 4 * blocks + 16
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ADAM_FLOPS_PER_ELEM * trained_elems / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check_masked_adam(rows: int, masks: dict, gen: torch.Generator,
                       br: int = 8) -> float:
    """Kernel vs plain version for every mask and step 1 / 1000; returns the
    max abs error over trained blocks.  Frozen blocks must be bit-exact."""
    from repro_torch.kernels.masked_adam import masked_adam_, masked_adam_ref, ops
    dev = "cuda"
    p = torch.randn(rows, 128, device=dev, generator=gen)
    g = torch.randn(rows, 128, device=dev, generator=gen)
    m = torch.randn(rows, 128, device=dev, generator=gen) * 0.1
    v = torch.rand(rows, 128, device=dev, generator=gen) * 0.01
    worst = 0.0
    for mname, mask in masks.items():
        for step in (1, 1000):
            sc = ops.adam_scalars(torch.tensor(step, device=dev), 1e-3, 0.9,
                                  0.999, 1e-8)
            ref = masked_adam_ref(p, g, m, v, mask, sc, block_rows=br)
            out = (p.clone(), m.clone(), v.clone())
            masked_adam_(out[0], g, out[1], out[2], mask, sc, block_rows=br)
            torch.cuda.synchronize()
            trained = torch.repeat_interleave(mask != 0, br)
            for name, k, r, x in zip("pmv", out, ref, (p, m, v)):
                if not torch.equal(k[~trained], x[~trained]):
                    raise AssertionError(f"masked_adam {rows} rows mask "
                                         f"{mname} step {step}: frozen {name} changed")
                if trained.any():
                    err = (k[trained] - r[trained]).abs()
                    lim = KERNEL_TOL * torch.clamp(r[trained].abs(), min=1.0)
                    if bool((err > lim).any()):
                        raise AssertionError(
                            f"masked_adam {rows} rows mask {mname} step {step}: "
                            f"{name} max err {float(err.max()):.3g} > tolerance")
                    worst = max(worst, float(err.max()))
    return worst


def _check_stacked(rows: int, gen: torch.Generator, clients: int = 4,
                   br: int = 8) -> None:
    from repro_torch.kernels.masked_adam import masked_adam_, masked_adam_stacked_, ops
    dev = "cuda"
    p = torch.randn(clients, rows, 128, device=dev, generator=gen)
    g = torch.randn(clients, rows, 128, device=dev, generator=gen)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    bm = torch.randint(0, 2, (clients, rows // br), device=dev, generator=gen,
                       dtype=torch.int32)
    sc = ops.adam_scalars(torch.tensor(3, device=dev), 1e-3, 0.9, 0.999, 1e-8)
    per = [(p[c].clone(), m[c].clone(), v[c].clone()) for c in range(clients)]
    for c, (pc, mc, vc) in enumerate(per):
        masked_adam_(pc, g[c], mc, vc, bm[c], sc, block_rows=br)
    masked_adam_stacked_(p, g, m, v, bm, sc, block_rows=br)
    torch.cuda.synchronize()
    for c, (pc, mc, vc) in enumerate(per):
        if not (torch.equal(p[c], pc) and torch.equal(m[c], mc) and torch.equal(v[c], vc)):
            raise AssertionError(f"masked_adam_stacked client {c} != per-client launch")


def _time_masked_adam(rows: int, mask: torch.Tensor, reps: int,
                      library: bool, br: int = 8) -> dict:
    """The one-client launch as the sequential engine makes it (a cohort of
    one, validated once, then ``step``), on cold buffers (``cold_sets``):
    CUDA-event ms, host microseconds per call, the plain version, the bound
    and, with ``library``, ``torch.optim.Adam(fused=True)``."""
    from repro_torch.kernels.masked_adam import MaskedAdamCohort, masked_adam_ref, ops
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(rows)
    sc = ops.adam_scalars(torch.tensor([1], device=dev), 1e-3, 0.9, 0.999, 1e-8)
    gid = torch.arange(mask.numel(), dtype=torch.int32, device=dev)

    def make():
        p = torch.randn(1, rows, 128, device=dev, generator=gen)
        g = torch.randn(1, rows, 128, device=dev, generator=gen)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        return p, g, m, v, MaskedAdamCohort(p, m, v, gid, mask[None],
                                            np.ones((1, 1), np.int32), sc, block_rows=br)

    sets = cold_sets(make, 16 * rows * 128)
    trained = int(mask.sum()) * br * 128
    bound, bound_by = _bound_ms(trained, mask.numel())
    out = {"rows": rows, "trained_blocks": int(mask.sum()), "blocks": mask.numel(),
           "buffer_sets": len(sets),
           "ms": cuda_ms(cycling([lambda s=s: s[4].step(0, s[1]) for s in sets]), reps),
           "host_us": host_us(lambda: sets[0][4].step(0, sets[0][1]), min(2000, 20 * reps)),
           "plain_ms": cuda_ms(cycling([lambda s=s: masked_adam_ref(
               s[0][0], s[1][0], s[2][0], s[3][0], mask, sc[0], block_rows=br)
               for s in sets]), reps),
           "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    if library:
        opts = []
        for p, g, *_ in sets:
            param = torch.nn.Parameter(p[0].clone())
            param.grad = g[0]
            opts.append(torch.optim.Adam([param], lr=1e-3, betas=(0.9, 0.999),
                                         eps=1e-8, fused=True))
        out["library_ms"] = cuda_ms(cycling([o.step for o in opts]), reps)
        del opts
    del sets
    torch.cuda.empty_cache()
    return out


COHORT_CLIENTS = 8     # the FL phases' cohort: 8 clients in one bucket


def _cohort_bound_ms(trained_elems: int, clients: int, blocks: int,
                     groups: int) -> tuple[float, str]:
    """Least time for one cohort launch: p, g, m, v read and p, m, v written
    once per trained element, the group ids, group mask, valid column and
    scalar row read once, against the op count."""
    nbytes = 7 * 4 * trained_elems + 4 * (blocks + clients * groups + clients) + 16
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ADAM_FLOPS_PER_ELEM * trained_elems / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _cohort_cases(part, clients: int) -> dict:
    """(clients, groups) bool group masks: FNU, each FedPart group, and a
    nested plan (tiers 0.3 / 0.6 / 1.0) on a partial round of group 8."""
    from repro_torch.core.schedule import PlanAssigner, RoundSpec
    g = part.num_groups
    cases = {"fnu": np.ones((clients, g), bool)}
    for k in range(g):
        cases[f"group{k}"] = np.broadcast_to(np.arange(g) == k, (clients, g))
    plan = PlanAssigner(num_groups=g, kind="nested", capacity_tiers=(0.3, 0.6, 1.0),
                        seed=0).assign(RoundSpec(1, "partial", 0, 8), list(range(clients)))
    if plan is None or len({tuple(r) for r in plan}) < 2:
        raise AssertionError(f"the nested plan case is not mixed: {plan}")
    cases["nested"] = plan
    return cases


def _check_cohort(params, part, gen, clients: int = COHORT_CLIENTS,
                  br: int = 8) -> float:
    """Cohort launch vs its plain version at ResNet-8 x ``clients``: every
    case of ``_cohort_cases``, every client valid and client 5 padded, steps
    1 and 1000.  Bit-identical, untrained blocks and the padded client
    bit-exact to their inputs; the nested case also equals one one-client
    launch per client.  Returns the max abs error (0 when bit-identical)."""
    from repro_torch.core.aggregation import is_local_stat
    from repro_torch.kernels.masked_adam import (MaskedAdamCohort, masked_adam_,
                                                 masked_adam_cohort_ref, ops)
    dev = "cuda"
    rows = ops.packed_rows(params, br)
    gid = torch.as_tensor(ops.block_group_ids(params, part, br, exclude=is_local_stat),
                          device=dev)
    p = torch.randn(clients, rows, 128, device=dev, generator=gen)
    g = torch.randn(clients, rows, 128, device=dev, generator=gen)
    m = torch.randn(clients, rows, 128, device=dev, generator=gen) * 0.1
    v = torch.rand(clients, rows, 128, device=dev, generator=gen) * 0.01
    padded = np.ones(clients, np.float32)
    padded[5] = 0.0
    worst = 0.0
    for cname, rows_mask in _cohort_cases(part, clients).items():
        gmask = torch.as_tensor(np.ascontiguousarray(rows_mask), dtype=torch.int32,
                                device=dev)
        for vname, valid in (("all valid", np.ones(clients, np.float32)),
                             ("client 5 padded", padded)):
            for step in (1, 1000):
                table = ops.adam_scalars(torch.tensor([step], device=dev), 1e-3, 0.9,
                                         0.999, 1e-8)
                valid_t = torch.as_tensor(valid, dtype=torch.int32, device=dev)
                ref = masked_adam_cohort_ref(p, g, m, v, gid, gmask, valid_t, table[0],
                                             block_rows=br)
                out = (p.clone(), m.clone(), v.clone())
                MaskedAdamCohort(*out, gid, gmask, valid[:, None], table,
                                 block_rows=br).step(0, g)
                torch.cuda.synchronize()
                trained = torch.repeat_interleave(
                    ops.plan_block_mask(gid, gmask, valid_t) != 0, br, dim=1)
                what = f"cohort {cname}, {vname}, step {step}"
                for name, k, r, x in zip("pmv", out, ref, (p, m, v)):
                    worst = max(worst, float((k - r).abs().max()))
                    if not torch.equal(k, r):
                        raise AssertionError(f"{what}: {name} differs from the plain "
                                             f"version (max {float((k - r).abs().max()):.3g})")
                    if not torch.equal(k[~trained], x[~trained]):
                        raise AssertionError(f"{what}: an untrained {name} block changed")
                if cname == "nested" and vname == "client 5 padded" and step == 1000:
                    bm = ops.plan_block_mask(gid, gmask, valid_t)
                    for c in range(clients):
                        single = (p[c].clone(), m[c].clone(), v[c].clone())
                        masked_adam_(single[0], g[c], single[1], single[2], bm[c],
                                     table[0], block_rows=br)
                        if not all(torch.equal(a, b[c]) for a, b in zip(single, out)):
                            raise AssertionError(f"{what}: client {c} != its "
                                                 "one-client launch")
    del p, g, m, v
    torch.cuda.empty_cache()
    return worst


def _time_cohort(params, part, reps: int = 200, clients: int = COHORT_CLIENTS,
                 br: int = 8) -> dict:
    """The cohort launch at ResNet-8 x ``clients``, FNU, every client valid,
    on cold buffers (``cold_sets``; ``l2_hot_ms`` is one set back to back):
    CUDA-event ms, host microseconds per wrapper call, the plain version,
    the bound and ``torch.optim.Adam(fused=True)`` on the same bytes."""
    from repro_torch.core.aggregation import is_local_stat
    from repro_torch.kernels.masked_adam import (MaskedAdamCohort,
                                                 masked_adam_cohort_ref, ops)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = ops.packed_rows(params, br)
    gids = ops.block_group_ids(params, part, br, exclude=is_local_stat)
    gid = torch.as_tensor(gids, device=dev)
    gmask = torch.ones(clients, part.num_groups, dtype=torch.int32, device=dev)
    table = ops.adam_scalars(torch.tensor([1], device=dev), 1e-3, 0.9, 0.999, 1e-8)
    valid = torch.ones(clients, dtype=torch.int32, device=dev)

    def make():
        p = torch.randn(clients, rows, 128, device=dev, generator=gen)
        g = torch.randn(clients, rows, 128, device=dev, generator=gen)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        return p, g, m, v, MaskedAdamCohort(p, m, v, gid, gmask,
                                            np.ones((clients, 1), np.float32), table,
                                            block_rows=br)

    sets = cold_sets(make, 16 * clients * rows * 128)
    trained = clients * int((gids >= 0).sum()) * br * 128
    bound, bound_by = _cohort_bound_ms(trained, clients, len(gids), part.num_groups)
    first = sets[0]
    out = {"clients": clients, "rows": rows, "trained_elems": trained,
           "buffer_sets": len(sets),
           "ms": cuda_ms(cycling([lambda s=s: s[4].step(0, s[1]) for s in sets]), reps),
           "l2_hot_ms": cuda_ms(lambda: first[4].step(0, first[1]), reps),
           "host_us": host_us(lambda: first[4].step(0, first[1])),
           "plain_ms": cuda_ms(cycling([lambda s=s: masked_adam_cohort_ref(
               s[0], s[1], s[2], s[3], gid, gmask, valid, table[0], block_rows=br)
               for s in sets]), 20),
           "bound_ms": bound, "bound_by": bound_by}
    opts = []
    for p, g, *_ in sets:
        param = torch.nn.Parameter(p.clone())
        param.grad = g
        opts.append(torch.optim.Adam([param], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                     fused=True))
    out["library_ms"] = cuda_ms(cycling([o.step for o in opts]), reps)
    del opts, sets, first
    torch.cuda.empty_cache()
    return out


def phase_kernel() -> tuple[dict, dict]:
    from repro_torch.core.aggregation import is_local_stat
    from repro_torch.fl.tasks import resnet_task
    from repro_torch.kernels.masked_adam import ops
    dev = "cuda"
    br = 8
    adapter = resnet_task("resnet8", num_classes=20)
    params = adapter.init(torch.Generator().manual_seed(0))
    part = adapter.partition(params)
    rows = ops.packed_rows(params, br)
    nb = rows // br
    gen = torch.Generator(device=dev).manual_seed(7)

    def as_mask(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    fnu = as_mask(ops.block_mask_for_group(params, part, tuple(range(part.num_groups)),
                                           br, exclude=is_local_stat))
    group8 = as_mask(ops.block_mask_for_group(params, part, 8, br,
                                              exclude=is_local_stat))
    rmasks = {"all-on": torch.ones(nb, dtype=torch.int32, device=dev),
              "all-off": torch.zeros(nb, dtype=torch.int32, device=dev),
              "random-half": torch.randint(0, 2, (nb,), device=dev, generator=gen,
                                           dtype=torch.int32),
              "resnet8-fnu": fnu, "resnet8-group8": group8}
    worst = _check_masked_adam(rows, rmasks, gen, br)
    big = 2 ** 20
    bnb = big // br
    bmasks = {"all-on": torch.ones(bnb, dtype=torch.int32, device=dev),
              "all-off": torch.zeros(bnb, dtype=torch.int32, device=dev),
              "random-half": torch.randint(0, 2, (bnb,), device=dev, generator=gen,
                                           dtype=torch.int32)}
    worst = max(worst, _check_masked_adam(big, bmasks, gen, br))
    _check_stacked(rows, gen)
    torch.cuda.empty_cache()
    log(f"[kernel] masked_adam (one-client cohort launches) vs plain: max abs err "
        f"{worst:.3g} on trained blocks (tolerance {KERNEL_TOL:g} x max(1,|ref|)); "
        f"frozen blocks bit-exact; stacked == per-client launches (rows {rows} and {big})")

    timings = {
        "resnet8 all-on": _time_masked_adam(rows, rmasks["all-on"], 200, True),
        "resnet8 fnu": _time_masked_adam(rows, fnu, 200, False),
        "resnet8 group8": _time_masked_adam(rows, group8, 200, False),
        "2^20 all-on": _time_masked_adam(big, bmasks["all-on"], 10, True),
        "2^20 random-half": _time_masked_adam(big, bmasks["random-half"], 10, False),
    }
    for name, t in timings.items():
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.6f}"
        log(f"[kernel] masked_adam {name}: rows {t['rows']} trained blocks "
            f"{t['trained_blocks']}/{t['blocks']} kernel {t['ms']:.6f} ms "
            f"({t['buffer_sets']} buffer sets in turn) plain {t['plain_ms']:.6f} ms "
            f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}) "
            f"torch.optim.Adam(fused=True) {lib} ms; host {t['host_us']:.3f} us per "
            f"step call")
    main = timings["resnet8 all-on"]
    adam = {"name": "masked_adam", "route": "cuda",
            "source": "src/repro_torch/csrc/masked_adam.cu",
            "replaces": "src/repro/kernels/masked_adam/kernel.py:66",
            "launches": None, "max_abs_err": worst,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "clients": 1, "host_us": main["host_us"]}

    cworst = _check_cohort(params, part, gen)
    log(f"[kernel] masked_adam_cohort vs plain at ResNet-8 x {COHORT_CLIENTS}: "
        f"FNU, {part.num_groups} FedPart groups and a nested plan, all valid and one "
        f"padded client, steps 1 and 1000: bit-identical (max abs err {cworst:.3g}); "
        f"untrained blocks and the padded client bit-exact; equal to "
        f"{COHORT_CLIENTS} one-client launches")
    t = _time_cohort(params, part)
    log(f"[kernel] masked_adam_cohort resnet8 x {t['clients']} fnu: rows {t['rows']} "
        f"trained elements {t['trained_elems']} kernel {t['ms']:.6f} ms "
        f"({t['buffer_sets']} buffer sets in turn; one set back to back, L2-hot: "
        f"{t['l2_hot_ms']:.6f} ms) plain {t['plain_ms']:.6f} ms bound "
        f"{t['bound_ms']:.6f} ms ({t['bound_by']}; {100 * t['bound_ms'] / t['ms']:.2f}% "
        f"of it) torch.optim.Adam(fused=True) {t['library_ms']:.6f} ms; host "
        f"{t['host_us']:.3f} us per step call (one client: {main['host_us']:.3f} us)")
    cohort = {"name": "masked_adam_cohort", "route": "cuda",
              "source": "src/repro_torch/csrc/masked_adam.cu",
              "replaces": "src/repro/kernels/masked_adam/kernel.py:115",
              "launches": None, "max_abs_err": cworst,
              "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
              "bound_by": t["bound_by"], "library_ms": t["library_ms"],
              "clients": t["clients"], "host_us": t["host_us"],
              "l2_hot_ms": t["l2_hot_ms"]}
    return adam, cohort


def _flash_qkv(b, h, hkv, sq, skv, d, dtype, gen):
    """q, k, v in the model's (B, S, heads, D) layout, as the main path
    hands them to ``ops.flash_attention``."""
    dev = "cuda"
    q = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, skv, hkv, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, skv, hkv, d, device=dev, generator=gen).to(dtype)
    return q, k, v


def _flash_check(case, dtype, gen) -> tuple[float, float]:
    """Kernel vs plain version on one case; returns the max abs error and
    the max row error over the row's norm."""
    from repro_torch.kernels.flash_attention import ops
    b, h, hkv, sq, skv, d, causal, window = case
    q, k, v = _flash_qkv(b, h, hkv, sq, skv, d, dtype, gen)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    ref = ops.attention_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if out.dtype != dtype or out.shape != q.shape:
        raise AssertionError(f"flash {case} {dtype}: out {out.dtype} {tuple(out.shape)}")
    diff = out.float() - ref.float()
    err = diff.abs()
    tol = FLASH_TOL[dtype]
    bad = err > tol + tol * ref.float().abs()
    row = float((diff.norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)).max())
    if not bool(torch.isfinite(out.float()).all()) or bool(bad.any()):
        raise AssertionError(f"flash {case} {dtype}: max abs err {float(err.max()):.3g} "
                             f"beyond tolerance {tol:g} (abs + rel)")
    if not row <= FLASH_ROW_TOL[dtype]:
        raise AssertionError(f"flash {case} {dtype}: max row error {row:.3g} beyond "
                             f"{FLASH_ROW_TOL[dtype]:g} of the row's norm")
    return float(err.max()), row


def _flash_flops(b, h, sq, skv, d, causal, window) -> int:
    """4·D FLOPs per kept (query, key) pair and head, counted from the
    call's masks."""
    qi = torch.arange(sq)[:, None]
    kj = torch.arange(skv)[None, :]
    keep = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        keep &= kj <= qi
    if window > 0:
        keep &= kj > qi - window
    return 4 * b * h * d * int(keep.sum())


def _flash_bound_ms(b, h, hkv, sq, skv, d, causal, window, dtype) -> tuple[float, str]:
    """Least time for one call: its FLOPs (``_flash_flops``) against q, k,
    v read and o written once."""
    flops = _flash_flops(b, h, sq, skv, d, causal, window)
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * b * d * (2 * h * sq + 2 * hkv * skv)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _flash_layer(name: str, shape, gen) -> dict:
    """Times one bf16 causal layer in the model's (B, S, H, D) layout: the
    kernel, the plain version, ``F.scaled_dot_product_attention`` as the
    library yardstick, and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    b, h, hkv, s, _, d = shape
    q, k, v = _flash_qkv(b, h, hkv, s, s, d, torch.bfloat16, gen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = {"ms": cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), 5),
           "plain_ms": cuda_ms(lambda: ops.attention_reference(q, k, v, causal=True),
                               2, 3)}
    torch.cuda.empty_cache()
    out["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    out["bound_ms"], out["bound_by"] = _flash_bound_ms(b, h, hkv, s, s, d, True, 0,
                                                       torch.bfloat16)
    out["tflops"] = _flash_flops(b, h, s, s, d, True, 0) / out["ms"] / 1e9
    log(f"[flash] {name} layer B{b} H{h} Hkv{hkv} S{s} D{d} bf16 causal: "
        f"kernel {out['ms']:.6f} ms plain {out['plain_ms']:.6f} ms "
        f"F.scaled_dot_product_attention {out['library_ms']:.6f} ms bound "
        f"{out['bound_ms']:.6f} ms ({out['bound_by']}; "
        f"{100 * out['bound_ms'] / out['ms']:.2f}% of it, {out['tflops']:.1f} TFLOP/s "
        f"achieved)")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def phase_flash() -> dict:
    """The flash kernel against its plain version: the reference's seven
    cases and four ragged ones in f32 and bf16, TinyLlama's prefill layer
    causal and with a 1,024 window, Zamba2's shared-attention layer (D 112);
    then times at both layers (kernel, plain version,
    ``F.scaled_dot_product_attention`` as the library yardstick)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        errs = [_flash_check(c, dtype, gen) for c in FLASH_CASES + FLASH_EXTRA]
        err, row = max(e for e, _ in errs), max(r for _, r in errs)
        worst = max(worst, err)
        log(f"[flash] 7 reference cases + {len(FLASH_EXTRA)} ragged {str(dtype)[6:]}: "
            f"max abs err {err:.3g} (tolerance {FLASH_TOL[dtype]:g} abs + rel), "
            f"max row err {row:.3g} of the row's norm (limit {FLASH_ROW_TOL[dtype]:g})")
        errs = [_flash_check(c, dtype, gen) for c in FLASH_HOPPER]
        err, row = max(e for e, _ in errs), max(r for _, r in errs)
        worst = max(worst, err)
        log(f"[flash] {len(FLASH_HOPPER)} ragged at D 32 / 112 / 128 {str(dtype)[6:]}: "
            f"max abs err {err:.3g}, max row err {row:.3g} (same limits)")
    sass = _sass("flash_attention", "flash_fwd_bf16")
    if sass is None:
        log("[flash] SASS of the bf16 body: not available (no cuobjdump)")
    for fn, counts in (sass or {}).items():
        log(f"[flash] SASS of {fn}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    layers = [("tinyllama", TINYLLAMA_ATTN, 0), ("tinyllama", TINYLLAMA_ATTN, 1024),
              ("zamba2", ZAMBA2_ATTN, 0)]
    for name, (b, h, hkv, s, _, d), window in layers:
        err, row = _flash_check((b, h, hkv, s, s, d, True, window), torch.bfloat16, gen)
        worst = max(worst, err)
        log(f"[flash] {name} layer B{b} H{h} Hkv{hkv} S{s} D{d} bf16 causal "
            f"window {window}: max abs err {err:.3g} (tolerance "
            f"{FLASH_TOL[torch.bfloat16]:g} abs + rel), max row err {row:.3g} of the "
            f"row's norm (limit {FLASH_ROW_TOL[torch.bfloat16]:g})")
        torch.cuda.empty_cache()

    main = _flash_layer("tinyllama", TINYLLAMA_ATTN, gen)
    zamba2 = _flash_layer("zamba2", ZAMBA2_ATTN, gen)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
            "launches": None, "max_abs_err": worst, **main,
            "zamba2_layer": zamba2}


# ---------------------------------------------------------------------------
# ssd_chunk
# ---------------------------------------------------------------------------

def _ssd_inputs(case, dtype, gen):
    """q, k (B, S, H, N) and v (B, S, H, P) of ``dtype``, log_a (B, S, H)
    f32, in the model's layout; q and k as ``expand`` views over heads
    (stride 0) where the case says so, as ``mamba2_forward`` passes them.
    Decays as the reference's tests draw them (-|N(0,1)|·0.2), or uniform
    in the case's range (``SSD_CASES``)."""
    b, h, s, n, p, _, bcast, decay = case
    dev = "cuda"
    hq = 1 if bcast else h
    q = (torch.randn(b, s, hq, n, device=dev, generator=gen) * 0.3).to(dtype)
    k = (torch.randn(b, s, hq, n, device=dev, generator=gen) * 0.3).to(dtype)
    if bcast:
        q, k = q.expand(b, s, h, n), k.expand(b, s, h, n)
    v = torch.randn(b, s, h, p, device=dev, generator=gen).to(dtype)
    if decay == "ref":
        la = -0.2 * torch.randn(b, s, h, device=dev, generator=gen).abs()
    else:
        lo, hi = {"slow": (0.0, 0.01), "steep": (0.9, 1.1), "steeper": (1.8, 2.2)}[decay]
        la = -(lo + (hi - lo) * torch.rand(b, s, h, device=dev, generator=gen))
    return q, k, v, la


def _ssd_check(case, dtype, gen) -> tuple[float, float, float, str]:
    """Kernel vs plain version on one case; returns the max abs error of y,
    the max row error over the row's norm, the state's max abs error and
    the body that ran."""
    from repro_torch.kernels.ssd_chunk import ops, ssd_chunk_kernel
    q, k, v, la = _ssd_inputs(case, dtype, gen)
    before = dict(ssd_chunk_kernel.launches_by_body)
    y, st = ops.ssd_scan(q, k, v, la, chunk=case[5])
    body, = [b for b, n in ssd_chunk_kernel.launches_by_body.items() if n != before[b]]
    y_ref, st_ref = ops.ssd_reference(q, k, v, la)
    torch.cuda.synchronize()
    if y.dtype != dtype or y.shape != v.shape or st.dtype != torch.float32:
        raise AssertionError(f"ssd {case} {dtype}: y {y.dtype} {tuple(y.shape)}, "
                             f"state {st.dtype}")
    diff = y.float() - y_ref.float()
    err = diff.abs()
    tol = SSD_TOL[dtype]
    row = float((diff.norm(dim=-1) / y_ref.float().norm(dim=-1).clamp_min(1e-30)).max())
    st_err = (st - st_ref).abs()
    if not bool(torch.isfinite(y.float()).all()) or bool(
            (err > tol * (1 + y_ref.float().abs())).any()):
        raise AssertionError(f"ssd {case} {dtype}: max abs err {float(err.max()):.3g} "
                             f"beyond tolerance {tol:g}·(1 + |ref|)")
    if not row <= SSD_ROW_TOL[dtype]:
        raise AssertionError(f"ssd {case} {dtype}: max row error {row:.3g} beyond "
                             f"{SSD_ROW_TOL[dtype]:g} of the row's norm")
    if not bool(torch.isfinite(st).all()) or bool(
            (st_err > SSD_STATE_TOL * (1 + st_ref.abs())).any()):
        raise AssertionError(f"ssd {case} {dtype}: state max abs err "
                             f"{float(st_err.max()):.3g} beyond {SSD_STATE_TOL:g}·(1 + |ref|)")
    return float(err.max()), row, float(st_err.max()), body


def _ssd_bound_ms(case, dtype) -> tuple[float, str]:
    """Least time for one scan: the full Q x Q products per chunk, as the
    TPU kernel computes them (2·Q²·N + 2·Q²·P + 4·Q·N·P FLOPs), against q,
    k, v, log_a read and y, the state written once (q and k once per head
    that stores them: once per batch row when broadcast)."""
    b, h, s, n, p, chunk, bcast, _ = case
    chunk = min(chunk, s)
    flops = b * h * (s // chunk) * (2 * chunk * chunk * (n + p) + 4 * chunk * n * p)
    elem = torch.finfo(dtype).bits // 8
    qk_heads = 1 if bcast else h
    nbytes = elem * (2 * b * s * qk_heads * n + 2 * b * s * h * p) \
        + 4 * b * s * h + 4 * b * h * n * p
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _ssd_wgmma_flops(case) -> int:
    """Tensor FLOPs the ``wgmma`` body issues for one scan: per chunk and
    head, at its padded 64-wide N and P over a 128-row box, Q·Kᵀ for 64 x 64
    and 64 x 128 (row, key) blocks, W·V over the same blocks twice (bf16 hi
    and lo), q·S_prev twice (128 x 64 x 64) and k_decᵀ·V twice (64 x 128 x
    64)."""
    b, h, s, _, _, chunk, _, _ = case
    blocks = 64 * 64 + 64 * 128
    per_chunk = 2 * blocks * 64 * 3 + 2 * 2 * 128 * 64 * 64 + 2 * 2 * 64 * 128 * 64
    return b * h * (s // min(chunk, s)) * per_chunk


def _sass(lib: str, fn_filter: str) -> dict | None:
    """Counts of Hopper's ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load)
    instructions, and of ``HMMA`` (mma.sync), in each function of the built
    library ``lib`` whose name holds ``fn_filter``, from its SASS; None when
    ``cuobjdump`` is absent."""
    from repro_torch.kernels import build
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.access(tool, os.X_OK):
        return None
    sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if fn_filter in name else None
            if fn:
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}
        elif fn and "*/" in line:   # "/*0050*/  @P0 UTMALDG.4D [UR8], [UR4] ;"
            toks = [t for t in line.split("*/", 1)[1].split() if not t.startswith("@")]
            op = toks[0].split(".")[0] if toks else ""
            if op in counts[fn]:
                counts[fn][op] += 1
    return counts


def phase_ssd() -> dict:
    """The SSD chunk kernel against its plain version (``ssd_ref``) on every
    case in f32 and bf16, naming the body that ran; then, at Zamba2's layer,
    the CUDA-core and ``wgmma`` bodies timed in turns (old, new, new, old),
    the plain chunked form (``impl="plain"``), ``ssd_ref``, the bound."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.models.ssm import chunked_decay_attention
    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in SSD_CASES + [ZAMBA2_SSD]:
            err, row, st, body = _ssd_check(case, dtype, gen)
            worst = max(worst, err)
            b, h, s, n, p, chunk, bcast, decay = case
            log(f"[ssd] B{b} H{h} S{s} N{n} P{p} chunk {min(chunk, s)}"
                f"{' stride-0 q/k' if bcast else ''}"
                f"{'' if decay == 'ref' else f' {decay} decay'} {str(dtype)[6:]}, {body} "
                f"body: max abs err {err:.3g} (tolerance {SSD_TOL[dtype]:g}·(1+|ref|)), max "
                f"row err {row:.3g} (limit {SSD_ROW_TOL[dtype]:g}), state max abs err "
                f"{st:.3g} (limit {SSD_STATE_TOL:g}·(1+|ref|))")
        torch.cuda.empty_cache()
    sass = _sass("ssd_chunk", "ssd_wgmma")
    if sass is None:
        log("[ssd] SASS of the wgmma body: not available (no cuobjdump)")
    for fn, counts in (sass or {}).items():
        log(f"[ssd] SASS of {fn}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))

    b, h, s, n, p, chunk, _, _ = ZAMBA2_SSD
    q, k, v, la = _ssd_inputs(ZAMBA2_SSD, torch.bfloat16, gen)
    y = torch.empty_like(v)
    views = [t.transpose(1, 2) for t in (q, k, v, la)]
    turns = [(body, cuda_ms(lambda: sk.ssd_chunk_body(*views, body=body, chunk=chunk,
                                                      out=y.transpose(1, 2)), 5))
             for body in ("cuda_core", "wgmma", "wgmma", "cuda_core")]
    ms = statistics.mean(t for body, t in turns if body == "wgmma")
    old_ms = statistics.mean(t for body, t in turns if body == "cuda_core")
    chunked_ms = cuda_ms(lambda: chunked_decay_attention(q, k, v, la, chunk), 1)
    torch.cuda.empty_cache()
    ref_ms = cuda_ms(lambda: ops.ssd_reference(q, k, v, la), 1)
    bound, bound_by = _ssd_bound_ms(ZAMBA2_SSD, torch.bfloat16)
    flops = _ssd_wgmma_flops(ZAMBA2_SSD)
    log(f"[ssd] zamba2 layer B{b} H{h} S{s} N{n} P{p} chunk {chunk} bf16, stride-0 q/k, "
        f"in turns: " + ", ".join(f"{body} {t:.6f} ms" for body, t in turns))
    log(f"[ssd] zamba2 layer: wgmma body {ms:.6f} ms (cuda_core body {old_ms:.6f} ms, "
        f"{old_ms / ms:.2f}x), bound {bound:.6f} ms ({bound_by}; {100 * bound / ms:.2f}% "
        f"of it); the wgmma body issues {flops:.4g} tensor FLOPs ({flops / ms / 1e9:.1f} "
        f"TFLOP/s, {flops / BF16_FLOPS_PER_S * 1e3:.6f} ms at the bf16 peak); plain "
        f"chunked form {chunked_ms:.6f} ms, ssd_ref {ref_ms:.6f} ms; no single PyTorch "
        f"call computes this scan")
    for line in build.library_path("ssd_chunk").with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ssd] nvcc: {line.strip()}")
    del q, k, v, la, y, views
    torch.cuda.empty_cache()
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk/kernel.py:84",
            "launches": None, "max_abs_err": worst, "ms": ms, "plain_ms": ref_ms,
            "plain_chunked_ms": chunked_ms, "cuda_core_ms": old_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None}


def _vision_setup(clients: int = 8, per_client: int = 500):
    from repro_torch.data import (VisionDatasetSpec, balanced_eval_set,
                                  build_clients, iid_partition, make_vision_dataset)
    spec = VisionDatasetSpec()
    x, y = make_vision_dataset(spec, clients * per_client, seed=0)
    xe, ye = make_vision_dataset(spec, 2000, seed=9)
    return (build_clients(x, y, iid_partition(len(y), clients, seed=0)),
            balanced_eval_set(xe, ye, per_class=20))


def phase_fedpart() -> tuple[int, dict]:
    from repro_torch.core.schedule import FedPartSchedule, matched_fnu
    from repro_torch.data.pipeline import batch_plan
    from repro_torch.fl import AlgoConfig, FLRunConfig, resnet_task, run_federated
    from repro_torch.fl.population import client_round_seed
    from repro_torch.kernels.masked_adam import MaskedAdamCohort
    from repro_torch.tree import tree_leaves

    clients, eval_set = _vision_setup()
    adapter = resnet_task("resnet8", num_classes=20)
    sched = FedPartSchedule(num_groups=10, warmup_rounds=2, rounds_per_layer=1,
                            cycles=1)
    runs = {"fedpart": sched.rounds(), "fnu": matched_fnu(sched).rounds()}
    cfg = FLRunConfig(local_epochs=1, batch_size=64, algo=AlgoConfig("fedavg"),
                      fused_adam=True, device="cuda")
    expected = sum(len(batch_plan(len(clients[c]), cfg.batch_size,
                                  cfg.local_epochs,
                                  client_round_seed(cfg.seed, s.index, c)))
                   for rounds in runs.values() for s in rounds
                   for c in range(len(clients)))

    MaskedAdamCohort.launches = 0
    results = {name: run_federated(adapter, clients, eval_set, rounds, cfg)
               for name, rounds in runs.items()}
    torch.cuda.synchronize()
    launches = MaskedAdamCohort.launches

    medians = _report_fl_runs("fedpart", adapter, results, cfg)
    log(f"[fedpart] masked_adam launches {launches} (one client each), local steps "
        f"{expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != local steps {expected}")

    # Cross-checks: fused == unfused on the card (warm-up FNU + one partial).
    short = FedPartSchedule(num_groups=10, warmup_rounds=1, rounds_per_layer=1,
                            cycles=1).rounds()[:2]
    for algo in ("fedavg", "fedprox", "moon"):
        out = {}
        for fused in (True, False):
            c = FLRunConfig(local_epochs=1, batch_size=64, adam_eps=1e-3,
                            algo=AlgoConfig(algo), fused_adam=fused, device="cuda")
            out[fused] = run_federated(adapter, clients, eval_set, short, c)
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(tree_leaves(out[True].params), tree_leaves(out[False].params)))
        ldiff = max(abs(a["loss"] - b["loss"]) for a, b in
                    zip(out[True].history, out[False].history))
        log(f"[fedpart] cross-check {algo}: fused vs unfused max param diff "
            f"{diff:.3g}, max loss diff {ldiff:.3g} (tolerance {CROSS_TOL:g}), "
            f"losses {[round(h['loss'], 6) for h in out[True].history]}")
        if not (diff <= CROSS_TOL and ldiff <= CROSS_TOL):
            raise AssertionError(f"{algo}: fused and unfused disagree")
        if not all(math.isfinite(h["loss"]) for h in out[True].history):
            raise AssertionError(f"{algo}: non-finite fused loss")
    return launches, medians


def _report_fl_runs(tag: str, adapter, results: dict, cfg) -> dict:
    """Log every round and each run's books; check losses finite and
    falling and params finite; returns each run's median seconds per round."""
    from repro_torch.tree import tree_leaves, tree_paths
    medians = {}
    for name, res in results.items():
        for h in res.history:
            log(f"[{tag}] {name} round {h['round']:2d} [{h['phase']}:{h['group']:3d}] "
                f"loss {h['loss']:.6f} acc {h['acc']:.4f} {h['seconds']:.4f} s")
        secs = [h["seconds"] for h in res.history]
        medians[name] = statistics.median(secs)
        log(f"[{tag}] {name}: comm {res.comm_total_bytes} B (FNU "
            f"{res.comm_fnu_bytes} B) comp {res.comp_total_flops:.0f} (FNU "
            f"{res.comp_fnu_flops:.0f}) seconds/round mean {statistics.mean(secs):.4f} "
            f"median {medians[name]:.4f} first {secs[0]:.4f} "
            f"final acc {res.final_acc:.4f}")
        losses = [h["loss"] for h in res.history]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: loss did not fall ({losses[0]} -> {losses[-1]})")
        init = adapter.init(torch.Generator().manual_seed(cfg.seed))
        for (path, a), b in zip(tree_paths(res.params), tree_leaves(init)):
            if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: param {'/'.join(path)} bad")
    return medians


def phase_fedpart_vmap(seq_medians: dict) -> int:
    """``fedpart``'s runs through ``engine="vmap"``: one cohort launch per
    bucket and local step, not one per client; seconds per round beside
    the sequential engine's; one FNU round under the profiler; then vmap vs
    sequential on the card for FedAvg / FedProx / MOON and a nested plan.
    Returns the counted run's cohort launches."""
    from repro_torch.core.schedule import FedPartSchedule, RoundSpec, matched_fnu
    from repro_torch.data.pipeline import bucket_plans
    from repro_torch.fl import AlgoConfig, FLRunConfig, resnet_task, run_federated
    from repro_torch.fl.population import client_round_seed
    from repro_torch.kernels.masked_adam import MaskedAdamCohort
    from repro_torch.tree import tree_leaves

    clients, eval_set = _vision_setup()
    adapter = resnet_task("resnet8", num_classes=20)
    sched = FedPartSchedule(num_groups=10, warmup_rounds=2, rounds_per_layer=1,
                            cycles=1)
    runs = {"fedpart": sched.rounds(), "fnu": matched_fnu(sched).rounds()}
    cfg = FLRunConfig(local_epochs=1, batch_size=64, algo=AlgoConfig("fedavg"),
                      fused_adam=True, engine="vmap", device="cuda")
    # every bucket's longest client, over rounds (all 8 clients each round)
    expected = sum(
        plans.shape[1]
        for rounds in runs.values() for s in rounds
        for _, plans, _ in bucket_plans(
            clients, cfg.batch_size, cfg.local_epochs,
            [client_round_seed(cfg.seed, s.index, c) for c in range(len(clients))]))

    MaskedAdamCohort.launches = 0
    results = {name: run_federated(adapter, clients, eval_set, rounds, cfg)
               for name, rounds in runs.items()}
    torch.cuda.synchronize()
    launches = MaskedAdamCohort.launches

    medians = _report_fl_runs("fedpart_vmap", adapter, results, cfg)
    for name in runs:
        log(f"[fedpart_vmap] {name} median seconds per round: vmap "
            f"{medians[name]:.4f}, sequential {seq_medians[name]:.4f} "
            f"({seq_medians[name] / medians[name]:.2f}x)")
    log(f"[fedpart_vmap] masked_adam_cohort launches {launches} (sum over rounds and "
        f"buckets of the longest client's steps: {expected})")
    if launches != expected:
        raise AssertionError(f"cohort launches {launches} != {expected}")
    _profile_fl_round(cfg, "fedpart_vmap")

    # Cross-checks: vmap == sequential on the card (warm-up FNU + one partial;
    # the nested plan's partial round is on group 8, which tier 0.3 clamps),
    # at adam_eps=1e-3 as the fused-vs-unfused check.  The vmapped convs are
    # grouped cuDNN convs, not the per-client ones, so the two engines round
    # differently; cuDNN's deterministic algorithms make that difference the
    # same in every run (its default ones reduce weight gradients in a
    # different order from run to run).
    short = FedPartSchedule(num_groups=10, warmup_rounds=1, rounds_per_layer=1,
                            cycles=1).rounds()[:2]
    checks = [(a, short, {}) for a in ("fedavg", "fedprox", "moon")]
    checks.append(("fedavg", [short[0], RoundSpec(1, "partial", 0, 8)],
                   dict(plan="nested", capacity_tiers=(0.3, 0.6, 1.0))))
    for algo, rounds, kw in checks:
        out = {}
        for engine in ("vmap", "sequential"):
            c = FLRunConfig(local_epochs=1, batch_size=64, adam_eps=1e-3,
                            algo=AlgoConfig(algo), fused_adam=True, engine=engine,
                            device="cuda", **kw)
            torch.backends.cudnn.deterministic = True
            try:
                out[engine] = run_federated(adapter, clients, eval_set, rounds, c)
            finally:
                torch.backends.cudnn.deterministic = False
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(tree_leaves(out["vmap"].params), tree_leaves(out["sequential"].params)))
        ldiff = max(abs(a["loss"] - b["loss"]) for a, b in
                    zip(out["vmap"].history, out["sequential"].history))
        what = algo + (f" {kw['plan']} plan" if "plan" in kw else "")
        log(f"[fedpart_vmap] cross-check {what} (adam_eps 0.001): vmap vs "
            f"sequential max param diff {diff:.3g}, max loss diff {ldiff:.3g} "
            f"(tolerance {CROSS_TOL:g}), "
            f"losses {[round(h['loss'], 6) for h in out['vmap'].history]}")
        if not (diff <= CROSS_TOL and ldiff <= CROSS_TOL):
            raise AssertionError(f"{what}: vmap and sequential disagree")
        if not all(math.isfinite(h["loss"]) for h in out["vmap"].history):
            raise AssertionError(f"{what}: non-finite vmap loss")
    return launches


def phase_profile() -> None:
    """Device time by kernel over one main-path FNU round (warm)."""
    from repro_torch.fl import AlgoConfig, FLRunConfig
    _profile_fl_round(FLRunConfig(local_epochs=1, batch_size=64,
                                  algo=AlgoConfig("fedavg"), fused_adam=True,
                                  device="cuda"), "profile")


def _profile_fl_round(cfg, tag: str) -> None:
    """One warm FNU round of ``cfg`` under ``torch.profiler``: wall, device
    busy share, launches, the top kernels and the masked-Adam kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.schedule import FNUSchedule
    from repro_torch.fl import resnet_task, run_federated

    clients, eval_set = _vision_setup()
    adapter = resnet_task("resnet8", num_classes=20)
    rounds = FNUSchedule(total=1).rounds()
    run_federated(adapter, clients, eval_set, rounds, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_federated(adapter, clients, eval_set, rounds, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels)
    if dev_us <= 0:
        log(f"[{tag}] the profiler recorded no device time: not measured")
        return
    log(f"[{tag}] one FNU round, 8 clients x 7 steps ({cfg.engine} engine): wall "
        f"{wall_us / 1e3:.3f} ms (under the profiler), device busy {dev_us / 1e3:.3f} ms "
        f"({100 * dev_us / wall_us:.1f}%), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:100]}")
    for e in kernels:
        if "masked_adam" in e.key:
            log(f"[{tag}] {e.key[:40]} on the main path: {e.count} launches, "
                f"{e.self_device_time_total / e.count:.3f} us device time each, "
                f"{100 * e.self_device_time_total / dev_us:.2f}% of device busy")


def _serve_profile(cfg, params, prompt, tag: str = "serve") -> None:
    """Device time by kernel over one warm prefill (under torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps
    prefill = steps.make_prefill_step(cfg, impl="kernel")
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, cache = prefill(params, prompt)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    del logits, cache
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels)
    if dev_us <= 0:
        log(f"[{tag}] the profiler recorded no device time: not measured")
        return
    log(f"[{tag}] profile of one prefill: wall {wall_us / 1e3:.3f} ms (under the "
        f"profiler), device busy {dev_us / 1e3:.3f} ms ({100 * dev_us / wall_us:.1f}%), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"({100 * e.self_device_time_total / dev_us:5.1f}%) {e.count:5d}x {e.key[:90]}")


def phase_serve() -> int:
    """The serving path: ``serve_session`` on tinyllama-1.1b at full width,
    bf16, random weights from a seed, B 4 × 4,096 prompt, 32 tokens, every
    prefill attention through the flash kernel (22 launches, one per layer).
    Then the same config in f32 (TF32 off), prompt 512, 4 tokens: the kernel
    path against plain attention, every step's logits within
    ``SERVE_CROSS_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api
    from repro_torch.models.api import InputShape
    from repro_torch.tree import tree_leaves

    cfg = get_config("tinyllama-1.1b")
    b, s, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(gen, cfg, "cuda")
    prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    log(f"[serve] {cfg.name} full: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} {cfg.param_dtype}, {n_params} params")
    # warm-up at full width (cuBLAS handles, kernel loads), then the counted run
    serve_session(cfg, b, 256, 2, device="cuda", params=params, verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention_kernel.launches = 0
    res = serve_session(cfg, b, s, g, device="cuda", params=params, prompt=prompt,
                        verbose=False)
    torch.cuda.synchronize()
    launches = flash_attention_kernel.launches

    toks = res.tokens
    decoded = b * (g - 1)
    log(f"[serve] prefill {b}x{s}: {res.prefill_seconds:.6f} s "
        f"({b * s / res.prefill_seconds:.1f} prompt tokens/s); decode {g - 1} "
        f"steps x batch {b} = {decoded} tokens in {res.decode_seconds:.6f} s: "
        f"{decoded / res.decode_seconds:.3f} tokens/s, "
        f"{1e3 * res.decode_seconds / (g - 1):.3f} ms per step; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[serve] tokens[0] {toks[0].tolist()}")
    log(f"[serve] flash_attention launches {launches} (one per layer: {cfg.num_layers})")
    if launches != cfg.num_layers:
        raise AssertionError(f"flash launches {launches} != layers {cfg.num_layers}")
    if toks.shape != (b, g) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    for i, x in enumerate(res.logits):
        if x.shape != (b, 1, cfg.vocab_size) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"step {i}: logits {tuple(x.shape)} not finite")
    _serve_profile(cfg, params, prompt)
    del params, prompt, res
    torch.cuda.empty_cache()

    cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = api.init(gen, cfg32, "cuda")
    prompt = api.synth_batch(gen, cfg32, InputShape("serve", 512, b, "prefill"), "cuda")
    out = {impl: serve_session(cfg32, b, 512, 4, device="cuda", params=params,
                               prompt=prompt, impl=impl, verbose=False)
           for impl in ("kernel", "plain")}
    diffs = [float((k - p).abs().max())
             for k, p in zip(out["kernel"].logits, out["plain"].logits)]
    same = torch.equal(out["kernel"].tokens, out["plain"].tokens)
    log(f"[serve] f32 cross-check B{b} prompt 512 gen 4, kernel vs plain attention: "
        f"max abs logit diff per step {[f'{d:.3g}' for d in diffs]} (tolerance "
        f"{SERVE_CROSS_TOL:g}); tokens equal: {same}")
    if max(diffs) > SERVE_CROSS_TOL or not same:
        raise AssertionError("f32 serve: kernel and plain attention disagree")
    del params, prompt, out
    torch.cuda.empty_cache()
    return launches


def phase_serve_hybrid() -> tuple[int, int, dict]:
    """The hybrid serving path: ``serve_session`` on zamba2-7b at full
    width, bf16, random weights from a seed, B 4 × 4,096 prompt, 32 tokens;
    every Mamba2 prefill scan through the SSD kernel (81 launches) and every
    shared-attention prefill through the flash kernel (13).  Then the same
    config in f32 (TF32 off), prompt 512, 4 tokens: the kernel path against
    plain PyTorch, every step's logits within ``SERVE_CROSS_TOL``.  Returns
    the counted run's (ssd_chunk, flash_attention) launches and the SSD
    launches by body."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api, transformer
    from repro_torch.models.api import InputShape
    from repro_torch.tree import tree_leaves

    cfg = get_config("zamba2-7b")
    n_chunks, tail = transformer.hybrid_layout(cfg)
    mamba_layers = n_chunks * cfg.attn_every + tail
    b, s, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(gen, cfg, "cuda")
    prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    log(f"[serve_hybrid] {cfg.name} full: {n_chunks} chunks of (shared attention, "
        f"{cfg.attn_every} Mamba2) + {tail} tail Mamba2, d_model {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} (head dim {cfg.resolved_head_dim}) d_ff "
        f"{cfg.d_ff} SSM N {cfg.ssm_state_dim} P {cfg.ssm_head_dim} chunk "
        f"{cfg.ssm_chunk} vocab {cfg.vocab_size} {cfg.param_dtype}, {n_params} params")
    # warm-up at full width (cuBLAS handles, kernel loads), then the counted run
    serve_session(cfg, b, 256, 2, device="cuda", params=params, verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ssd_chunk_kernel.launches = 0
    ssd_chunk_kernel.launches_by_body = dict.fromkeys(ssd_chunk_kernel.launches_by_body, 0)
    flash_attention_kernel.launches = 0
    res = serve_session(cfg, b, s, g, device="cuda", params=params, prompt=prompt,
                        verbose=False)
    torch.cuda.synchronize()
    ssd_n, flash_n = ssd_chunk_kernel.launches, flash_attention_kernel.launches
    by_body = dict(ssd_chunk_kernel.launches_by_body)

    toks = res.tokens
    decoded = b * (g - 1)
    log(f"[serve_hybrid] prefill {b}x{s}: {res.prefill_seconds:.6f} s "
        f"({b * s / res.prefill_seconds:.1f} prompt tokens/s); decode {g - 1} "
        f"steps x batch {b} = {decoded} tokens in {res.decode_seconds:.6f} s: "
        f"{decoded / res.decode_seconds:.3f} tokens/s, "
        f"{1e3 * res.decode_seconds / (g - 1):.3f} ms per step; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[serve_hybrid] tokens[0] {toks[0].tolist()}")
    log(f"[serve_hybrid] ssd_chunk launches {ssd_n} (one per Mamba2 layer: "
        f"{mamba_layers}; by body {by_body}), flash_attention launches {flash_n} (one per "
        f"shared-attention application: {n_chunks})")
    if ssd_n != mamba_layers or flash_n != n_chunks:
        raise AssertionError(f"launches: ssd {ssd_n} != {mamba_layers} or flash "
                             f"{flash_n} != {n_chunks}")
    if by_body["wgmma"] != mamba_layers:
        raise AssertionError(f"ssd launches by body {by_body}: not all {mamba_layers} "
                             f"through the wgmma body")
    if toks.shape != (b, g) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    for i, x in enumerate(res.logits):
        if x.shape != (b, 1, cfg.vocab_size) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"step {i}: logits {tuple(x.shape)} not finite")
    _serve_profile(cfg, params, prompt, tag="serve_hybrid")
    del params, prompt, res
    torch.cuda.empty_cache()

    cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = api.init(gen, cfg32, "cuda")
    prompt = api.synth_batch(gen, cfg32, InputShape("serve", 512, b, "prefill"), "cuda")
    out = {impl: serve_session(cfg32, b, 512, 4, device="cuda", params=params,
                               prompt=prompt, impl=impl, verbose=False)
           for impl in ("kernel", "plain")}
    diffs = [float((k - p).abs().max())
             for k, p in zip(out["kernel"].logits, out["plain"].logits)]
    scale = max(float(x.abs().max()) for x in out["plain"].logits)
    same = torch.equal(out["kernel"].tokens, out["plain"].tokens)
    log(f"[serve_hybrid] f32 cross-check B{b} prompt 512 gen 4, full depth and width, "
        f"kernel vs plain (SSD scans and prefill attention): max abs logit diff per "
        f"step {[f'{d:.3g}' for d in diffs]} (tolerance {SERVE_CROSS_TOL:g}; max "
        f"|logit| {scale:.3g}); tokens equal: {same}")
    if max(diffs) > SERVE_CROSS_TOL or not same:
        raise AssertionError("f32 hybrid serve: kernel and plain paths disagree")
    del params, prompt, out
    torch.cuda.empty_cache()
    return ssd_n, flash_n, by_body


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs one "
              "card", file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    adam, cohort = phase_kernel()
    adam["launches"], seq_medians = phase_fedpart()
    cohort["launches"] = phase_fedpart_vmap(seq_medians)
    phase_profile()
    flash = phase_flash()
    flash_serve = phase_serve()
    ssd = phase_ssd()
    ssd["launches"], flash_hybrid, ssd["launches_by_body"] = phase_serve_hybrid()
    flash["launches"] = flash_serve + flash_hybrid
    flash["launches_by_path"] = {"serve": flash_serve, "serve_hybrid": flash_hybrid}
    print(json.dumps({"kernels": [adam, cohort, flash, ssd]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
