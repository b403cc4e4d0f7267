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
   kernel_nlp — the same kernel at the nlp transformer's full-width layout
              (85,312 rows): one client (FNU, embed, one block, head masks)
              and a cohort of 8 clients plus a padded ninth (those groups
              and a nested plan), steps 1 and 1000, bit-identical to the
              plain version; times of the FNU, embed-group and block-group
              cohorts of 8 and of one client FNU on cold buffers (the FNU
              cohort moves 2.446 GB), against the bound and
              ``torch.optim.Adam(fused=True)``.
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
   fedpart_shard — the same runs through ``engine="shard_map"`` at world
              size 1, over a one-rank NCCL group the phase initialises:
              cohort launches equal the recomputed bucket-steps (168);
              seconds per round (median, first) beside ``fedpart_vmap``'s;
              the engine's all-reduce calls and bytes per round, one call of
              the packed transmitted rows x 512 B (716,800 B at FNU, 1,400
              rows; groups 0-9 24-304 rows; BN moments never), their
              FedPart-to-FNU ratio beside the comm book's; then shard_map vs
              vmap within 1e-4 for FedAvg, MOON and a nested plan at
              ``adam_eps=1e-3`` with deterministic cuDNN; the two engines'
              warm FNU rounds in turns; one FNU round of each under
              ``torch.profiler``.
   nlp      — the paper's second task at the reference's full width
              (``nlp-transformer``: 4 blocks, d 256, 8 heads, d_ff 1,024,
              vocab 30,000, 256 positions; 10,902,020 parameters, 6 groups,
              85,312 packed rows) on synthetic AG-News-like text, 8 iid
              clients x 500 samples of 256 tokens, batch 64, one local
              epoch, FedAvg, ``fused_adam=True``: FedPart over the 6 groups
              and its matched FNU baseline, on the sequential engine (one
              one-client launch per local step) and then the vmap engine
              (one cohort launch per bucket and step); seconds per round on
              both; one FNU round of each under ``torch.profiler``; then
              cross-checks at ``adam_eps=1e-3``: fused vs unfused, and vmap
              vs sequential for FedAvg / FedProx / MOON and a nested plan.
   compress — int8, onebit and topk (0.01) with error feedback on the nlp
              task at full width (warm-up FNU, embed and first-block rounds,
              vmap engine, fused): the compression epilogue's device time
              per round; the booked bytes equal the encoded bytes of the
              transmitted leaves; decode(encode) equals the
              quantize-dequantize values bit for bit on the card; int8's
              vmap run within 1e-4 of the sequential one.
   async    — the event-driven async runtime: ResNet-8 at the paper's width
              on the vmap engine, ``fused_adam=True``, over a streamed
              population of a million clients (200-500 samples each,
              Dirichlet 0.5 labels), 12 FedPart versions of FedBuff (K 4,
              staleness exponent 0.5), cohorts of 8 drawn by availability
              under a diurnal trace with speed spread, jitter and dropout,
              two cohorts in flight (one slot on one card: the second
              queues), the adaptive controller.  Per merge host seconds,
              loss and accuracy; the timeline's counts, virtual time,
              occupancy and control decisions; the shard cache; host
              seconds split into dispatch / launch / resolve / merge /
              eval.  Checks:
              cohort launches equal the bucket-steps of every launched
              cohort, recomputed from the timeline's dispatch events; the
              degenerate configuration (8 clients, full participation,
              perfect fleet, K 0, exponent 0) within 1e-4 of the sync run
              with equal books; an int8 FedBuff run on the nlp transformer
              at full width whose delivered updates booked the encoded
              bytes of their groups' leaves.  A profiled 2-merge run gives
              the device busy share.
5. profile  — one FNU round under ``torch.profiler``: device time by kernel.
6. flash    — ``flash_attention`` against its plain PyTorch version on the
              card: the reference's seven cases, four ragged ones and six
              ragged ones at the bf16 body's three widths (DP 64, DP 128 with
              D 112, DP 256 with D 256 and D 192), f32 and bf16, and
              TinyLlama's prefill layer (B 4, H 32, Hkv 4, S 4,096, D 64,
              bf16) causal and with a 1,024 window, Zamba2's
              shared-attention layer (B 4, H 32, Hkv 32, S 4,096, D 112,
              bf16, causal), Gemma's (B 4, H 8, Hkv 1, S 4,096, D 256,
              bf16, causal) and Llama-4-Maverick's (B 4, H 40, Hkv 8: a GQA
              group of 5, S 4,096, D 128, bf16, causal), each element and
              each output row held to its limit.  The bf16 bodies'
              ``HGMMA`` / ``UTMALDG`` / ``HMMA`` instruction counts from
              ``cuobjdump -sass``, registers and spills from nvcc.  Times
              (CUDA events) at the four layers, achieved TFLOP/s, their
              bounds, and ``F.scaled_dot_product_attention`` as a
              yardstick.
7. serve    — the serving path: ``serve_session`` on tinyllama-1.1b at full
              width, bf16, random weights from a seed, B 4 x 4,096 prompt,
              32 greedy tokens; every prefill layer must launch the flash
              kernel once (22).  One prefill under ``torch.profiler``.  Then
              the f32 cross-check: kernel vs plain prefill attention at full
              width (B 4 x 512, 4 tokens, TF32 off), every step's logits
              within 1e-3 and the same tokens.
   serve_dense — the same for gemma-2b (18 flash launches per prefill, all
              at D 256; GeGLU, MQA, tied 256,000-row embedding),
              llama3.2-1b (16 at D 64) and glm4-9b (40 at D 128); each f32
              cross-check at full width, glm4-9b's cut to 4 of its 40
              layers (its f32 weights are 37.6 GB).
8. ssd      — ``ssd_chunk`` against its plain PyTorch version (``ssd_ref``)
              on the card, f32 and bf16: the reference's four cases,
              Zamba2's smoke shape, a ragged chunk, head-broadcast
              (stride-0) q and k, odd N / P / chunk (the kernel's
              element-wise loads), a slow decay over 8 chunks, steep decays
              (chunk totals near -128, and below -160: the per-element
              decay), Zamba2's widths without the broadcast, the mLSTM's N =
              P = 192 and N 192 with P 1 (q / k per head; the reference's
              decays and the mLSTM's own: log_sigmoid forgets, chunk sums
              near -100, v scaled by the clipped input gate), ragged P (130,
              200: a narrow last P tile), Zamba2's layer (B 4, H 112, S
              4,096, N 64, P 64, chunk 128) and the xLSTM layer's two scans
              (B 4, H 8, S 4,096, N 192, P 192 and P 1, chunk 128); each
              element, each output row and the final state held to its
              limit, and the body that ran each case named.  The bf16
              ``wgmma`` body's ``HGMMA`` / ``UTMALDG`` / ``HMMA`` counts and
              both bodies' ``STL`` / ``LDL`` from ``cuobjdump -sass``.
              Times (CUDA events) at Zamba2's layer: the CUDA-core and
              ``wgmma`` bodies in turns, against the bound and the tensor
              FLOPs the ``wgmma`` body issues, the plain chunked form and
              ``ssd_ref``; at the xLSTM layer each scan's kernel time, bound,
              plain chunked form and ``ssd_ref``; registers and spills from
              nvcc.
9. serve_hybrid — ``serve_session`` on zamba2-7b at full width, bf16,
              random weights from a seed, B 4 x 4,096 prompt, 32 greedy
              tokens: every Mamba2 prefill scan must launch the SSD kernel
              once (81), all through its ``wgmma`` body, and every
              shared-attention prefill the flash kernel once (13).  One prefill under ``torch.profiler``.  Then the
              f32 cross-check at full width (B 4 x 512, 4 tokens, TF32
              off): kernel path against plain PyTorch, every step's logits
              within 1e-3 and the same tokens.
   serve_xlstm — ``serve_session`` on xlstm-125m at full width (6 mLSTM /
              sLSTM pairs, d_model 768, mLSTM 8 heads of N = P = 192), bf16,
              random weights from a seed, B 4 x 4,096 prompt, 32 greedy
              tokens: both scans of every mLSTM prefill (values, P 192, and
              the normaliser, P 1) must launch the SSD kernel (12), all
              through its CUDA-core body.  One prefill of B 4 x 512 under
              ``torch.profiler`` (at 4,096 its ~615,000 launches take
              minutes to tabulate), with the sLSTM's eager loop over time as
              a share of the wall and busy time.  Then the f32 cross-check at
              full width (B 4 x 512, 4 tokens, TF32 off), kernel path
              against plain PyTorch, every step's logits within 1e-3 and the
              same tokens.  Not held against the reference, whose mLSTM
              returns NaN at chunk 128 (``ROADMAP.md`` Queue 3).
   serve_moe — ``serve_session`` on llama4-maverick-400b-a17b at full width
              (d_model 5,120, 40 / 8 heads of 128, 128 experts of 8,192
              top-1 plus a shared one, vocab 202,048), cut to 1 of its 48
              layers (one MoE layer is 32.6 GB in bf16), bf16, random
              weights from a seed, B 4 x 4,096 prompt, 32 greedy tokens:
              the prefill attention must launch the flash kernel once, at D
              128; the expert products are cuBLAS batched GEMMs.  One
              prefill under ``torch.profiler``, split by the MoE layer's
              labelled parts (router, dispatch, experts, combine, shared
              expert).  Then the f32 cross-check at full width, cut to 2
              layers and 8 experts (B 4 x 512, 4 tokens, TF32 off): kernel
              vs plain attention, every step's logits within 1e-3, the same
              tokens and no router choice differing.
   serve_mla — ``serve_session`` on deepseek-v3-671b at full width (MLA,
              256 experts of 2,048 top-8 plus a shared one), cut to its 3
              dense layers and the first MoE layer of 61, plus the MTP
              module, bf16, B 1 x 4,096 prompt (MLA's f32 scores are 8.6 GB
              a copy), 32 tokens: no flash and no SSD launch (MLA has no
              kernel, in the reference or here).  One prefill under
              ``torch.profiler``.  On the same weights one FedPart step on
              the ``mtp`` group (B 1 x 1,024 with labels): the loss and its
              MTP term finite and positive, every leaf outside ``mtp/*``
              bit for bit unchanged (word sums), seconds and peak memory.
              Then f32 decode consistency at full width, cut to 2 layers
              (1 dense), 16 experts and capacity factor 8.0 (no token
              dropped): the decode logits at position 512 equal the
              forward's over 513 tokens within 2e-4 (abs + rel).
10. fedtrain_llm — ``launch.fedtrain``'s default, mesh-trainer path on
              tinyllama-1.1b at full width (bf16; 24 groups: embed, 22
              blocks, final_norm|head): ``--full-size --batch 4 --seq 512
              --steps-per-round 4 --warmup 1 --rounds 8`` (one FNU round,
              then embed and blocks 0-5), then ``FedPartMeshTrainer.run_round``
              for blocks/21, final_norm|head and a warm FNU round; seconds
              and peak memory per round, ``tx`` against the group's elements
              counted from the tree; one profiled partial round.  Then in
              f32 (TF32 off, ``adam_eps=1e-3``) from one set of params and one
              batch: an FNU step and a partial step on blocks/7 give the same
              loss, the group's leaves within 1e-6, every other leaf of the
              partial step bit for bit its start, and the partial step's
              backward pruned: the profiler's GEMM count is the head's input
              gradient, 14 blocks without weight GEMMs, one full block and
              nothing for blocks 0-6.
11. fedtrain_sim — ``fedtrain --sim-clients 8 --rounds 12 --batch 32
              --fused-adam`` on the vmap engine (cohort launches == bucket-steps
              recomputed from the data) and the sequential engine (one-client
              launches == client-steps); equal books; the same setup's 12
              rounds at ``adam_eps=1e-3`` (deterministic cuDNN) across the
              engines within 2.66e-4 of the largest |param|, twice the
              reference's own drift.
12. train_cli — ``launch.train --task resnet8 --strategy fedpart --clients 8
              --warmup 1 --rl 1 --bridge 0`` with ``--out`` and
              ``--checkpoint-dir``: the JSON has every key, the checkpoint
              loads back onto the card bit for bit equal to
              ``result.params``, a bf16 tree round-trips word for word.
13. dlg      — ``benchmarks/table9_privacy.py``'s quick setting through the
              port's ``fl.privacy``: ResNet-8 at 16 x 16, 250 iterations,
              the full observation and group 0's; PSNR and ms per iteration;
              fails on NaN.

Each phase logs its host seconds (``[time]``).  The line before the last
carries ``nvidia-smi``'s name and power limit, the
one before it the ``kernels`` JSON (the masked-Adam entries count their
launches by path: ``fedpart``, ``nlp`` and ``fedtrain_sim`` for the
one-client launches, ``fedpart_vmap``, ``fedpart_shard``, ``nlp``,
``compress``, ``async`` and ``fedtrain_sim`` for the cohort launches; the
SSD entry by path, ``serve_hybrid`` and ``serve_xlstm``, and by body within
each, with the xLSTM layer's two scans beside Zamba2's layer; the flash
entry by path, ``serve_moe`` among them, with Zamba2's, Gemma's and
Llama-4's layers beside TinyLlama's); the last line is the ``ok`` JSON.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
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
# ragged shapes at the bf16 body's three widths: DP 64 (D 32), DP 128 (D 112,
# D 128 with a window), DP 256 with its 64-key tiles (D 256 MQA, D 192 with a
# window: a column block wholly past D); every row keeps a key
# (test_torch_flash_attention HOPPER)
FLASH_HOPPER = [
    (2, 2, 2, 129, 257, 32, False, 0),
    (1, 2, 1, 200, 333, 112, True, 0),
    (1, 3, 1, 130, 255, 128, True, 40),
    (1, 2, 1, 129, 257, 256, False, 0),
    (2, 8, 1, 130, 255, 256, True, 0),
    (1, 3, 1, 200, 333, 192, True, 40),
]
# tinyllama-1.1b's prefill attention at the serve phase's prompt: B 4, H 32,
# Hkv 4, S 4,096, D 64, bf16
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
TINYLLAMA_ATTN = (SERVE_BATCH, 32, 4, SERVE_PROMPT, SERVE_PROMPT, 64)
SERVE_CROSS_TOL = 1e-3         # f32 full width, kernel vs plain attention, TF32 off
# zamba2-7b's shared attention at the serve prompt: B 4, H 32, Hkv 32, S 4,096, D 112
ZAMBA2_ATTN = (SERVE_BATCH, 32, 32, SERVE_PROMPT, SERVE_PROMPT, 112)
# gemma-2b's prefill attention at the serve prompt: B 4, H 8, Hkv 1 (MQA), S 4,096,
# D 256 (the bf16 body's DP 256)
GEMMA_ATTN = (SERVE_BATCH, 8, 1, SERVE_PROMPT, SERVE_PROMPT, 256)
# the dense decoders served beside tinyllama-1.1b (phase serve_dense): arch and
# the layers its f32 cross-check keeps (0: all; glm4-9b's 40 f32 layers with
# its f32 embedding and head are 37.6 GB, so it keeps 4 at full width)
SERVE_DENSE = [("gemma-2b", 0), ("llama3.2-1b", 0), ("glm4-9b", 4)]
# llama4-maverick-400b-a17b's prefill attention at the serve prompt: B 4, H 40,
# Hkv 8 (a GQA group of 5, the first odd one of a served config), S 4,096, D 128
LLAMA4_ATTN = (SERVE_BATCH, 40, 8, SERVE_PROMPT, SERVE_PROMPT, 128)
# The MoE decoders at full width, cut in depth to what one card holds.
# Llama-4: one MoE layer is 16.30 G params (32.6 GB in bf16) and the embedding
# and head 2.07 G; beside them a prefill of B 4 x 4,096 holds 13.2 GB of f32
# logits and the head's 4.1 GB f32 copy, so a second layer would pass 80 GB.
SERVE_MOE_LAYERS = 1
# its f32 cross-check: one full layer's f32 weights are 65 GB
SERVE_MOE_F32 = {"num_layers": 2, "num_experts": 8}
# DeepSeek-V3: the 3 dense layers and the first MoE layer, plus the MTP module
# (15.8 G params, 31.6 GB in bf16); B 1, since MLA's f32 (B, 128, S, S)
# scores are 8.6 GB a copy at B 1 x 4,096
SERVE_MLA_LAYERS = 4
SERVE_MLA_BATCH = 1
MTP_STEP_SEQ = 1024            # the MTP head's FedPart step: B 1 x 1,024 with labels
# its f32 decode-consistency check: 2 layers (1 dense, 1 MoE), 16 experts and
# capacity factor 8.0, so that neither the forward nor a decode step drops a
# token (capacity differs between T = B x S and T = B); the MTP head, which
# decode never reads, left out
SERVE_MLA_F32 = {"num_layers": 2, "first_dense_layers": 1, "num_experts": 16,
                 "capacity_factor": 8.0, "mtp_depth": 0}
DECODE_TOL = 2e-4              # decode vs forward, tests/test_decode_consistency.py
# ssd_chunk kernel vs ssd_ref, per element: |k - p| <= tol·(1 + |p|); f32 is the
# reference's own kernel-vs-oracle tolerance (tests/test_kernels_ssd.py)
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# per output row (b, t, h) over P: ||k - p|| / ||p||.  Both sides compute in
# f32; in bf16 each rounds y once (2^-8 relative at most), so a sound kernel
# sits near 2^-9 on average and below 2^-8; one wrong chunk moves its rows by
# their whole size.  At P 1 (the mLSTM's normaliser) a row over P is one
# element, a sum of terms of either sign that can cancel to ~0, where f32's
# reordered sums differ by more than 1e-4 of it: there the row is (b, t)
# over H x P.  The final state is f32 on both sides for either dtype.
SSD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# With v scaled by gates up to G (the "xlstm_gated" cases), the scan's terms
# are G times larger and so is any f32 summation's rounding: each element is
# held to SSD_TOL·(G + |p|), which is SSD_TOL·(1 + |p|) at G = 1.  Measured
# at xLSTM's layer (S 4,096, gates ~80x, f32): on an H100 the kernel's
# sequential FMAs 9.61e-4 abs from ssd_ref, where an O(1) limit allows
# 2e-4·(1 + |p|); on a CPU the plain chunked form 5.1e-4, and with gates to
# ~1,700x 7.1e-3 off an f64 recurrence, ssd_ref itself 1.3e-3.
# The row and state limits are relative and stay as they are.
SSD_STATE_TOL = 2e-4
# (b, h, s, n, p, chunk, broadcast q/k over heads, decay: "ref" as the
# reference's tests draw it, "slow" in (-0.01, 0), "steep" in (-1.1, -0.9)
# (chunk totals near -128: the factorised decay's rebased range), "steeper"
# in (-2.2, -1.8) (totals below -160: the per-element decay), "xlstm" the
# mLSTM's forget gates, log_sigmoid of N(0, 1) (chunk totals near -100 at
# chunk 128), and "xlstm_gated" those with v scaled by the clipped input
# gate exp(min(N(0, 1), 8)) as the model's random init draws it (i_raw has
# std 1; ~60-80x at most over a layer))
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
    (2, 8, 512, 192, 192, 128, False, "ref"),   # the mLSTM's N = P = 192: three P tiles
    (2, 8, 512, 192, 1, 128, False, "ref"),     # its normaliser: N 192, P 1
    (1, 4, 256, 64, 130, 64, False, "ref"),     # ragged P: tiles of 64, 64, 2
    (1, 2, 256, 192, 200, 128, False, "ref"),   # N 192, ragged P 200: 64, 64, 64, 8
    (2, 8, 512, 192, 192, 128, False, "xlstm"),  # the mLSTM's own decays
    (2, 8, 512, 192, 1, 128, False, "xlstm"),
    (2, 8, 512, 192, 192, 128, False, "xlstm_gated"),   # and its gated values
    (2, 8, 512, 192, 1, 128, False, "xlstm_gated"),
]
# zamba2-7b's Mamba2 layer at the serve prompt, as the main path calls it
ZAMBA2_SSD = (SERVE_BATCH, 112, SERVE_PROMPT, 64, 64, 128, True, "ref")
# xlstm-125m's mLSTM layer at the serve prompt, as the main path calls it:
# the value scan (8 heads of N = P = 192) and the normaliser scan (P 1)
XLSTM_SSD = (SERVE_BATCH, 8, SERVE_PROMPT, 192, 192, 128, False, "xlstm_gated")
XLSTM_NORM_SSD = (SERVE_BATCH, 8, SERVE_PROMPT, 192, 1, 128, False, "xlstm_gated")
# serve_xlstm profiles a prefill of B 4 x 512: a full one (B 4 x 4,096) makes
# ~615,000 launches, 6 x 4,096 steps of the sLSTM's eager loop, whose
# profile took minutes to tabulate on the card
XLSTM_PROFILE_PROMPT = 512


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


def _cohort_cases(part, clients: int, nested_group: int = 8,
                  groups=None) -> dict:
    """(clients, groups) bool group masks: FNU, each FedPart group of
    ``groups`` (default: every group), and a nested plan (tiers 0.3 / 0.6 /
    1.0) on a partial round of ``nested_group``."""
    from repro_torch.core.schedule import PlanAssigner, RoundSpec
    g = part.num_groups
    cases = {"fnu": np.ones((clients, g), bool)}
    for k in (range(g) if groups is None else groups):
        cases[f"group{k}"] = np.broadcast_to(np.arange(g) == k, (clients, g))
    plan = PlanAssigner(num_groups=g, kind="nested", capacity_tiers=(0.3, 0.6, 1.0),
                        seed=0).assign(RoundSpec(1, "partial", 0, nested_group),
                                       list(range(clients)))
    if plan is None or len({tuple(r) for r in plan}) < 2:
        raise AssertionError(f"the nested plan case is not mixed: {plan}")
    cases["nested"] = plan
    return cases


def _check_cohort(params, part, gen, clients: int = COHORT_CLIENTS,
                  padded_client: int = 5, cases: dict | None = None,
                  br: int = 8) -> float:
    """Cohort launch vs its plain version on ``params``' layout x
    ``clients``: every case of ``cases`` (default ``_cohort_cases``), every
    client valid and ``padded_client`` padded, steps 1 and 1000.
    Bit-identical, untrained blocks and the padded client bit-exact to their
    inputs; the nested case also equals one one-client launch per client.
    Returns the max abs error (0 when bit-identical)."""
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
    padded[padded_client] = 0.0
    worst = 0.0
    for cname, rows_mask in (cases or _cohort_cases(part, clients)).items():
        gmask = torch.as_tensor(np.ascontiguousarray(rows_mask), dtype=torch.int32,
                                device=dev)
        for vname, valid in (("all valid", np.ones(clients, np.float32)),
                             (f"client {padded_client} padded", padded)):
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
                if cname == "nested" and valid is padded and step == 1000:
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
                 groups=None, plain_reps: int = 20, host_calls: int = 2000,
                 br: int = 8) -> dict:
    """The cohort launch on ``params``' layout x ``clients``, training
    ``groups`` (default: every group, FNU), every client valid, on cold
    buffers (``cold_sets``; ``l2_hot_ms`` is one set back to back):
    CUDA-event ms, host microseconds per wrapper call over ``host_calls``
    calls (few enough that the launch queue never fills, or the host waits
    for the device), the plain version, the bound and
    ``torch.optim.Adam(fused=True)`` on the same bytes (the whole buffers
    for FNU, as many elements as the kernel trains for a group)."""
    from repro_torch.core.aggregation import is_local_stat
    from repro_torch.kernels.masked_adam import (MaskedAdamCohort,
                                                 masked_adam_cohort_ref, ops)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = ops.packed_rows(params, br)
    gids = ops.block_group_ids(params, part, br, exclude=is_local_stat)
    gid = torch.as_tensor(gids, device=dev)
    sel = np.ones(part.num_groups, bool) if groups is None else np.isin(
        np.arange(part.num_groups), groups)
    gmask = torch.as_tensor(np.tile(sel, (clients, 1)), dtype=torch.int32, device=dev)
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
    trained = clients * int(np.isin(gids, np.flatnonzero(sel)).sum()) * br * 128
    bound, bound_by = _cohort_bound_ms(trained, clients, len(gids), part.num_groups)
    first = sets[0]
    out = {"clients": clients, "rows": rows, "trained_elems": trained,
           "buffer_sets": len(sets),
           "ms": cuda_ms(cycling([lambda s=s: s[4].step(0, s[1]) for s in sets]), reps),
           "l2_hot_ms": cuda_ms(lambda: first[4].step(0, first[1]), reps),
           "host_us": host_us(lambda: first[4].step(0, first[1]), host_calls),
           "plain_ms": cuda_ms(cycling([lambda s=s: masked_adam_cohort_ref(
               s[0], s[1], s[2], s[3], gid, gmask, valid, table[0], block_rows=br)
               for s in sets]), plain_reps),
           "bound_ms": bound, "bound_by": bound_by}
    opts = []
    for p, g, *_ in sets:
        if groups is None:
            param = torch.nn.Parameter(p.clone())
            param.grad = g
        else:
            param = torch.nn.Parameter(p.reshape(-1)[:trained].clone())
            param.grad = g.reshape(-1)[:trained]
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


def _log_cohort_time(name: str, t: dict) -> None:
    log(f"[kernel_nlp] masked_adam_cohort nlp x {t['clients']} {name}: rows "
        f"{t['rows']} trained elements {t['trained_elems']} "
        f"({7 * 4 * t['trained_elems'] / 1e9:.4f} GB moved) kernel {t['ms']:.6f} ms "
        f"({t['buffer_sets']} buffer sets in turn; one set back to back: "
        f"{t['l2_hot_ms']:.6f} ms) plain {t['plain_ms']:.6f} ms bound "
        f"{t['bound_ms']:.6f} ms ({t['bound_by']}; {100 * t['bound_ms'] / t['ms']:.2f}% "
        f"of it) torch.optim.Adam(fused=True) {t['library_ms']:.6f} ms; host "
        f"{t['host_us']:.3f} us per step call")


def phase_kernel_nlp(adam: dict, cohort: dict) -> None:
    """The masked-Adam kernel at the nlp transformer's full-width layout
    (10,902,020 parameters, 85,312 packed rows, 6 groups), where the main
    path's launches move gigabytes.  One client against its plain version
    (FNU, the embed group, one block group, the head group; steps 1 and
    1000; frozen blocks bit-exact); the cohort at 8 clients plus a padded
    ninth (the same groups and a nested plan): bit-identical.  Times on cold
    buffers against the bound and ``torch.optim.Adam(fused=True)``: the FNU
    cohort, the embed- and block-group cohorts, one client FNU.  Adds them
    to the two kernels' entries under ``nlp_shape``."""
    from repro_torch.core.aggregation import is_local_stat
    from repro_torch.fl.tasks import nlp_task
    from repro_torch.kernels.masked_adam import ops
    dev, br = "cuda", 8
    adapter = nlp_task(num_classes=4, smoke=NLP_SMOKE)
    params = adapter.init(torch.Generator().manual_seed(0))
    part = adapter.partition(params)
    g = part.num_groups
    rows = ops.packed_rows(params, br)
    gen = torch.Generator(device=dev).manual_seed(17)
    named = {"fnu": tuple(range(g)), "embed": (0,), "block0": (1,), "head": (g - 1,)}
    masks = {name: torch.as_tensor(ops.block_mask_for_group(
        params, part, sel, br, exclude=is_local_stat).astype(np.int32), device=dev)
        for name, sel in named.items()}
    worst = _check_masked_adam(rows, masks, gen, br)
    torch.cuda.empty_cache()
    log(f"[kernel_nlp] masked_adam one client at the nlp layout ({rows} rows, {g} "
        f"groups): {', '.join(named)} masks, steps 1 and 1000: max abs err "
        f"{worst:.3g} on trained blocks (tolerance {KERNEL_TOL:g} x max(1,|ref|)); "
        f"frozen blocks bit-exact")
    clients = NLP_CLIENTS + 1
    cases = _cohort_cases(part, clients, nested_group=g - 2, groups=(0, 1, g - 1))
    cworst = _check_cohort(params, part, gen, clients=clients,
                           padded_client=NLP_CLIENTS, cases=cases)
    log(f"[kernel_nlp] masked_adam_cohort vs plain at the nlp layout x {clients} "
        f"(client {NLP_CLIENTS} padded in one variant): {', '.join(cases)}, steps 1 "
        f"and 1000: bit-identical (max abs err {cworst:.3g}); untrained blocks and "
        f"the padded client bit-exact; equal to {clients} one-client launches")
    kw = dict(plain_reps=5, host_calls=200)
    times = {"fnu": _time_cohort(params, part, 50, NLP_CLIENTS, **kw),
             "embed": _time_cohort(params, part, 50, NLP_CLIENTS, groups=(0,), **kw),
             "block0": _time_cohort(params, part, 100, NLP_CLIENTS, groups=(1,), **kw),
             "one client fnu": _time_cohort(params, part, 200, 1, **kw)}
    for name, t in times.items():
        _log_cohort_time(name, t)
    one = times.pop("one client fnu")
    adam["max_abs_err"] = max(adam["max_abs_err"], worst)
    adam["nlp_shape"] = one
    cohort["max_abs_err"] = max(cohort["max_abs_err"], cworst)
    cohort["nlp_shape"] = times


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
    cases and four ragged ones in f32 and bf16, ragged cases at each width
    of the bf16 body (D 32 to 256), TinyLlama's prefill layer causal and
    with a 1,024 window, Zamba2's shared-attention layer (D 112), Gemma's
    (D 256), Llama-4's (GQA group 5, D 128); then times at the four layers
    (kernel, plain version, ``F.scaled_dot_product_attention`` as the
    library yardstick)."""
    from repro_torch.kernels import build
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
        log(f"[flash] {len(FLASH_HOPPER)} ragged at D "
            f"{' / '.join(str(c[5]) for c in FLASH_HOPPER)} {str(dtype)[6:]}: "
            f"max abs err {err:.3g}, max row err {row:.3g} (same limits)")
    sass = _sass("flash_attention", "flash_fwd_bf16")
    if sass is None:
        log("[flash] SASS of the bf16 body: not available (no cuobjdump)")
    for fn, counts in (sass or {}).items():
        log(f"[flash] SASS of {fn}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
        if counts["STL"] or counts["LDL"]:
            raise AssertionError(f"flash bf16 body {fn} spills: {counts}")
    nvcc = build.library_path("flash_attention").with_suffix(".log").read_text()
    for line in nvcc.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[flash] nvcc: {line.strip()}")
    layers = [("tinyllama", TINYLLAMA_ATTN, 0), ("tinyllama", TINYLLAMA_ATTN, 1024),
              ("zamba2", ZAMBA2_ATTN, 0), ("gemma", GEMMA_ATTN, 0),
              ("llama4", LLAMA4_ATTN, 0)]
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
    gemma = _flash_layer("gemma", GEMMA_ATTN, gen)
    llama4 = _flash_layer("llama4", LLAMA4_ATTN, gen)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
            "launches": None, "max_abs_err": worst, **main,
            "zamba2_layer": zamba2, "gemma_layer": gemma, "llama4_layer": llama4}


# ---------------------------------------------------------------------------
# ssd_chunk
# ---------------------------------------------------------------------------

def _ssd_inputs(case, dtype, gen):
    """q, k (B, S, H, N) and v (B, S, H, P) of ``dtype``, log_a (B, S, H)
    f32, in the model's layout; q and k as ``expand`` views over heads
    (stride 0) where the case says so, as ``mamba2_forward`` passes them.
    Decays as the reference's tests draw them (-|N(0,1)|·0.2), uniform in
    the case's range, or the mLSTM's gates (``SSD_CASES``).  Also returns
    the largest gate v was scaled by (1 without one)."""
    b, h, s, n, p, _, bcast, decay = case
    dev = "cuda"
    hq = 1 if bcast else h
    q = (torch.randn(b, s, hq, n, device=dev, generator=gen) * 0.3).to(dtype)
    k = (torch.randn(b, s, hq, n, device=dev, generator=gen) * 0.3).to(dtype)
    if bcast:
        q, k = q.expand(b, s, h, n), k.expand(b, s, h, n)
    v = torch.randn(b, s, h, p, device=dev, generator=gen)
    scale = 1.0
    if decay == "xlstm_gated":
        gate = torch.exp(torch.clamp_max(torch.randn(b, s, h, device=dev, generator=gen), 8.0))
        v, scale = v * gate[..., None], max(1.0, float(gate.max()))
    v = v.to(dtype)
    if decay == "ref":
        la = -0.2 * torch.randn(b, s, h, device=dev, generator=gen).abs()
    elif decay in ("xlstm", "xlstm_gated"):
        la = torch.nn.functional.logsigmoid(torch.randn(b, s, h, device=dev, generator=gen))
    else:
        lo, hi = {"slow": (0.0, 0.01), "steep": (0.9, 1.1), "steeper": (1.8, 2.2)}[decay]
        la = -(lo + (hi - lo) * torch.rand(b, s, h, device=dev, generator=gen))
    return q, k, v, la, scale


def _ssd_check(case, dtype, gen) -> tuple[float, float, float, str, float]:
    """Kernel vs plain version on one case; returns the max abs error of y,
    the max row error over the row's norm, the state's max abs error, the
    body that ran and the largest gate v was scaled by."""
    from repro_torch.kernels.ssd_chunk import ops, ssd_chunk_kernel
    q, k, v, la, scale = _ssd_inputs(case, dtype, gen)
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
    rows = (-2, -1) if y.shape[-1] == 1 else (-1,)
    row = float((diff.norm(dim=rows) / y_ref.float().norm(dim=rows).clamp_min(1e-30)).max())
    st_err = (st - st_ref).abs()
    if not bool(torch.isfinite(y.float()).all()) or bool(
            (err > tol * (scale + y_ref.float().abs())).any()):
        raise AssertionError(f"ssd {case} {dtype}: max abs err {float(err.max()):.3g} "
                             f"beyond tolerance {tol:g}·({scale:.4g} + |ref|)")
    if not row <= SSD_ROW_TOL[dtype]:
        raise AssertionError(f"ssd {case} {dtype}: max row error {row:.3g} beyond "
                             f"{SSD_ROW_TOL[dtype]:g} of the row's norm")
    if not bool(torch.isfinite(st).all()) or bool(
            (st_err > SSD_STATE_TOL * (1 + st_ref.abs())).any()):
        raise AssertionError(f"ssd {case} {dtype}: state max abs err "
                             f"{float(st_err.max()):.3g} beyond {SSD_STATE_TOL:g}·(1 + |ref|)")
    return float(err.max()), row, float(st_err.max()), body, scale


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
    instructions, of ``HMMA`` (mma.sync) and of the local-memory stores and
    loads ``STL`` / ``LDL`` (spills), and the highest register the code
    names (``maxR``: ptxas's ``-v`` reports the launch's 168 even where a
    ``setmaxnreg.inc`` region uses more), in each function of the built
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
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0, "STL": 0, "LDL": 0,
                              "maxR": 0}
        elif fn and "*/" in line:   # "/*0050*/  @P0 UTMALDG.4D [UR8], [UR4] ;"
            code = line.split("*/", 1)[1].split(";")[0]
            toks = [t for t in code.split() if not t.startswith("@")]
            op = toks[0].split(".")[0] if toks else ""
            if op in counts[fn] and op != "maxR":
                counts[fn][op] += 1
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", code)]
            counts[fn]["maxR"] = max([counts[fn]["maxR"], *regs])
    return counts


def _xlstm_layer_times(gen) -> dict:
    """At xlstm-125m's mLSTM layer (B 4, H 8, S 4,096, chunk 128, bf16),
    the value scan (N = P = 192) and the normaliser scan (P 1) as the main
    path calls them: the kernel (CUDA-core body, P split over CTAs), the
    plain chunked form, ``ssd_ref`` and the bound of each."""
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.models.ssm import chunked_decay_attention
    out = {}
    for tag, case in (("value", XLSTM_SSD), ("normaliser", XLSTM_NORM_SSD)):
        b, h, s, n, p, chunk, _, _ = case
        q, k, v, la, _ = _ssd_inputs(case, torch.bfloat16, gen)
        ms = cuda_ms(lambda: ops.ssd_scan(q, k, v, la, chunk=chunk), 5)
        chunked_ms = cuda_ms(lambda: chunked_decay_attention(q, k, v, la, chunk), 1)
        torch.cuda.empty_cache()
        ref_ms = cuda_ms(lambda: ops.ssd_reference(q, k, v, la), 1)
        bound, bound_by = _ssd_bound_ms(case, torch.bfloat16)
        log(f"[ssd] xlstm layer {tag} scan B{b} H{h} S{s} N{n} P{p} chunk {chunk} bf16: "
            f"cuda_core body {ms:.6f} ms, bound {bound:.6f} ms ({bound_by}; "
            f"{100 * bound / ms:.2f}% of it); plain chunked form {chunked_ms:.6f} ms, "
            f"ssd_ref {ref_ms:.6f} ms; no single PyTorch call computes this scan")
        out[tag] = {"ms": ms, "bound_ms": bound, "bound_by": bound_by, "plain_ms": ref_ms,
                    "plain_chunked_ms": chunked_ms}
        del q, k, v, la
        torch.cuda.empty_cache()
    return out


def phase_ssd() -> dict:
    """The SSD chunk kernel against its plain version (``ssd_ref``) on every
    case in f32 and bf16, naming the body that ran; then, at Zamba2's layer,
    the CUDA-core and ``wgmma`` bodies timed in turns (old, new, new, old),
    the plain chunked form (``impl="plain"``), ``ssd_ref``, the bound; and
    the same for the xLSTM layer's two scans (``_xlstm_layer_times``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.models.ssm import chunked_decay_attention
    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in SSD_CASES + [ZAMBA2_SSD, XLSTM_SSD, XLSTM_NORM_SSD]:
            err, row, st, body, scale = _ssd_check(case, dtype, gen)
            worst = max(worst, err)
            b, h, s, n, p, chunk, bcast, decay = case
            log(f"[ssd] B{b} H{h} S{s} N{n} P{p} chunk {min(chunk, s)}"
                f"{' stride-0 q/k' if bcast else ''}"
                f"{'' if decay == 'ref' else f' {decay} decay'} {str(dtype)[6:]}, {body} "
                f"body: max abs err {err:.3g} (tolerance {SSD_TOL[dtype]:g}·({scale:.4g}"
                f"+|ref|)), max row err {row:.3g} (limit {SSD_ROW_TOL[dtype]:g}), state max "
                f"abs err {st:.3g} (limit {SSD_STATE_TOL:g}·(1+|ref|))")
        torch.cuda.empty_cache()
    for body_fn in ("ssd_wgmma", "ssd_chunk_kernel"):
        sass = _sass("ssd_chunk", body_fn)
        if sass is None:
            log(f"[ssd] SASS of {body_fn}: not available (no cuobjdump)")
        for fn, counts in (sass or {}).items():
            log(f"[ssd] SASS of {fn}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))

    b, h, s, n, p, chunk, _, _ = ZAMBA2_SSD
    q, k, v, la, _ = _ssd_inputs(ZAMBA2_SSD, torch.bfloat16, gen)
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
    xlstm = _xlstm_layer_times(gen)
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk/kernel.py:84",
            "launches": None, "max_abs_err": worst, "ms": ms, "plain_ms": ref_ms,
            "plain_chunked_ms": chunked_ms, "cuda_core_ms": old_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None,
            "xlstm_layer": xlstm["value"], "xlstm_normaliser": xlstm["normaliser"]}


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
    from repro_torch.fl import AlgoConfig, FLRunConfig, resnet_task, run_federated
    from repro_torch.kernels.masked_adam import MaskedAdamCohort

    clients, eval_set = _vision_setup()
    adapter = resnet_task("resnet8", num_classes=20)
    sched = FedPartSchedule(num_groups=10, warmup_rounds=2, rounds_per_layer=1,
                            cycles=1)
    runs = {"fedpart": sched.rounds(), "fnu": matched_fnu(sched).rounds()}
    cfg = FLRunConfig(local_epochs=1, batch_size=64, algo=AlgoConfig("fedavg"),
                      fused_adam=True, device="cuda")
    expected = _expected_launches(clients, runs.values(), cfg)

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
    kw = dict(local_epochs=1, batch_size=64, adam_eps=1e-3, device="cuda")
    for algo in ("fedavg", "fedprox", "moon"):
        _cross_check("fedpart", algo, (adapter, clients, eval_set), short, {
            "fused": FLRunConfig(algo=AlgoConfig(algo), fused_adam=True, **kw),
            "unfused": FLRunConfig(algo=AlgoConfig(algo), fused_adam=False, **kw)})
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


def phase_fedpart_vmap(seq_medians: dict) -> tuple[int, dict]:
    """``fedpart``'s runs through ``engine="vmap"``: one cohort launch per
    bucket and local step, not one per client; seconds per round beside
    the sequential engine's; one FNU round under the profiler; then vmap vs
    sequential on the card for FedAvg / FedProx / MOON and a nested plan.
    Returns the counted run's cohort launches and each run's (median,
    first) seconds per round."""
    from repro_torch.core.schedule import FedPartSchedule, RoundSpec, matched_fnu
    from repro_torch.fl import AlgoConfig, FLRunConfig, resnet_task, run_federated
    from repro_torch.kernels.masked_adam import MaskedAdamCohort

    clients, eval_set = _vision_setup()
    adapter = resnet_task("resnet8", num_classes=20)
    sched = FedPartSchedule(num_groups=10, warmup_rounds=2, rounds_per_layer=1,
                            cycles=1)
    runs = {"fedpart": sched.rounds(), "fnu": matched_fnu(sched).rounds()}
    cfg = FLRunConfig(local_epochs=1, batch_size=64, algo=AlgoConfig("fedavg"),
                      fused_adam=True, engine="vmap", device="cuda")
    expected = _expected_launches(clients, runs.values(), cfg)

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
    kw = dict(local_epochs=1, batch_size=64, adam_eps=1e-3, device="cuda")
    for algo, rounds, extra in checks:
        what = algo + (f" {extra['plan']} plan" if extra else "") + " (adam_eps 0.001)"
        _cross_check("fedpart_vmap", what, (adapter, clients, eval_set), rounds, {
            engine: FLRunConfig(algo=AlgoConfig(algo), fused_adam=True, engine=engine,
                                **kw, **extra) for engine in ("vmap", "sequential")},
            deterministic=True)
    return launches, {name: (medians[name], res.history[0]["seconds"])
                      for name, res in results.items()}


def phase_fedpart_shard(vmap_secs: dict) -> int:
    """``fedpart``'s runs through ``engine="shard_map"`` at world size 1,
    over a one-rank NCCL group initialised here: each bucket-step one
    cohort launch on the rank, each round one all-reduce per bucket of the
    packed transmitted rows.  Seconds per round beside ``fedpart_vmap``'s;
    launches against the recomputed bucket-steps; all-reduce calls and
    bytes per round (counted by the engine) against the transmitted rows
    of the packed layout (1,400 at FNU, BN moments never), and their
    FedPart-to-FNU ratio beside the comm book's; then shard_map vs vmap on
    the card for FedAvg, MOON and a nested plan, the two engines' warm FNU
    rounds in turns, and one FNU round of each under the profiler.
    Returns the counted run's cohort launches."""
    import dataclasses
    import shutil
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.core.partition import group_param_bytes
    from repro_torch.core.schedule import (FedPartSchedule, FNUSchedule, RoundSpec,
                                           matched_fnu)
    from repro_torch.fl import AlgoConfig, FLRunConfig, resnet_task, run_federated
    from repro_torch.fl.batched import ShardMapEngine, _transmitted_rows
    from repro_torch.kernels.masked_adam import MaskedAdamCohort

    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")   # the group's store lives
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, timeout=timedelta(seconds=120),
                            device_id=torch.device("cuda", 0))
    try:
        clients, eval_set = _vision_setup()
        adapter = resnet_task("resnet8", num_classes=20)
        sched = FedPartSchedule(num_groups=10, warmup_rounds=2, rounds_per_layer=1,
                                cycles=1)
        runs = {"fedpart": sched.rounds(), "fnu": matched_fnu(sched).rounds()}
        cfg = FLRunConfig(local_epochs=1, batch_size=64, algo=AlgoConfig("fedavg"),
                          fused_adam=True, engine="shard_map", device="cuda")
        expected = _expected_launches(clients, runs.values(), cfg)

        MaskedAdamCohort.launches = 0
        results, traffic = {}, {}
        for name, rounds in runs.items():
            ShardMapEngine.traffic = []
            results[name] = run_federated(adapter, clients, eval_set, rounds, cfg)
            traffic[name] = ShardMapEngine.traffic
        torch.cuda.synchronize()
        launches = MaskedAdamCohort.launches
        log(f"[fedpart_shard] backend {dist.get_backend()}, world size "
            f"{dist.get_world_size()}")

        medians = _report_fl_runs("fedpart_shard", adapter, results, cfg)
        for name, res in results.items():
            first = res.history[0]["seconds"]
            vm, vf = vmap_secs[name]
            log(f"[fedpart_shard] {name} seconds per round: shard_map median "
                f"{medians[name]:.4f} first {first:.4f}; vmap median {vm:.4f} first "
                f"{vf:.4f} (shard_map / vmap median {medians[name] / vm:.3f})")
        log(f"[fedpart_shard] masked_adam_cohort launches {launches} (bucket-steps "
            f"recomputed from the data: {expected})")
        if launches != expected:
            raise AssertionError(f"cohort launches {launches} != {expected}")

        params = results["fnu"].params
        part = results["fnu"].partition
        buckets = 1                      # 8 clients of 500 at batch 64: one width
        rows = {g: len(_transmitted_rows(params, part, (tuple(range(part.num_groups))
                                                          if g < 0 else g)))
                for g in range(-1, part.num_groups)}
        for name, recs in traffic.items():
            for rec in recs:
                want = rows[rec["group"]] * 512 * buckets
                log(f"[fedpart_shard] {name} group {rec['group']:3d}: all_reduce "
                    f"{rec['all_reduce_calls']} call(s), {rec['all_reduce_bytes']} B "
                    f"({rows[rec['group']]} transmitted rows x 512 B x {buckets} "
                    f"bucket = {want} B); all_gather {rec['all_gather_calls']} "
                    f"call(s), {rec['all_gather_bytes']} B")
                if rec["all_reduce_calls"] != buckets or rec["all_reduce_bytes"] != want:
                    raise AssertionError(f"fedpart_shard {name}: all-reduce {rec}")
        if rows[-1] * 512 != 716_800:
            raise AssertionError(f"FNU transmitted rows {rows[-1]} != 1,400")
        gbytes = group_param_bytes(params, part)
        fnu_ar = rows[-1] * 512
        for g in range(part.num_groups):
            log(f"[fedpart_shard] group {g}: FNU / partial all-reduce bytes "
                f"{fnu_ar / (rows[g] * 512):.3f}, comm book FNU / partial bytes "
                f"{gbytes.sum() / gbytes[g]:.3f}")
        ar = {n: sum(r["all_reduce_bytes"] for r in t) for n, t in traffic.items()}
        log(f"[fedpart_shard] all-reduce bytes fedpart / fnu run "
            f"{ar['fedpart'] / ar['fnu']:.4%}; comm book fedpart / fnu "
            f"{results['fedpart'].comm_total_bytes / results['fnu'].comm_total_bytes:.4%}")

        # Cross-checks: shard_map == vmap on the card (warm-up FNU + one
        # partial round; the nested plan's partial round on group 8), at
        # adam_eps=1e-3 with cuDNN's deterministic algorithms.
        short = FedPartSchedule(num_groups=10, warmup_rounds=1, rounds_per_layer=1,
                                cycles=1).rounds()[:2]
        checks = [(a, short, {}) for a in ("fedavg", "moon")]
        checks.append(("fedavg", [short[0], RoundSpec(1, "partial", 0, 8)],
                       dict(plan="nested", capacity_tiers=(0.3, 0.6, 1.0))))
        kw = dict(local_epochs=1, batch_size=64, adam_eps=1e-3, device="cuda")
        for algo, rounds, extra in checks:
            what = algo + (f" {extra['plan']} plan" if extra else "") + " (adam_eps 0.001)"
            _cross_check("fedpart_shard", what, (adapter, clients, eval_set), rounds, {
                engine: FLRunConfig(algo=AlgoConfig(algo), fused_adam=True, engine=engine,
                                    **kw, **extra) for engine in ("shard_map", "vmap")},
                deterministic=True)

        # The two engines in turns (vmap, shard_map, shard_map, vmap, twice),
        # four FNU rounds a run, each run's first round dropped: the phases'
        # medians above are minutes apart, and the host's load moves them
        # more than the engines differ.  Then one FNU round of each under the
        # profiler.
        turns: dict = {"vmap": [], "shard_map": []}
        for engine in ("vmap", "shard_map", "shard_map", "vmap") * 2:
            res = run_federated(adapter, clients, eval_set, FNUSchedule(4).rounds(),
                                dataclasses.replace(cfg, engine=engine))
            turns[engine] += [h["seconds"] for h in res.history[1:]]
        med = {e: statistics.median(v) for e, v in turns.items()}
        log(f"[fedpart_shard] FNU seconds per warm round in turns: "
            + "; ".join(f"{e} median {med[e]:.4f} min {min(v):.4f} ({len(v)} rounds)"
                        for e, v in turns.items())
            + f"; shard_map / vmap median {med['shard_map'] / med['vmap']:.3f}")
        for engine in ("vmap", "shard_map"):
            _profile_fl_round(dataclasses.replace(cfg, engine=engine), "fedpart_shard",
                              (adapter, clients, eval_set))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase_profile() -> None:
    """Device time by kernel over one main-path FNU round (warm)."""
    from repro_torch.fl import AlgoConfig, FLRunConfig
    _profile_fl_round(FLRunConfig(local_epochs=1, batch_size=64,
                                  algo=AlgoConfig("fedavg"), fused_adam=True,
                                  device="cuda"), "profile")


def _cross_check(tag: str, what: str, setup, rounds, cfgs: dict,
                 deterministic: bool = False, rel_tol: float | None = None) -> float:
    """Run ``rounds`` of ``setup`` (``(adapter, clients, eval_set)``) under
    the two configs of ``cfgs`` (name -> ``FLRunConfig``) and hold them to
    each other within ``CROSS_TOL`` on every param and per-round loss, or
    with ``rel_tol`` within ``rel_tol`` times the second run's largest
    |param| (|loss|); ``deterministic`` picks cuDNN's deterministic
    algorithms.  Returns the max param diff."""
    from repro_torch.fl import run_federated
    from repro_torch.tree import tree_leaves
    adapter, clients, eval_set = setup
    out = {}
    for name, c in cfgs.items():
        torch.backends.cudnn.deterministic = deterministic
        try:
            out[name] = run_federated(adapter, clients, eval_set, rounds, c)
        finally:
            torch.backends.cudnn.deterministic = False
    (na, a), (nb, b) = out.items()
    diff = max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))
    ldiff = max(abs(x["loss"] - y["loss"]) for x, y in zip(a.history, b.history))
    ptol = ltol = CROSS_TOL
    if rel_tol is not None:
        ptol = rel_tol * max(float(y.abs().max()) for y in tree_leaves(b.params))
        ltol = rel_tol * max(abs(h["loss"]) for h in b.history)
    log(f"[{tag}] cross-check {what}: {na} vs {nb} max param diff {diff:.3g} "
        f"(tolerance {ptol:.3g}), max loss diff {ldiff:.3g} (tolerance {ltol:.3g}), "
        f"losses {[round(h['loss'], 6) for h in a.history]}")
    if not (diff <= ptol and ldiff <= ltol):
        raise AssertionError(f"{tag} {what}: {na} and {nb} disagree")
    if not all(math.isfinite(h["loss"]) for h in a.history):
        raise AssertionError(f"{tag} {what}: non-finite {na} loss")
    return diff


NLP_CLIENTS = 8         # the nlp phases' cohort: 8 iid clients in one bucket
NLP_PER_CLIENT = 500    # samples per client: 7 steps of 64 a local epoch
NLP_SMOKE = False       # full width (the reference's nlp-transformer)


def _text_setup():
    """``(adapter, clients, eval_set)`` for the nlp phases: ``nlp_task`` at
    full width and synthetic AG-News-like text (``make_text_dataset``, 4
    classes) at its vocabulary and 256 positions, 8 iid clients x 500
    samples, a balanced eval set of 256."""
    from repro_torch.configs import get_config
    from repro_torch.data import (TextDatasetSpec, balanced_eval_set, build_clients,
                                  iid_partition, make_text_dataset)
    from repro_torch.fl import nlp_task
    cfg = get_config("nlp-transformer", smoke=NLP_SMOKE)
    spec = TextDatasetSpec(num_classes=4, vocab_size=cfg.vocab_size,
                           seq_len=cfg.max_position_embeddings)
    x, y = make_text_dataset(spec, NLP_CLIENTS * NLP_PER_CLIENT, seed=0)
    xe, ye = make_text_dataset(spec, 1000, seed=7)
    return (nlp_task(num_classes=4, cfg=cfg),
            build_clients(x, y, iid_partition(len(y), NLP_CLIENTS, seed=0)),
            balanced_eval_set(xe, ye, per_class=64))


def _expected_launches(clients, rounds_list, cfg) -> int:
    """Masked-Adam launches one run of every schedule in ``rounds_list``
    must make: one per client and local step on the sequential engine, one
    per bucket and step (its longest client's steps) on the vmap engine."""
    from repro_torch.data.pipeline import batch_plan, bucket_plans
    from repro_torch.fl.population import client_round_seed
    n = len(clients)
    total = 0
    for rounds in rounds_list:
        for spec in rounds:
            seeds = [client_round_seed(cfg.seed, spec.index, c) for c in range(n)]
            if cfg.engine == "sequential":
                total += sum(len(batch_plan(len(clients[c]), cfg.batch_size,
                                            cfg.local_epochs, seeds[c]))
                             for c in range(n))
            else:
                total += sum(plans.shape[1] for _, plans, _ in bucket_plans(
                    clients, cfg.batch_size, cfg.local_epochs, seeds))
    return total


def phase_nlp() -> tuple[int, int]:
    """The paper's second task at the reference's full width: FedPart over
    the 6 groups and its matched FNU baseline, FedAvg, ``fused_adam=True``,
    on the sequential engine and then the vmap engine; one FNU round of
    each under the profiler; cross-checks at ``adam_eps=1e-3`` (fused vs
    unfused on the sequential engine; vmap vs sequential for FedAvg,
    FedProx, MOON and a nested plan).  Returns the counted runs'
    masked-Adam launches (sequential, vmap)."""
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import FedPartSchedule, RoundSpec, matched_fnu
    from repro_torch.fl import AlgoConfig, FLRunConfig, run_federated
    from repro_torch.kernels.masked_adam import MaskedAdamCohort, ops
    from repro_torch.tree import tree_leaves

    setup = _text_setup()
    adapter, clients, eval_set = setup
    init = adapter.init(torch.Generator().manual_seed(0))
    part = adapter.partition(init)
    cfg_m = get_config("nlp-transformer", smoke=NLP_SMOKE)
    log(f"[nlp] {cfg_m.name} {'smoke' if NLP_SMOKE else 'full'}: {cfg_m.num_layers} "
        f"blocks d_model {cfg_m.d_model} heads {cfg_m.num_heads} d_ff {cfg_m.d_ff} "
        f"vocab {cfg_m.vocab_size} positions {cfg_m.max_position_embeddings}; "
        f"{sum(int(x.numel()) for x in tree_leaves(init))} params in "
        f"{len(tree_leaves(init))} leaves, {part.num_groups} groups, "
        f"{ops.packed_rows(init, 8)} packed rows; {len(clients)} clients x "
        f"{len(clients[0])} samples of {clients[0].inputs.shape[1]} tokens, batch 64")
    sched = FedPartSchedule(num_groups=part.num_groups, warmup_rounds=1,
                            rounds_per_layer=1, cycles=1)
    runs = {"fedpart": sched.rounds(), "fnu": matched_fnu(sched).rounds()}
    cfgs, medians, launches = {}, {}, {}
    for engine in ("sequential", "vmap"):
        cfg = cfgs[engine] = FLRunConfig(local_epochs=1, batch_size=64,
                                         algo=AlgoConfig("fedavg"), fused_adam=True,
                                         engine=engine, device="cuda")
        expected = _expected_launches(clients, runs.values(), cfg)
        MaskedAdamCohort.launches = 0
        results = {name: run_federated(adapter, clients, eval_set, rounds, cfg)
                   for name, rounds in runs.items()}
        torch.cuda.synchronize()
        launches[engine] = MaskedAdamCohort.launches
        tag = f"nlp_{engine[:3]}"
        medians[engine] = _report_fl_runs(tag, adapter, results, cfg)
        what = ("one client each, = local steps" if engine == "sequential"
                else "one per bucket and local step")
        log(f"[{tag}] masked_adam_cohort launches {launches[engine]} ({what}: "
            f"{expected})")
        if launches[engine] != expected:
            raise AssertionError(f"nlp {engine}: launches {launches[engine]} != "
                                 f"{expected}")
    for name in runs:
        seq, vm = medians["sequential"][name], medians["vmap"][name]
        log(f"[nlp] {name} median seconds per round: vmap {vm:.4f}, sequential "
            f"{seq:.4f} ({seq / vm:.2f}x)")
    for engine, cfg in cfgs.items():
        _profile_fl_round(cfg, f"nlp_{engine[:3]}", setup)

    short = sched.rounds()[:2]
    kw = dict(local_epochs=1, batch_size=64, adam_eps=1e-3, device="cuda")
    for algo in ("fedavg", "fedprox", "moon"):
        _cross_check("nlp", f"{algo} (adam_eps 0.001)", setup, short, {
            "fused": FLRunConfig(algo=AlgoConfig(algo), fused_adam=True, **kw),
            "unfused": FLRunConfig(algo=AlgoConfig(algo), fused_adam=False, **kw)})
    plan = dict(plan="nested", capacity_tiers=(0.3, 0.6, 1.0))
    checks = [(a, short, {}) for a in ("fedavg", "fedprox", "moon")]
    checks.append(("fedavg", [short[0], RoundSpec(1, "partial", 0, part.num_groups - 2)],
                   plan))
    for algo, rounds, extra in checks:
        what = algo + (" nested plan" if extra else "") + " (adam_eps 0.001)"
        _cross_check("nlp", what, setup, rounds, {
            engine: FLRunConfig(algo=AlgoConfig(algo), fused_adam=True, engine=engine,
                                **kw, **extra) for engine in ("vmap", "sequential")})
    return launches["sequential"], launches["vmap"]


def phase_compress() -> int:
    """Compression on the nlp task at full width: FedPart's warm-up FNU
    round, the embed round and the first block round on the vmap engine with
    ``fused_adam=True``, for int8, onebit and topk (0.01), each with error
    feedback.  Per round: loss, seconds and the compression epilogue's
    device time (CUDA events around ``VmapEngine._transmit``).  Checks: the
    run's ``comm_total_bytes`` equals the sum of ``encode_leaf(...).nbytes``
    over each round's transmitted leaves; ``decode_leaf(encode_leaf(u))``
    equals ``qdq_leaf(u)`` bit for bit on the card for every leaf of the
    run's update; int8's vmap run within ``CROSS_TOL`` of the sequential
    one at ``adam_eps=1e-3``.  Returns the counted runs' cohort launches."""
    from repro_torch.core import compress
    from repro_torch.core.aggregation import is_local_stat
    from repro_torch.core.schedule import FedPartSchedule
    from repro_torch.fl import FLRunConfig, run_federated
    from repro_torch.fl.batched import VmapEngine
    from repro_torch.kernels.masked_adam import MaskedAdamCohort
    from repro_torch.tree import path_str, tree_paths

    setup = _text_setup()
    adapter, clients, eval_set = setup
    init = adapter.init(torch.Generator().manual_seed(0))
    part = adapter.partition(init)
    rounds = FedPartSchedule(num_groups=part.num_groups, warmup_rounds=1,
                             rounds_per_layer=1, cycles=1).rounds()[:3]
    kinds = ("int8", "onebit", "topk")
    cfgs = {k: FLRunConfig(local_epochs=1, batch_size=64, fused_adam=True,
                           engine="vmap", compression=k, topk_fraction=0.01,
                           device="cuda") for k in kinds}
    expected = sum(_expected_launches(clients, [rounds], c) for c in cfgs.values())
    MaskedAdamCohort.launches = 0
    for kind, cfg in cfgs.items():
        events = []

        def timed(self, *args, _orig=VmapEngine._transmit, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _orig(self, *args, **kwargs)
            end.record()
            events.append((start, end))
            return out

        VmapEngine._transmit = timed
        try:
            res = run_federated(adapter, clients, eval_set, rounds, cfg)
        finally:
            del VmapEngine._transmit
        torch.cuda.synchronize()
        tx_ms = [a.elapsed_time(b) for a, b in events]
        for h, t in zip(res.history, tx_ms):
            log(f"[compress] {kind} round {h['round']} [{h['phase']}:{h['group']:3d}] "
                f"loss {h['loss']:.6f} acc {h['acc']:.4f} {h['seconds']:.4f} s; "
                f"epilogue {t:.3f} ms ({100 * t / (1e3 * h['seconds']):.2f}% of the "
                f"round)")
        if len(tx_ms) != len(rounds) or not all(math.isfinite(h["loss"])
                                                 for h in res.history):
            raise AssertionError(f"compress {kind}: epilogues {len(tx_ms)} or "
                                 f"non-finite losses {res.history}")
        ccfg = cfg.compression_config()
        update = {path_str(p): a - b.to(a.device) for (p, a), (_, b) in
                  zip(tree_paths(res.params), tree_paths(init))}
        nbytes = {}
        for path, u in update.items():
            enc = compress.encode_leaf(u, ccfg)
            dec = compress.decode_leaf(enc, ccfg, device="cuda")
            if not torch.equal(dec, compress.qdq_leaf(u, ccfg)):
                raise AssertionError(f"compress {kind}: decode(encode) != qdq at {path}")
            nbytes[path] = (enc.nbytes if not is_local_stat(path)
                            else compress.leaf_encoded_bytes(u.numel(), None))
        booked = sum(n for spec in rounds for path, n in nbytes.items()
                     if spec.is_full or part.group_of(path) == spec.group)
        log(f"[compress] {kind}: comm {res.comm_total_bytes} B against the dense FNU "
            f"{res.comm_fnu_bytes} B ({res.comm_total_bytes / res.comm_fnu_bytes:.4f}); "
            f"encoded bytes of the transmitted leaves {booked} B; decode(encode) == "
            f"qdq bit for bit on all {len(update)} leaves; epilogue median "
            f"{statistics.median(tx_ms):.3f} ms per round")
        if booked != res.comm_total_bytes:
            raise AssertionError(f"compress {kind}: booked {res.comm_total_bytes} != "
                                 f"encoded {booked}")
    launches = MaskedAdamCohort.launches
    log(f"[compress] masked_adam_cohort launches {launches} (one per bucket and local "
        f"step: {expected})")
    if launches != expected:
        raise AssertionError(f"compress: launches {launches} != {expected}")
    kw = dict(local_epochs=1, batch_size=64, adam_eps=1e-3, fused_adam=True,
              compression="int8", device="cuda")
    _cross_check("compress", "int8 (adam_eps 0.001)", setup, rounds,
                 {e: FLRunConfig(engine=e, **kw) for e in ("vmap", "sequential")})
    return launches


ASYNC_POPULATION = 1_000_000   # the async phase's streamed fleet


def _async_expected_launches(timeline, population, rounds, cfg) -> int:
    """Masked-Adam launches the async run behind ``timeline`` made: for
    every launched cohort (a dispatch event with a slot; a cohort booked but
    still queued when the run ended never trained), one per bucket and local
    step of its clients, dropped members included, each with its version's
    per-(round, client) seeds."""
    from repro_torch.data.pipeline import batch_plan, bucket_plans
    from repro_torch.fl.population import client_round_seed
    total = 0
    for e in timeline.of_kind("dispatch"):
        if "submesh" not in e:
            continue
        index = rounds[min(e["version"], len(rounds) - 1)].index
        datasets = [population.dataset(c) for c in e["clients"]]
        seeds = [client_round_seed(cfg.seed, index, c) for c in e["clients"]]
        if cfg.engine == "sequential":
            total += sum(len(batch_plan(len(d), cfg.batch_size, cfg.local_epochs, s))
                         for d, s in zip(datasets, seeds))
        else:
            total += sum(plans.shape[1] for _, plans, _ in bucket_plans(
                datasets, cfg.batch_size, cfg.local_epochs, seeds))
    return total


def _log_async_run(tag: str, res, population=None) -> None:
    """Per merge: host seconds, loss, accuracy; the timeline's counts by
    kind, virtual time and occupancy; the host-seconds split."""
    import collections
    for h in res.history:
        log(f"[{tag}] merge {h['round']:2d} [{h['phase']}:{h['group']:3d}] t "
            f"{h['t']:.4f} (virtual) merged {h['merged']} staleness mean "
            f"{h['staleness_mean']:.2f} max {h['staleness_max']} loss {h['loss']:.6f} "
            f"acc {h['acc']:.4f} {h['seconds']:.4f} s")
    tl = res.timeline
    counts = collections.Counter(e["kind"] for e in tl.events)
    log(f"[{tag}] timeline {dict(sorted(counts.items()))}; virtual time "
        f"{tl.total_seconds:.4f} s; delivered {tl.delivered_comm_bytes} B; spent "
        f"{tl.spent_comp_flops:.0f} flops")
    for e in tl.of_kind("occupancy"):
        log(f"[{tag}] occupancy {({k: v for k, v in e.items() if k not in ('t', 'kind')})}")
    for e in tl.of_kind("control"):
        log(f"[{tag}] control at v{e['version']}: {e['note']}")
    hs = res.host_seconds
    log(f"[{tag}] host seconds: dispatch {hs['dispatch']:.4f} (sampling, shards, "
        f"booking), launch {hs['launch']:.4f} (run_local_async returning), resolve "
        f"{hs['resolve']:.4f}, merge {hs['merge']:.4f}, eval {hs['eval']:.4f}; sum of "
        f"merge windows {sum(h['seconds'] for h in res.history):.4f}")
    if population is not None:
        log(f"[{tag}] data cache {population.cache_stats()}")


def phase_async() -> int:
    """The async runtime on the card: ResNet-8 at the paper's width on the
    vmap engine, ``fused_adam=True``, over a streamed population of a
    million clients (Dirichlet 0.5 label skew, 200-500 samples each): 12
    FedPart versions of FedBuff (K 4, staleness exponent 0.5), cohorts of 8
    drawn by availability (biased, debiased merges) under a diurnal trace
    with speed spread, jitter and dropout, two cohorts in flight, the
    adaptive controller.  Checks: cohort launches == one per bucket and
    local step of every launched cohort (from the timeline's dispatch
    events); the degenerate configuration within ``CROSS_TOL`` of the sync
    run with equal books; an int8 FedBuff run on the nlp transformer at full
    width whose delivered updates booked exactly the encoded bytes of their
    groups' leaves.  One profiled async run gives the device busy share.
    Returns the main run's cohort launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import compress
    from repro_torch.core.aggregation import is_local_stat
    from repro_torch.core.schedule import FedPartSchedule
    from repro_torch.data import VisionDatasetSpec
    from repro_torch.fl import (AlgoConfig, AvailabilityConfig, FLRunConfig,
                                SyntheticPopulation, as_population, resnet_task,
                                run_federated)
    from repro_torch.kernels.masked_adam import MaskedAdamCohort
    from repro_torch.tree import path_str, tree_leaves, tree_paths

    t_phase = time.perf_counter()
    adapter = resnet_task("resnet8", num_classes=20)
    _, eval_set = _vision_setup(clients=1, per_client=64)
    population = SyntheticPopulation(VisionDatasetSpec(), population=ASYNC_POPULATION,
                                      samples_per_client=(200, 500), alpha=0.5)
    rounds = FedPartSchedule(num_groups=10, warmup_rounds=2, rounds_per_layer=1,
                             cycles=1).rounds()
    cfg = FLRunConfig(
        local_epochs=1, batch_size=64, algo=AlgoConfig("fedavg"), fused_adam=True,
        engine="vmap", device="cuda", runtime="async", cohort_size=8,
        async_policy="fedbuff", buffer_k=4, staleness_exponent=0.5,
        availability=AvailabilityConfig(speed_spread=3.0, latency_jitter=0.2,
                                        dropout_prob=0.1, trace="diurnal",
                                        duty_cycle=(0.3, 0.9)),
        participation_sampling="biased", max_inflight_cohorts=2,
        controller="adaptive")
    log(f"[async] ResNet-8 x {len(rounds)} FedPart versions, population "
        f"{population.num_clients}, cohorts of {cfg.cohort_size}, FedBuff K "
        f"{cfg.buffer_k}, exponent {cfg.staleness_exponent}, {cfg.availability}, "
        f"biased cohorts, {cfg.max_inflight_cohorts} in flight, adaptive control")
    # warm-up: one short run (cuDNN / vmap first-call costs), not counted
    run_federated(adapter, population, eval_set, rounds[:2], cfg)
    torch.cuda.synchronize()
    MaskedAdamCohort.launches = 0
    t0 = time.perf_counter()
    res = run_federated(adapter, population, eval_set, rounds, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = MaskedAdamCohort.launches
    _log_async_run("async", res, population)
    expected = _async_expected_launches(res.timeline, population, rounds, cfg)
    dispatched = res.timeline.of_kind("dispatch")
    log(f"[async] wall {wall:.4f} s for {len(res.history)} merges; "
        f"{len(dispatched)} cohorts dispatched, "
        f"{sum('submesh' in e for e in dispatched)} launched, "
        f"{len(res.timeline.of_kind('drop'))} members dropped before the last merge "
        f"(dispatched members {sum(len(e['clients']) for e in dispatched)}); "
        f"masked_adam_cohort "
        f"launches {launches} (one per bucket and local step of every launched "
        f"cohort, dropped members included: {expected})")
    if launches != expected:
        raise AssertionError(f"async: cohort launches {launches} != {expected}")
    if len(res.history) != len(rounds) or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["acc"]) for h in res.history):
        raise AssertionError(f"async: bad history {res.history}")
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(res.params)):
        raise AssertionError("async: non-finite params")
    if not res.timeline.of_kind("control"):
        raise AssertionError("async: the adaptive controller recorded no decision")

    # device busy share of a profiled async run (warm, 2 merges)
    short = rounds[:2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_federated(adapter, population, eval_set, short, cfg)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels) / 1e6
    if dev <= 0:
        log("[async] profiled run: the profiler recorded no device time: not measured")
    else:
        log(f"[async] profiled async run of {len(short)} merges: wall {pwall:.4f} s "
            f"(under the profiler), device busy {dev:.4f} s ({100 * dev / pwall:.1f}%)")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[async]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
                f"{e.key[:90]}")

    # the degenerate configuration equals the sync run on the card
    small = SyntheticPopulation(VisionDatasetSpec(), population=8,
                                samples_per_client=(200, 500), alpha=0.5).materialize()
    kw = dict(local_epochs=1, batch_size=64, adam_eps=1e-3, fused_adam=True,
              engine="vmap", device="cuda")
    deg = {rt: run_federated(adapter, small, eval_set, rounds[:3],
                             FLRunConfig(runtime=rt, **kw)) for rt in ("sync", "async")}
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(deg["sync"].params), tree_leaves(deg["async"].params)))
    ldiff = max(abs(a["loss"] - b["loss"]) for a, b in
                zip(deg["sync"].history, deg["async"].history))
    books = [(getattr(deg["sync"], k), getattr(deg["async"], k)) for k in
             ("comm_total_bytes", "comm_fnu_bytes", "comp_total_flops", "comp_fnu_flops")]
    log(f"[async] degenerate (8 clients, full participation, perfect fleet, K 0, "
        f"exponent 0) vs sync: max param diff {diff:.3g}, max loss diff {ldiff:.3g} "
        f"(tolerance {CROSS_TOL:g}); books {books}")
    if not (diff <= CROSS_TOL and ldiff <= CROSS_TOL and all(a == b for a, b in books)):
        raise AssertionError("async: the degenerate run disagrees with the sync run")

    # int8 FedBuff on the nlp transformer at full width: booked == encoded
    setup = _text_setup()
    nadapter, nclients, neval = setup
    init = nadapter.init(torch.Generator().manual_seed(0))
    part = nadapter.partition(init)
    nrounds = FedPartSchedule(num_groups=part.num_groups, warmup_rounds=1,
                              rounds_per_layer=1, cycles=1).rounds()[:3]
    ncfg = FLRunConfig(local_epochs=1, batch_size=64, fused_adam=True, engine="vmap",
                       compression="int8", device="cuda", runtime="async",
                       cohort_size=4, buffer_k=2, staleness_exponent=0.5,
                       availability=AvailabilityConfig(speed_spread=2.0, seed=1))
    MaskedAdamCohort.launches = 0
    nres = run_federated(nadapter, nclients, neval, nrounds, ncfg)
    torch.cuda.synchronize()
    nlaunch = MaskedAdamCohort.launches
    _log_async_run("async_nlp", nres)
    nexp = _async_expected_launches(nres.timeline, as_population(nclients), nrounds,
                                    ncfg)
    ccfg = ncfg.compression_config()
    nbytes = {}
    for (p, a), (_, b) in zip(tree_paths(nres.params), tree_paths(init)):
        path, u = path_str(p), a - b.to(a.device)
        nbytes[path] = (compress.encode_leaf(u, ccfg).nbytes if not is_local_stat(path)
                        else compress.leaf_encoded_bytes(u.numel(), None))

    def encoded(group: int) -> int:
        return sum(n for path, n in nbytes.items()
                   if group < 0 or part.group_of(path) == group)

    group_of_client, delivered, want = {}, 0, 0
    for e in nres.timeline.events:
        if e["kind"] == "dispatch":
            group_of_client.update({c: e["group"] for c in e["clients"]})
        elif e["kind"] == "complete":
            delivered += e["comm_bytes"]
            want += encoded(group_of_client[e["client"]])
    per_version = sum(encoded(-1 if s.is_full else s.group) for s in nrounds)
    log(f"[async_nlp] int8: delivered updates booked {delivered} B, encoded bytes of "
        f"their groups' leaves {want} B; comm_total_bytes {nres.comm_total_bytes} B, "
        f"encoded bytes per version summed {per_version} B; masked_adam_cohort "
        f"launches {nlaunch} (expected {nexp})")
    if delivered != want or nres.comm_total_bytes != per_version:
        raise AssertionError("async_nlp: booked bytes != encoded bytes")
    if nlaunch != nexp:
        raise AssertionError(f"async_nlp: launches {nlaunch} != {nexp}")
    if not all(math.isfinite(h["loss"]) for h in nres.history):
        raise AssertionError(f"async_nlp: non-finite loss {nres.history}")
    log(f"[async] phase {time.perf_counter() - t_phase:.2f} s")
    return launches


def _profile_fl_round(cfg, tag: str, setup=None) -> None:
    """One warm FNU round of ``cfg`` under ``torch.profiler`` on ``setup``
    (``(adapter, clients, eval_set)``; default ResNet-8 on ``_vision_setup``):
    wall, device busy share, launches, the top kernels and the masked-Adam
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.schedule import FNUSchedule
    from repro_torch.fl import resnet_task, run_federated

    if setup is None:
        setup = (resnet_task("resnet8", num_classes=20), *_vision_setup())
    adapter, clients, eval_set = setup
    rounds = FNUSchedule(total=1).rounds()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_federated(adapter, clients, eval_set, rounds, cfg)
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
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
    log(f"[{tag}] one FNU round, {len(clients)} clients ({cfg.engine} engine): wall "
        f"{wall_us / 1e3:.3f} ms (under the profiler), device busy {dev_us / 1e3:.3f} ms "
        f"({100 * dev_us / wall_us:.1f}%; {100 * dev_us / plain_us:.1f}% of the same "
        f"round's {plain_us / 1e3:.3f} ms without the profiler, its warm-up), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:100]}")
    for e in kernels:
        if "masked_adam" in e.key:
            log(f"[{tag}] {e.key[:40]} on the main path: {e.count} launches, "
                f"{e.self_device_time_total / e.count:.3f} us device time each, "
                f"{100 * e.self_device_time_total / dev_us:.2f}% of device busy")


def _serve_profile(cfg, params, prompt, tag: str = "serve",
                   labels: tuple[str, ...] = ()) -> None:
    """Device time by kernel over one warm prefill (under torch.profiler);
    for each of ``labels``, the host time inside that ``record_function``
    range and the device time of the kernels launched in it, as shares of
    the prefill's wall time and device busy time (a range's own mark on the
    card's timeline is a span, not a kernel, and is left out of the busy
    time)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps
    prefill = steps.make_prefill_step(cfg, impl="kernel")
    t_prof = time.perf_counter()
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, cache = prefill(params, prompt)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    del logits, cache
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in labels]
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
    for label in labels:
        ranges = [e for e in events if e.key == label
                  and e.device_type == torch.autograd.DeviceType.CPU]
        if not ranges:
            log(f"[{tag}] {label}: not run")
            continue
        rng, = ranges
        span_us = sum(e.self_device_time_total for e in events if e.key == label
                      and e.device_type == torch.autograd.DeviceType.CUDA)
        host_us = rng.cpu_time_total
        in_dev_us = getattr(rng, "device_time_total", 0.0)
        log(f"[{tag}] {label} ({rng.count} ranges): host {host_us / 1e3:.3f} ms "
            f"({100 * host_us / wall_us:.1f}% of the prefill's wall time), device time of "
            f"its kernels {in_dev_us / 1e3:.3f} ms ({100 * in_dev_us / dev_us:.1f}% of busy), "
            f"its span on the card's timeline {span_us / 1e3:.3f} ms")
    log(f"[{tag}] the profiled prefill and its tables took "
        f"{time.perf_counter() - t_prof:.1f} s")


def _log_serve_run(tag: str, cfg, res, b: int, s: int, g: int) -> None:
    """Logs a counted ``serve_session`` run (prefill seconds, decode tokens
    per second and ms a step, peak device memory, the first row's tokens)
    and fails on tokens or logits of the wrong shape, out of range or not
    finite."""
    toks = res.tokens
    decoded = b * (g - 1)
    log(f"[{tag}] prefill {b}x{s}: {res.prefill_seconds:.6f} s "
        f"({b * s / res.prefill_seconds:.1f} prompt tokens/s); decode {g - 1} "
        f"steps x batch {b} = {decoded} tokens in {res.decode_seconds:.6f} s: "
        f"{decoded / res.decode_seconds:.3f} tokens/s, "
        f"{1e3 * res.decode_seconds / (g - 1):.3f} ms per step; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[{tag}] tokens[0] {toks[0].tolist()}")
    if toks.shape != (b, g) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    for i, x in enumerate(res.logits):
        if x.shape != (b, 1, cfg.vocab_size) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"step {i}: logits {tuple(x.shape)} not finite")


@contextlib.contextmanager
def _recorded_routes():
    """Records every MoE router call's chosen experts (T, k), in call order,
    into the yielded list."""
    from repro_torch.models import moe
    routes, real = [], moe.route

    def recording(*args):
        out = real(*args)
        routes.append(out[2])
        return out

    moe.route = recording
    try:
        yield routes
    finally:
        moe.route = real


def _f32_cross_check(tag: str, cfg32, b: int, what: str) -> None:
    """``cfg32`` (f32, TF32 off) served at prompt 512, 4 tokens, from random
    weights (seed 1): the kernel path against plain PyTorch, every step's
    logits within ``SERVE_CROSS_TOL``, the same tokens and, in a model with
    MoE layers, the same router choices (routing is discontinuous: a flip
    would change a token's expert, not move its logits by a rounding)."""
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api
    from repro_torch.models.api import InputShape
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = api.init(gen, cfg32, "cuda")
    prompt = api.synth_batch(gen, cfg32, InputShape("serve", 512, b, "prefill"), "cuda")
    out, routes = {}, {}
    for impl in ("kernel", "plain"):
        with _recorded_routes() as routes[impl]:
            out[impl] = serve_session(cfg32, b, 512, 4, device="cuda", params=params,
                                      prompt=prompt, impl=impl, verbose=False)
    diffs = [float((k - p).abs().max())
             for k, p in zip(out["kernel"].logits, out["plain"].logits)]
    scale = max(float(x.abs().max()) for x in out["plain"].logits)
    same = torch.equal(out["kernel"].tokens, out["plain"].tokens)
    msg = (f"[{tag}] f32 cross-check B{b} prompt 512 gen 4, {what}: max abs logit diff "
           f"per step {[f'{d:.3g}' for d in diffs]} (tolerance {SERVE_CROSS_TOL:g}; max "
           f"|logit| {scale:.3g}); tokens equal: {same}")
    flips = 0
    if routes["plain"]:
        if len(routes["kernel"]) != len(routes["plain"]):
            raise AssertionError(f"f32 serve {cfg32.name}: {len(routes['kernel'])} router "
                                 f"calls on the kernel path, {len(routes['plain'])} plain")
        flips = sum(int((k != p).sum()) for k, p in zip(routes["kernel"], routes["plain"]))
        msg += (f"; router choices differing {flips} of "
                f"{sum(r.numel() for r in routes['plain'])}")
    log(msg)
    if max(diffs) > SERVE_CROSS_TOL or not same or flips:
        raise AssertionError(f"f32 serve {cfg32.name}: kernel and plain paths disagree")
    del params, prompt, out, routes
    torch.cuda.empty_cache()


def _serve_dense(arch: str, tag: str, f32_layers: int = 0) -> int:
    """``serve_session`` on the dense decoder ``arch`` at full width, bf16,
    random weights from a seed, B 4 × 4,096 prompt, 32 tokens, every prefill
    attention through the flash kernel (one launch per layer, all at the
    config's head dim).  One prefill under ``torch.profiler``.  Then the same
    config in f32 (TF32 off), prompt 512, 4 tokens (``f32_layers`` > 0 keeps
    that many layers, at full width): the kernel path against plain
    attention, every step's logits within ``SERVE_CROSS_TOL`` and the same
    tokens.  Returns the counted run's flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api
    from repro_torch.models.api import InputShape
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    hd = cfg.resolved_head_dim
    b, s, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(gen, cfg, "cuda")
    prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    log(f"[{tag}] {cfg.name} full: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} head dim {hd} d_ff {cfg.d_ff} "
        f"({cfg.mlp_kind}) vocab {cfg.vocab_size} tied {cfg.tie_embeddings} "
        f"{cfg.param_dtype}, {n_params} params")
    # warm-up at full width (cuBLAS handles, kernel loads), then the counted run
    serve_session(cfg, b, 256, 2, device="cuda", params=params, verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention_kernel.launches = 0
    flash_attention_kernel.launches_by_head_dim = {}
    res = serve_session(cfg, b, s, g, device="cuda", params=params, prompt=prompt,
                        verbose=False)
    torch.cuda.synchronize()
    launches = flash_attention_kernel.launches
    by_d = dict(flash_attention_kernel.launches_by_head_dim)

    _log_serve_run(tag, cfg, res, b, s, g)
    log(f"[{tag}] flash_attention launches {launches} (one per layer: "
        f"{cfg.num_layers}), by head dim {by_d}")
    if launches != cfg.num_layers or by_d != {hd: cfg.num_layers}:
        raise AssertionError(f"flash launches {launches} (by head dim {by_d}) != "
                             f"layers {cfg.num_layers} at D {hd}")
    _serve_profile(cfg, params, prompt, tag=tag)
    del params, prompt, res
    torch.cuda.empty_cache()

    cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    depth = "full depth"
    if f32_layers:
        f32_bytes = 4 * n_params
        cfg32 = cfg32.with_(num_layers=f32_layers)
        depth = (f"{f32_layers} of {cfg.num_layers} layers (the f32 weights of all "
                 f"{cfg.num_layers} are {f32_bytes / 1e9:.1f} GB)")
    _f32_cross_check(tag, cfg32, b, f"full width, {depth}, kernel vs plain attention")
    return launches


def phase_serve() -> int:
    """The serving path on tinyllama-1.1b (22 flash launches per prefill)."""
    return _serve_dense("tinyllama-1.1b", "serve")


def phase_serve_dense() -> dict:
    """The serving path on the other dense decoders (``SERVE_DENSE``):
    gemma-2b (18 launches per prefill, all at D 256), llama3.2-1b (16 at D
    64), glm4-9b (40 at D 128).  Returns each one's flash launches."""
    return {f"serve_{arch}": _serve_dense(arch, f"serve_dense {arch}", layers)
            for arch, layers in SERVE_DENSE}


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

    _log_serve_run("serve_hybrid", cfg, res, b, s, g)
    log(f"[serve_hybrid] ssd_chunk launches {ssd_n} (one per Mamba2 layer: "
        f"{mamba_layers}; by body {by_body}), flash_attention launches {flash_n} (one per "
        f"shared-attention application: {n_chunks})")
    if ssd_n != mamba_layers or flash_n != n_chunks:
        raise AssertionError(f"launches: ssd {ssd_n} != {mamba_layers} or flash "
                             f"{flash_n} != {n_chunks}")
    if by_body["wgmma"] != mamba_layers:
        raise AssertionError(f"ssd launches by body {by_body}: not all {mamba_layers} "
                             f"through the wgmma body")
    _serve_profile(cfg, params, prompt, tag="serve_hybrid")
    del params, prompt, res
    torch.cuda.empty_cache()

    _f32_cross_check("serve_hybrid", cfg.with_(param_dtype="float32",
                                               activation_dtype="float32"), b,
                     "full depth and width, kernel vs plain (SSD scans and prefill "
                     "attention)")
    return ssd_n, flash_n, by_body


def phase_serve_xlstm() -> tuple[int, dict]:
    """The xLSTM serving path: ``serve_session`` on xlstm-125m at full
    width, bf16, random weights from a seed, B 4 × 4,096 prompt, 32 tokens;
    both scans of every mLSTM prefill through the SSD kernel's CUDA-core
    body (12 launches: values and normaliser for each of 6 pairs).  One
    prefill under ``torch.profiler``, with the sLSTM's loop over time as a
    share, at a 512-token prompt: at 4,096 the loop's ~615,000 launches
    take the profiler minutes to tabulate.  Then the same config in f32
    (TF32 off), prompt 512, 4 tokens: the kernel path against plain
    PyTorch, every step's logits within
    ``SERVE_CROSS_TOL`` and the same tokens.  Not held against the
    reference: its mLSTM returns NaN at chunk 128 (``ROADMAP.md`` Queue 3).
    Returns the counted run's SSD launches and their split by body."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api, ssm
    from repro_torch.models.api import InputShape
    from repro_torch.tree import tree_leaves

    cfg = get_config("xlstm-125m")
    pairs = cfg.num_layers // 2
    b, s, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(gen, cfg, "cuda")
    prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    d_inner = cfg.ssm_expand * cfg.d_model
    log(f"[serve_xlstm] {cfg.name} full: {pairs} (mLSTM, sLSTM) pairs, d_model "
        f"{cfg.d_model}, mLSTM {d_inner // cfg.ssm_head_dim} heads of N = P = "
        f"{cfg.ssm_head_dim} over d_inner {d_inner}, chunk {cfg.ssm_chunk}; sLSTM "
        f"{cfg.d_model // cfg.ssm_head_dim} heads of {cfg.ssm_head_dim}; vocab "
        f"{cfg.vocab_size} {cfg.param_dtype}, {n_params} params")
    # warm-up at full width (cuBLAS handles, kernel loads), then the counted run
    serve_session(cfg, b, 256, 2, device="cuda", params=params, verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ssd_chunk_kernel.launches = 0
    ssd_chunk_kernel.launches_by_body = dict.fromkeys(ssd_chunk_kernel.launches_by_body, 0)
    res = serve_session(cfg, b, s, g, device="cuda", params=params, prompt=prompt,
                        verbose=False)
    torch.cuda.synchronize()
    ssd_n = ssd_chunk_kernel.launches
    by_body = dict(ssd_chunk_kernel.launches_by_body)

    _log_serve_run("serve_xlstm", cfg, res, b, s, g)
    log(f"[serve_xlstm] ssd_chunk launches {ssd_n} (two per mLSTM layer: {2 * pairs}; "
        f"by body {by_body})")
    if ssd_n != 2 * pairs or by_body["cuda_core"] != 2 * pairs:
        raise AssertionError(f"ssd launches {ssd_n} (by body {by_body}) != {2 * pairs}, "
                             f"all through the cuda_core body")
    _serve_profile(cfg, params, {"tokens": prompt["tokens"][:, :XLSTM_PROFILE_PROMPT]},
                   tag="serve_xlstm", labels=(ssm.SLSTM_LOOP,))
    del params, prompt, res
    torch.cuda.empty_cache()

    _f32_cross_check("serve_xlstm", cfg.with_(param_dtype="float32",
                                              activation_dtype="float32"), b,
                     "full depth and width, kernel vs plain mLSTM scans")
    return ssd_n, by_body


def phase_serve_moe() -> int:
    """The MoE serving path: ``serve_session`` on llama4-maverick-400b-a17b
    at full width (d_model 5,120, 40 query heads over 8 kv heads of 128, 128
    experts of 8,192 top-1 plus a shared one, vocab 202,048), cut to
    ``SERVE_MOE_LAYERS`` of its 48 layers, bf16, random weights from a seed,
    B 4 x 4,096 prompt, 32 tokens; every prefill attention through the flash
    kernel at D 128 (one launch per layer), the expert products through
    cuBLAS.  One prefill under ``torch.profiler``, split by the MoE layer's
    parts.  Then the f32 cross-check at full width, cut to
    ``SERVE_MOE_F32``: kernel against plain attention, the logits within
    ``SERVE_CROSS_TOL``, the same tokens and router choices.  Returns the
    counted run's flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api, moe
    from repro_torch.models.api import InputShape
    from repro_torch.tree import tree_leaves

    full = get_config("llama4-maverick-400b-a17b")
    cfg = full.with_(num_layers=SERVE_MOE_LAYERS)
    hd = cfg.resolved_head_dim
    b, s, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = api.init(gen, cfg, "cuda")
    prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    layer_params = sum(int(x.numel()) for x in tree_leaves(params["moe_blocks"]))
    log(f"[serve_moe] {cfg.name} full width, {cfg.num_layers} of {full.num_layers} layers "
        f"(one MoE layer: {layer_params} params, {2 * layer_params / 1e9:.1f} GB in bf16): "
        f"d_model {cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} (group "
        f"{cfg.num_heads // cfg.num_kv_heads}) head dim {hd}, {cfg.num_experts} experts "
        f"top-{cfg.num_experts_per_tok} of d_ff {cfg.moe_d_ff} + {cfg.num_shared_experts} "
        f"shared, vocab {cfg.vocab_size} {cfg.param_dtype}, {n_params} params; random init "
        f"{init_s:.1f} s; expert capacity {moe._capacity(b * s, cfg)} at prefill, "
        f"{moe._capacity(b, cfg)} at decode (T = B: a second token routed to a busy expert "
        f"is dropped, the reference's rule)")
    # warm-up at full width (cuBLAS handles, kernel loads), then the counted run
    serve_session(cfg, b, 256, 2, device="cuda", params=params, verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention_kernel.launches = 0
    flash_attention_kernel.launches_by_head_dim = {}
    res = serve_session(cfg, b, s, g, device="cuda", params=params, prompt=prompt,
                        verbose=False)
    torch.cuda.synchronize()
    launches = flash_attention_kernel.launches
    by_d = dict(flash_attention_kernel.launches_by_head_dim)
    _log_serve_run("serve_moe", cfg, res, b, s, g)
    log(f"[serve_moe] flash_attention launches {launches} (one per layer: "
        f"{cfg.num_layers}), by head dim {by_d}")
    if launches != cfg.num_layers or by_d != {hd: cfg.num_layers}:
        raise AssertionError(f"flash launches {launches} (by head dim {by_d}) != "
                             f"layers {cfg.num_layers} at D {hd}")
    _serve_profile(cfg, params, prompt, tag="serve_moe", labels=moe.PROFILE_LABELS)
    del params, prompt, res
    torch.cuda.empty_cache()

    cfg32 = full.with_(param_dtype="float32", activation_dtype="float32", **SERVE_MOE_F32)
    _f32_cross_check("serve_moe", cfg32, b,
                     f"full width, {cfg32.num_layers} of {full.num_layers} layers and "
                     f"{cfg32.num_experts} of {full.num_experts} experts (one full layer's "
                     f"f32 weights are {4 * layer_params / 1e9:.1f} GB), kernel vs plain "
                     f"attention")
    return launches


def _fingerprint(x: torch.Tensor) -> list[int]:
    """The sum and the (wrapping) sum of squares of a tensor's raw 16- or
    32-bit words, in int64, a chunk at a time: equal bits give equal sums,
    and one changed word changes the first."""
    words = x.detach().reshape(-1).view(torch.int16 if x.element_size() == 2
                                        else torch.int32)
    acc = torch.zeros(2, dtype=torch.int64, device=x.device)
    for c in words.split(1 << 26):
        c = c.long()
        acc[0] += c.sum()
        acc[1] += (c * c).sum()
    return acc.tolist()


def phase_serve_mla() -> None:
    """The MLA serving path: ``serve_session`` on deepseek-v3-671b at full
    width (d_model 7,168, 128 MLA heads, 256 experts of 2,048 top-8 plus a
    shared one, vocab 129,280), cut to ``SERVE_MLA_LAYERS`` of its 61 layers
    (its 3 dense layers and the first MoE layer) plus the MTP module, bf16,
    random weights from a seed, B 1 x 4,096 prompt, 32 tokens.  MLA and the
    MoE layer are plain PyTorch, as in the reference: no flash and no SSD
    launch.  One prefill under ``torch.profiler``, MLA's scores and the MoE
    layer's parts split by their labels.  On the same weights, one
    FedPart step on the ``mtp`` group at B 1 x ``MTP_STEP_SEQ`` with labels:
    the loss and the MTP term (loss - main lm_loss - aux) finite and
    positive, every leaf outside ``mtp/*`` bit for bit unchanged, the step's
    inputs never written.  Then the f32 decode-consistency check at full
    width, cut to ``SERVE_MLA_F32`` (no token dropped): the decode logits at
    position S equal the full forward's over S + 1 tokens within
    ``DECODE_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
    from repro_torch.launch import serve, steps
    from repro_torch.models import api, attention, moe, transformer
    from repro_torch.models.api import InputShape
    from repro_torch.tree import tree_leaves, tree_paths

    full = get_config("deepseek-v3-671b")
    cfg = full.with_(num_layers=SERVE_MLA_LAYERS)
    n_dense, n_moe = transformer.decoder_layout(cfg)
    b, s, g = SERVE_MLA_BATCH, SERVE_PROMPT, SERVE_GEN
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = api.init(gen, cfg, "cuda")
    prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    log(f"[serve_mla] {cfg.name} full width, {n_dense} dense + {n_moe} MoE of "
        f"{full.num_layers} layers + the MTP module: d_model {cfg.d_model}, MLA {cfg.num_heads} "
        f"heads (q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, qk "
        f"{cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim}, v {cfg.v_head_dim}), dense d_ff "
        f"{cfg.d_ff}, {cfg.num_experts} experts top-{cfg.num_experts_per_tok} of d_ff "
        f"{cfg.moe_d_ff} + {cfg.num_shared_experts} shared ({cfg.router_score}), vocab "
        f"{cfg.vocab_size} {cfg.param_dtype}, {n_params} params; random init {init_s:.1f} s; "
        f"expert capacity {moe._capacity(b * s, cfg)} at prefill, {moe._capacity(b, cfg)} "
        f"at decode")
    serve.serve_session(cfg, b, 256, 2, device="cuda", params=params, verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention_kernel.launches = 0
    ssd_chunk_kernel.launches = 0
    res = serve.serve_session(cfg, b, s, g, device="cuda", params=params, prompt=prompt,
                              verbose=False)
    torch.cuda.synchronize()
    flash_n, ssd_n = flash_attention_kernel.launches, ssd_chunk_kernel.launches
    _log_serve_run("serve_mla", cfg, res, b, s, g)
    log(f"[serve_mla] flash_attention launches {flash_n}, ssd_chunk launches {ssd_n} "
        f"(MLA and MoE are plain PyTorch, as in the reference: 0 and 0)")
    if flash_n or ssd_n:
        raise AssertionError(f"serve_mla launched flash {flash_n} / ssd {ssd_n} times")
    _serve_profile(cfg, params, prompt, tag="serve_mla",
                   labels=(attention.MLA_SCORES,) + moe.PROFILE_LABELS)
    del prompt, res
    torch.cuda.empty_cache()

    # the MTP head's FedPart step, on the same weights
    group = steps.StackedGroup("mtp")
    step = steps.make_fedpart_train_step(cfg, group)
    batch = api.synth_batch(gen, cfg, InputShape("train", MTP_STEP_SEQ, b, "train"), "cuda")
    before = {path: _fingerprint(x) for path, x in tree_paths(params)}
    opt = steps.init_partial_opt_state(params, group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, opt, loss = step(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.inference_mode():
        logits, _, aux = api.forward(params, cfg, {"tokens": batch["tokens"]}, impl="plain")
        main = float(transformer.lm_loss(logits, batch["labels"]))
    del logits
    loss, aux = float(loss), float(aux)
    mtp_term = loss - main - aux
    kept = [p for p, x in tree_paths(new) if p[0] != "mtp" and _fingerprint(x) == before[p]]
    outside = [p for p, _ in tree_paths(new) if p[0] != "mtp"]
    moved = [p for p, x in tree_paths(new) if p[0] == "mtp" and _fingerprint(x) != before[p]]
    inputs_kept = all(_fingerprint(x) == before[p] for p, x in tree_paths(params))
    n_mtp = sum(int(x.numel()) for x in tree_leaves(new["mtp"]))
    log(f"[serve_mla] FedPart step on the mtp group ({n_mtp} params) at B{b} x "
        f"{MTP_STEP_SEQ}: {step_s:.6f} s, peak device memory {peak:.3f} GiB; loss "
        f"{loss:.6f} = main lm_loss {main:.6f} + MoE aux {aux:.6f} + MTP term "
        f"{mtp_term:.6f} ({transformer.MTP_WEIGHT} x the head's loss); leaves outside "
        f"mtp/* bit for bit unchanged: {len(kept)} of {len(outside)}; mtp/* leaves moved: "
        f"{len(moved)} of {len(tree_leaves(new['mtp']))}; the step's inputs unchanged: "
        f"{inputs_kept}")
    if not (math.isfinite(loss) and loss > 0 and math.isfinite(mtp_term) and mtp_term > 0):
        raise AssertionError(f"mtp step: loss {loss}, MTP term {mtp_term}")
    if len(kept) != len(outside) or not moved or not inputs_kept:
        raise AssertionError("mtp step: a leaf outside mtp/* changed, no mtp leaf moved, "
                             "or an input was written")
    del params, new, opt, batch, before
    torch.cuda.empty_cache()

    # decode consistency in f32 at full width
    cfg32 = full.with_(param_dtype="float32", activation_dtype="float32", **SERVE_MLA_F32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = api.init(gen, cfg32, "cuda")
    sp = 512
    tokens = api.synth_batch(gen, cfg32, InputShape("p", sp, b, "prefill"), "cuda")["tokens"]
    with torch.inference_mode():
        logits, cache = steps.make_prefill_step(cfg32)(params, {"tokens": tokens})
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        cache = serve._grow_attention_caches(cache, sp, sp + 1)
        got, _ = api.decode_step(params, cfg32, nxt, cache, sp)
        with _recorded_routes() as routes:
            ref, _, _ = api.forward(params, cfg32,
                                    {"tokens": torch.cat([tokens, nxt], dim=1)}, impl="plain")
    got, want = got[:, 0, :], ref[:, -1, :]
    cap = moe._capacity(b * (sp + 1), cfg32)
    load = max(int(torch.bincount(r.reshape(-1), minlength=cfg32.num_experts).max())
               for r in routes)
    err = (got - want).abs()
    bad = err > DECODE_TOL + DECODE_TOL * want.abs()
    log(f"[serve_mla] f32 decode consistency, full width, {cfg32.num_layers} layers "
        f"({cfg32.first_dense_layers} dense), {cfg32.num_experts} experts, capacity factor "
        f"{cfg32.capacity_factor:g}: B{b} prompt {sp}, the decode logits at position {sp} vs "
        f"the forward over {sp + 1} tokens: max abs diff {float(err.max()):.3g} (tolerance "
        f"{DECODE_TOL:g} abs + rel; max |logit| {float(want.abs().max()):.3g}); largest "
        f"expert load {load} of capacity {cap} in the forward, {moe._capacity(b, cfg32)} at "
        f"decode (no token dropped)")
    if load > cap or bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError("f32 MLA decode disagrees with the full forward")
    del params, cache, logits, ref, got, want
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The launchers: FedPart training of a served architecture, the simulation's
# command line, the paper's driver with its checkpoint, the DLG attack
# ---------------------------------------------------------------------------

FEDTRAIN_LLM = ["--arch", "tinyllama-1.1b", "--full-size", "--batch", "4", "--seq",
                "512", "--steps-per-round", "4", "--warmup", "1", "--rounds", "8"]
FEDTRAIN_SIM = ["--sim-clients", "8", "--rounds", "12", "--batch", "32",
                "--fused-adam"]
# fedtrain_sim's 12-round vmap-vs-sequential bound, relative to the largest
# |param|: twice the reference's own drift on that setup at adam_eps 1e-3,
# fused, on the CPU (tests/test_torch_fedtrain_drift.py run as a script:
# 1.49995e-4 over a largest |param| of 1.12582; the port's there 1.47685e-4)
FEDTRAIN_SIM_REL_TOL = 2 * 1.49995e-4 / 1.12582
TRAIN_CLI = ["--task", "resnet8", "--strategy", "fedpart", "--clients", "8",
             "--warmup", "1", "--rl", "1", "--bridge", "0", "--quiet"]
LLM_SMOKE = False       # full width (the repo's tinyllama-1.1b config)
LLM_F32_SHAPE = (2, 256)   # batch, seq of the f32 FNU-vs-partial check
LLM_F32_GROUP = 7          # blocks/7
GROUP_TOL = 1e-6           # FNU vs partial step: the group's leaves, f32
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
DLG_ITERS = 250            # benchmarks/table9_privacy.py's quick setting


def _group_numel(params, group) -> int:
    """Elements of ``group`` counted from the tree itself (``transmitted_params``'
    yardstick): a stacked layer's slice of every leaf, or the named subtrees."""
    from repro_torch.tree import tree_leaves
    if group.index is not None:
        return sum(int(x[group.index].numel()) for x in tree_leaves(params[group.key]))
    return sum(int(x.numel()) for k in group.key.split("|")
               for x in tree_leaves(params[k]))


def _gemm_counts(fn) -> tuple[int, int]:
    """``fn()`` under the profiler: (GEMM ops issued, device GEMM kernels)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = sum(e.count for e in events if e.key in GEMM_OPS)
    dev = sum(e.count for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and ("gemm" in e.key.lower() or "xmma" in e.key.lower()))
    return ops, dev


def phase_fedtrain_llm() -> None:
    """``fedtrain``'s default, mesh-trainer path on tinyllama-1.1b at full
    width (bf16): one FNU round, then the embed and blocks 0-5 rounds, 4
    steps of B 4 x 512 each; then ``FedPartMeshTrainer.run_round`` for
    blocks/21 and final_norm|head, and one profiled partial round.  Then
    the f32 check from one set of params and one batch: an FNU step and a
    partial step on blocks/7 give the same loss, the group's leaves agree
    within ``GROUP_TOL``, every other leaf of the partial step is its
    start bit for bit, and the partial step's backward is pruned (GEMMs
    counted by the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import FULL_NETWORK, RoundSpec
    from repro_torch.launch import fedtrain, steps
    from repro_torch.models import api
    from repro_torch.models.api import InputShape
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.tree import tree_leaves, tree_paths

    argv = FEDTRAIN_LLM + ["--device", "cuda"]
    if LLM_SMOKE:
        argv.remove("--full-size")
    args = fedtrain.parse_args(argv)
    cfg = get_config(args.arch, smoke=LLM_SMOKE)
    log(f"[fedtrain_llm] fedtrain {' '.join(argv)}: {cfg.name} "
        f"{'smoke' if LLM_SMOKE else 'full'} {cfg.num_layers} layers d_model "
        f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} {cfg.param_dtype}")
    t0 = time.perf_counter()
    params, records = fedtrain.run_mesh(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainer = fedtrain.FedPartMeshTrainer(cfg, AdamConfig(lr=args.lr))
    groups = trainer.groups(params)
    total = sum(int(x.numel()) for x in tree_leaves(params))
    log(f"[fedtrain_llm] {total} params, {len(groups)} groups; {len(records)} rounds "
        f"in {wall:.3f} s (init and batches included)")

    def check_round(rec, tree):
        spec_full = rec["group"] < 0
        want = total if spec_full else _group_numel(tree, groups[rec["group"]])
        name = "FNU" if spec_full else \
            f"{groups[rec['group']].key}/{groups[rec['group']].index}"
        log(f"[fedtrain_llm] round {rec['round']} {name}: loss {rec['loss']:.6f} "
            f"{rec['seconds']:.4f} s peak {rec['peak_bytes'] / 2**30:.3f} GiB tx "
            f"{rec['tx']} (counted from the tree: {want})")
        if rec["tx"] != want or not math.isfinite(rec["loss"]):
            raise AssertionError(f"round {rec['round']}: tx {rec['tx']} != {want} or "
                                 f"loss {rec['loss']}")

    for rec in records:
        check_round(rec, params)

    # the deepest groups straight through the trainer, then a warm FNU round
    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = InputShape("t", args.seq, args.batch, "train")
    for gidx in (len(groups) - 2, len(groups) - 1, FULL_NETWORK):
        spec = RoundSpec(len(records), "partial" if gidx >= 0 else "bridge", 0, gidx)
        batches = [api.synth_batch(gen, cfg, shape, "cuda")
                   for _ in range(args.steps_per_round)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, loss = trainer.run_round(params, spec, batches)
        secs = time.perf_counter() - t0
        rec = {"round": spec.index, "group": gidx, "loss": loss, "seconds": secs,
               "tx": trainer.transmitted_params(new, spec),
               "peak_bytes": torch.cuda.max_memory_allocated()}
        check_round(rec, params)
        records.append(rec)
        names = groups[gidx].key.split("|") if gidx >= 0 else list(params)
        for (path, a), (_, b) in zip(tree_paths(new), tree_paths(params)):
            stacked = (gidx >= 0 and groups[gidx].index is not None
                       and path[0] == groups[gidx].key)
            if stacked:
                keep = [i for i in range(a.shape[0]) if i != groups[gidx].index]
                if not torch.equal(a[keep], b[keep]):
                    raise AssertionError(f"{'/'.join(path)}: frozen layers changed")
            elif path[0] not in names and not torch.equal(a, b):
                raise AssertionError(f"{'/'.join(path)} changed outside the group")
        params = new
        del new

    fnu = [r for r in records if r["group"] < 0]
    part = [r for r in records if r["group"] >= 0]
    warm = part[1:]
    log(f"[fedtrain_llm] seconds per round: FNU {[round(r['seconds'], 4) for r in fnu]} "
        f"(the first is the process's first round); partial median "
        f"{statistics.median(r['seconds'] for r in warm):.4f} s (min "
        f"{min(r['seconds'] for r in warm):.4f}, max "
        f"{max(r['seconds'] for r in warm):.4f}, first {part[0]['seconds']:.4f}); "
        f"peak memory FNU {max(r['peak_bytes'] for r in fnu) / 2**30:.3f} GiB, partial "
        f"{max(r['peak_bytes'] for r in part) / 2**30:.3f} GiB (max over rounds), "
        f"block rounds {max(r['peak_bytes'] for r in part if 0 < r['group'] < len(groups) - 1) / 2**30:.3f} GiB")
    if sum(_group_numel(params, g) for g in groups) != total:
        raise AssertionError("the groups do not tile the model")

    # one profiled partial round (a middle block, warm)
    spec = RoundSpec(len(records), "partial", 0, len(groups) // 2)
    batches = [api.synth_batch(gen, cfg, shape, "cuda")
               for _ in range(args.steps_per_round)]
    trainer.run_round(params, spec, batches[:1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_round(params, spec, batches)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels)
    if dev_us <= 0:
        log("[fedtrain_llm] the profiler recorded no device time: not measured")
    else:
        log(f"[fedtrain_llm] profiled partial round (blocks/{len(groups) // 2 - 1}, "
            f"{len(batches)} steps): wall {wall_us / 1e3:.3f} ms (under the profiler), "
            f"device busy {dev_us / 1e3:.3f} ms ({100 * dev_us / wall_us:.1f}%), "
            f"{sum(e.count for e in kernels)} kernel launches")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"[fedtrain_llm]   {e.self_device_time_total / 1e3:9.3f} ms "
                f"({100 * e.self_device_time_total / dev_us:5.1f}%) {e.count:5d}x "
                f"{e.key[:90]}")
    del params, batches, trainer, prof
    torch.cuda.empty_cache()

    # f32 at full width: FNU step vs the partial step on blocks/7
    cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    p32 = api.init(gen, cfg32, "cuda")
    b, s = LLM_F32_SHAPE
    batch = api.synth_batch(gen, cfg32, InputShape("t", s, b, "train"), "cuda")
    adam = AdamConfig(lr=1e-3, eps=1e-3)
    group = steps.StackedGroup("blocks", LLM_F32_GROUP)
    full_step = steps.make_train_step(cfg32, adam, remat=False)
    part_step = steps.make_fedpart_train_step(cfg32, group, adam, remat=False)
    with torch.no_grad():
        fwd = _gemm_counts(lambda: api.loss(p32, cfg32, batch))
    out = {}

    def run_full():
        new, _, loss = full_step(p32, steps.init_opt_state(p32), batch)
        out["full"] = (float(loss), [x[LLM_F32_GROUP].clone()
                                      for x in tree_leaves(new["blocks"])])

    def run_part():
        new, _, loss = part_step(p32, steps.init_partial_opt_state(p32, group), batch)
        out["part"] = (float(loss), new)

    full_n = _gemm_counts(run_full)
    torch.cuda.empty_cache()
    part_n = _gemm_counts(run_part)
    (l_full, g_full), (l_part, new) = out["full"], out["part"]
    g_part = [x[LLM_F32_GROUP] for x in tree_leaves(new["blocks"])]
    gdiff = max(float((a - c).abs().max()) for a, c in zip(g_full, g_part))
    moved = max(float((a - c[LLM_F32_GROUP]).abs().max())
                for a, c in zip(g_part, tree_leaves(p32["blocks"])))
    g = LLM_F32_GROUP
    frozen_same = all(
        torch.equal(a, c) if path[0] != "blocks" else
        torch.equal(a[:g], c[:g]) and torch.equal(a[g + 1:], c[g + 1:])
        for (path, a), (_, c) in zip(tree_paths(new), tree_paths(p32)))
    n = cfg32.num_layers
    weights = sum(1 for x in tree_leaves(p32["blocks"]) if x.dim() == 3)
    fnu_bwd, part_bwd = full_n[0] - fwd[0], part_n[0] - fwd[0]
    per_block, rest = divmod(fnu_bwd - 2, n)   # the untied head: dW, dX
    want = 1 + (n - LLM_F32_GROUP - 1) * (per_block - weights) + per_block
    log(f"[fedtrain_llm] f32 full width, B {b} x {s}, adam_eps 1e-3, TF32 off: loss "
        f"FNU {l_full!r} partial {l_part!r}; blocks/{LLM_F32_GROUP} after one step: "
        f"FNU vs partial max diff {gdiff:.3g} (tolerance {GROUP_TOL:g}; the step "
        f"moved it up to {moved:.3g}); every leaf outside the group bit-identical: "
        f"{frozen_same}")
    log(f"[fedtrain_llm] GEMMs (profiler; ops issued / device GEMM kernels): forward "
        f"{fwd[0]} / {fwd[1]}, FNU step {full_n[0]} / {full_n[1]}, partial step "
        f"{part_n[0]} / {part_n[1]}; backward FNU {fnu_bwd} = 2 + {n} x {per_block}, "
        f"partial {part_bwd} (want {want}: the head's dX, {n - LLM_F32_GROUP - 1} "
        f"blocks x {per_block - weights} with no weight GEMM, one full block of "
        f"{per_block}, none for blocks 0-{LLM_F32_GROUP - 1})")
    if l_full != l_part:
        raise AssertionError(f"f32 losses differ: {l_full} vs {l_part}")
    if not gdiff <= GROUP_TOL or not moved > 0:
        raise AssertionError(f"blocks/{LLM_F32_GROUP}: FNU vs partial {gdiff}")
    if not frozen_same:
        raise AssertionError("the partial step changed a leaf outside its group")
    if rest or part_bwd != want or not part_n[0] < full_n[0]:
        raise AssertionError(f"partial backward GEMMs {part_bwd} != {want} "
                             f"(FNU {fnu_bwd})")
    del p32, batch, out, new, g_full, g_part
    torch.cuda.empty_cache()


def phase_fedtrain_sim() -> tuple[int, int]:
    """``fedtrain --sim-clients 8 --rounds 12 --batch 32 --fused-adam`` on the
    vmap engine, then the sequential one: cohort launches equal the
    bucket-steps recomputed from the data, one-client launches the
    client-steps; the two runs' books equal.  Their params are held over
    all 12 rounds of the same setup at ``adam_eps=1e-3`` with deterministic
    cuDNN, within ``FEDTRAIN_SIM_REL_TOL`` of the largest |param| (the
    grouped and per-client convs sum in different orders and Adam compounds
    that over rounds, in the reference as in the port; the bound is twice
    the reference's own drift).  Returns (one-client launches, cohort
    launches)."""
    import dataclasses
    from repro_torch.kernels.masked_adam import MaskedAdamCohort
    from repro_torch.launch import fedtrain
    from repro_torch.tree import tree_leaves

    res, launches = {}, {}
    for engine in ("vmap", "sequential"):
        args = fedtrain.parse_args(FEDTRAIN_SIM + ["--engine", engine,
                                                   "--device", "cuda"])
        adapter, clients, eval_set, rounds, cfg = fedtrain.build_simulation(args)
        expected = _expected_launches(clients, [rounds], cfg)
        MaskedAdamCohort.launches = 0
        res[engine] = fedtrain.run_simulation(args)
        torch.cuda.synchronize()
        launches[engine] = MaskedAdamCohort.launches
        secs = [h["seconds"] for h in res[engine].history]
        log(f"[fedtrain_sim] {engine}: masked_adam_cohort launches {launches[engine]} "
            f"(recomputed from the data: {expected}); seconds per round median "
            f"{statistics.median(secs):.4f} (first {secs[0]:.4f}); books comm "
            f"{res[engine].comm_total_bytes} B (FNU {res[engine].comm_fnu_bytes}) comp "
            f"{res[engine].comp_total_flops:.0f}; final acc {res[engine].final_acc:.4f}")
        if launches[engine] != expected:
            raise AssertionError(f"fedtrain_sim {engine}: launches "
                                 f"{launches[engine]} != {expected}")
        if not all(math.isfinite(h["loss"]) for h in res[engine].history):
            raise AssertionError(f"fedtrain_sim {engine}: non-finite loss")
    v, s = res["vmap"], res["sequential"]
    books = ("comm_total_bytes", "comm_fnu_bytes", "comp_total_flops", "comp_fnu_flops")
    if any(getattr(v, k) != getattr(s, k) for k in books):
        raise AssertionError("fedtrain_sim: the engines' books differ")
    diff = max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(v.params), tree_leaves(s.params)))
    log(f"[fedtrain_sim] books equal; the command line's runs (adam_eps 1e-8): max "
        f"param diff vmap vs sequential {diff:.3g}")
    cfgs = {e: dataclasses.replace(cfg, engine=e, adam_eps=1e-3)
            for e in ("vmap", "sequential")}
    _cross_check("fedtrain_sim", "the command line's setup, 12 rounds (adam_eps 0.001)",
                 (adapter, clients, eval_set), rounds, cfgs, deterministic=True,
                 rel_tol=FEDTRAIN_SIM_REL_TOL)
    return launches["sequential"], launches["vmap"]


def phase_train_cli() -> None:
    """``train --task resnet8 --strategy fedpart --clients 8 --warmup 1 --rl 1
    --bridge 0`` with ``--checkpoint-dir`` and ``--out``: the JSON has every
    key, the checkpoint loads back (onto the card) bit for bit equal to
    ``result.params``, and a bf16 tree round-trips through ``save_pytree`` /
    ``load_pytree`` on the card word for word."""
    import tempfile
    from repro_torch.checkpoint import load_checkpoint, load_pytree, save_pytree
    from repro_torch.launch import train
    from repro_torch.tree import tree_map, tree_paths

    keys = {"task", "strategy", "algo", "best_acc", "final_acc", "rounds", "comm_bytes",
            "comm_ratio_to_fnu", "comp_flops", "comp_ratio_to_fnu", "elapsed_s",
            "history"}
    with tempfile.TemporaryDirectory() as tmp:
        out, ckpt = os.path.join(tmp, "train.json"), os.path.join(tmp, "ckpt")
        argv = TRAIN_CLI + ["--out", out, "--checkpoint-dir", ckpt, "--device", "cuda"]
        t0 = time.perf_counter()
        summary, result = train.run(train.parse_args(argv))
        secs = time.perf_counter() - t0
        with open(out) as f:
            written = json.load(f)
        log(f"[train_cli] train {' '.join(TRAIN_CLI)}: {summary['rounds']} rounds in "
            f"{secs:.3f} s ({statistics.median(h['seconds'] for h in result.history):.4f}"
            f" s per round, median); best acc {summary['best_acc']:.4f}, comm "
            f"{summary['comm_ratio_to_fnu']:.4%} of FNU ({summary['comm_bytes']} B), "
            f"comp {summary['comp_ratio_to_fnu']:.4%} of FNU; JSON keys "
            f"{sorted(written)}")
        if set(written) != keys or written["rounds"] != len(written["history"]):
            raise AssertionError(f"train JSON keys {sorted(written)}")
        params, state = load_checkpoint(ckpt, device="cuda")
        same = [p for p, _ in tree_paths(params)] == \
            [p for p, _ in tree_paths(result.params)] and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for (_, a), (_, b) in zip(tree_paths(params), tree_paths(result.params)))
        bf16 = tree_map(lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x,
                        result.params)
        bf16["special"] = torch.tensor([0x7FC1, 0x7F80, -128, 1, -32768, 0x3F80],
                                       dtype=torch.int16,
                                       device="cuda").view(torch.bfloat16)
        save_pytree(os.path.join(tmp, "bf16.npz"), bf16)
        back = load_pytree(os.path.join(tmp, "bf16.npz"), device="cuda")
        words = all(a.dtype == b.dtype and a.device == b.device and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
            for (_, a), (_, b) in zip(tree_paths(bf16), tree_paths(back)))
        log(f"[train_cli] checkpoint: state {state}; params bit-identical to "
            f"result.params: {same}; bf16 tree round-trips word for word on the "
            f"card: {words}")
        if not same or not words or state["rounds"] != summary["rounds"]:
            raise AssertionError("train_cli: the checkpoint does not round-trip")


def phase_dlg() -> None:
    """``benchmarks/table9_privacy.py``'s quick setting through the port's
    ``fl.privacy`` (not the driver): ResNet-8 with 8 classes, one 16 x 16
    target, label 1, 250 DLG iterations at lr 0.05, the full observation
    and group 0's; PSNR (data range 2) and seconds per iteration."""
    from repro_torch.core.partition import build_partition
    from repro_torch.fl.privacy import DLGConfig, dlg_attack, psnr
    from repro_torch.models import resnet
    from repro_torch.tree import tree_map

    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda x: x.to("cuda"), resnet.resnet_init(gen, resnet.RESNET8, 8))
    part = build_partition(params, resnet.resnet_group_key, resnet.resnet_order_key)
    target = (torch.randn((1, 16, 16, 3), generator=gen) * 0.5).to("cuda")
    label = torch.tensor([1], device="cuda")

    def loss_fn(p, x):
        logits, _ = resnet.resnet_apply(p, x, train=False)
        return resnet.cls_loss(logits, label)

    cfg = DLGConfig(iterations=DLG_ITERS, lr=0.05)
    psnrs = {}
    for name, group in (("all", None), ("#1_conv", 0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_hat, match = dlg_attack(loss_fn, params, target, cfg,
                                  partition=part if group is not None else None,
                                  group=group)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        psnrs[name] = float(psnr(target, x_hat, data_range=2.0))
        log(f"[dlg] {name}: PSNR {psnrs[name]:.4f} dB, final match loss "
            f"{float(match):.6g}, {secs / DLG_ITERS * 1e3:.3f} ms per iteration "
            f"({DLG_ITERS} iterations, {secs:.3f} s)")
        if not (math.isfinite(psnrs[name]) and math.isfinite(float(match))):
            raise AssertionError(f"dlg {name}: NaN")
    log(f"[dlg] partial observation PSNR below full: {psnrs['#1_conv'] < psnrs['all']}")


def _timed(phase, *args):
    """``phase(*args)``, logging its host seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[time] {phase.__name__[len('phase_'):]} {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs one "
              "card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = _timed(phase_env)
    _timed(phase_build)
    adam, cohort = _timed(phase_kernel)
    _timed(phase_kernel_nlp, adam, cohort)
    fedpart_n, seq_medians = _timed(phase_fedpart)
    fedpart_vmap_n, vmap_secs = _timed(phase_fedpart_vmap, seq_medians)
    fedpart_shard_n = _timed(phase_fedpart_shard, vmap_secs)
    nlp_seq_n, nlp_vmap_n = _timed(phase_nlp)
    compress_n = _timed(phase_compress)
    async_n = _timed(phase_async)
    _timed(phase_profile)
    flash = _timed(phase_flash)
    flash_serve = _timed(phase_serve)
    flash_dense = _timed(phase_serve_dense)
    ssd = _timed(phase_ssd)
    ssd_hybrid, flash_hybrid, hybrid_bodies = _timed(phase_serve_hybrid)
    ssd_xlstm, xlstm_bodies = _timed(phase_serve_xlstm)
    flash_moe = _timed(phase_serve_moe)
    _timed(phase_serve_mla)
    ssd["launches_by_path"] = {"serve_hybrid": ssd_hybrid, "serve_xlstm": ssd_xlstm}
    ssd["launches"] = ssd_hybrid + ssd_xlstm
    ssd["launches_by_body"] = {"serve_hybrid": hybrid_bodies, "serve_xlstm": xlstm_bodies}
    flash["launches_by_path"] = {"serve": flash_serve, **flash_dense,
                                 "serve_hybrid": flash_hybrid, "serve_moe": flash_moe}
    flash["launches"] = sum(flash["launches_by_path"].values())
    _timed(phase_fedtrain_llm)
    sim_seq_n, sim_vmap_n = _timed(phase_fedtrain_sim)
    _timed(phase_train_cli)
    _timed(phase_dlg)
    log(f"[time] all phases {time.perf_counter() - t_start:.1f} s")
    adam["launches_by_path"] = {"fedpart": fedpart_n, "nlp": nlp_seq_n,
                                "fedtrain_sim": sim_seq_n}
    cohort["launches_by_path"] = {"fedpart_vmap": fedpart_vmap_n,
                                  "fedpart_shard": fedpart_shard_n, "nlp": nlp_vmap_n,
                                  "compress": compress_n, "async": async_n,
                                  "fedtrain_sim": sim_vmap_n}
    for k in (adam, cohort):
        k["launches"] = sum(k["launches_by_path"].values())
    print(json.dumps({"kernels": [adam, cohort, flash, ssd]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
