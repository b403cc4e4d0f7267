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
              bf16, causal), Llama-4-Maverick's (B 4, H 40, Hkv 8: a GQA
              group of 5, S 4,096, D 128, bf16, causal), whisper-small's
              encoder layer (B 32, H 12 = Hkv 12, S 1,500, D 64, bf16,
              non-causal), decoder layer (S 416, causal) and cross layer
              (Sq 416, Skv 1,500, non-causal) and LLaVA-NeXT-34B's (B 4, H 56, Hkv 8: a GQA group of 7, S
              4,096, D 128, bf16, causal), and the smoke configs' shapes
              that ``examples`` serves (whisper's three at D 16, GQA 2 and
              MQA at D 32, S 32) in f32 and bf16, each element and each
              output row held to its limit.  The bf16 bodies'
              ``HGMMA`` / ``UTMALDG`` / ``HMMA`` instruction counts from
              ``cuobjdump -sass``, registers and spills from nvcc.  Times
              (CUDA events) at those eight layers, achieved TFLOP/s, their
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
   serve_moe — the f32 cross-check first (full width, cut to 2 layers and
              8 experts, B 4 x 512, 4 tokens, TF32 off: kernel vs plain
              attention, every step's logits within 1e-3, the same tokens
              and no router choice differing), then
              ``serve_session`` on llama4-maverick-400b-a17b at full width
              (d_model 5,120, 40 / 8 heads of 128, 128 experts of 8,192
              top-1 plus a shared one, vocab 202,048), cut to 1 of its 48
              layers (one MoE layer is 32.6 GB in bf16), bf16, random
              weights from a seed, B 4 x 4,096 prompt, 32 greedy tokens:
              the prefill attention must launch the flash kernel once, at D
              128; the expert products are cuBLAS batched GEMMs.  One
              prefill under ``torch.profiler``, split by the MoE layer's
              labelled parts (router, dispatch, experts, combine, shared
              expert).
   serve_moe_ep — expert parallelism (``models.moe_ep``) on serve_moe's
              weights and prompt at mesh (1, 1) over a one-rank NCCL group:
              one flash launch per layer at D 128; the prefill logits and
              every step's logits and tokens equal serve_moe's (bit-equal
              expected; fails past 1e-3 or on a token); one all-reduce per
              MoE layer per prefill, 167,772,160 B; prefill seconds beside
              serve_moe's; the dry run's activation peak beside the card's
              (B 4 with flash, B 1 plain); then at 2 layers / 8 experts in
              f32 ``api.loss``'s gradients with and without expert
              parallelism, each leaf within 1e-5 of its largest |gradient|.
   serve_mla — ``serve_session`` on deepseek-v3-671b at full width (MLA,
              256 experts of 2,048 top-8 plus a shared one), cut to its 3
              dense layers and the first MoE layer of 61, plus the MTP
              module, bf16, B 1 x 4,096 prompt (MLA's f32 scores are 8.6 GB
              a copy), 32 tokens: no flash and no SSD launch (MLA has no
              kernel, in the reference or here).  One prefill under
              ``torch.profiler``.  The prefill under FSDP expert
              parallelism at (1, 1) (the weight all-gathers run) equals the
              non-EP prefill; the dry run's activation peak beside the
              card's.  On the same weights one FedPart step on
              the ``mtp`` group (B 1 x 1,024 with labels): the loss and its
              MTP term finite and positive, every leaf outside ``mtp/*``
              bit for bit unchanged (word sums), seconds and peak memory.
              Then f32 decode consistency at full width, cut to 2 layers
              (1 dense), 16 experts and capacity factor 8.0 (no token
              dropped): the decode logits at position 512 equal the
              forward's over 513 tokens within 2e-4 (abs + rel).
   serve_encdec — ``serve_session`` on whisper-small at full width (12
              encoder and 12 decoder layers, d_model 768, 12 heads of 64,
              vocab 51,865, tied), bf16, random weights from a seed, B 32 x
              1,500 stub frames with a 416-token prompt, 32 tokens (448
              positions, the ``dec_pos`` table's size): every attention of
              the prefill through the flash kernel at D 64, 36 launches (12
              encoder self-attentions, non-causal; 12 decoder
              self-attentions, causal; 12 cross-attentions, non-causal, Sq
              416, Skv 1,500).  One prefill under ``torch.profiler``.  Then
              the f32 cross-check at full width (B 4 x 1,500 frames, the
              416-token prompt, 4 tokens): every step's logits within 1e-3
              and the same tokens.
   serve_vlm — ``serve_session`` on llava-next-34b at full width (d_model
              7,168, 56 / 8 heads of 128: a GQA group of 7, d_ff 20,480),
              cut to 50 of its 60 layers, which leaves 8 GiB of the card
              free at the run's peak with a layer to spare, bf16, B 4 x 4,096 prompt
              positions (576 stub media embeddings, then 3,520 tokens), 32
              tokens: one flash launch per layer at D 128; the peak memory
              and the layers kept.  One prefill under ``torch.profiler``.
              Then the f32 cross-check at full width, 4 layers, B 4 x (576
              + 512), 4 tokens.
   sharded_step — the DTensor-propagated steps (``launch.steps``
              ``make_sharded_*``) at mesh (1, 1) over a one-rank NCCL group:
              TinyLlama-1.1B served at full width through
              ``serve_session(..., mesh=...)`` (22 flash launches a prefill
              on each rank's heads through ``models.sharded_heads``; logits
              and 32 tokens held to the plain session's), an f32 FedPart
              step on blocks/7 against the plain step, Zamba2-7B cut to 13
              layers (13 SSD launches, all wgmma, and 2 flash; logits
              against the plain prefill).  Then what each model rank's
              attention region runs for Gemma's MQA, LLaVA's GQA 7 (kv
              heads sharded, copied per query head, heads replicated) and
              TinyLlama's 4 kv heads at model 8, B 4 x 4,096: the flash
              wrapper on every rank's heads, joined, against the plain
              version.
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
   fedtrain_encdec — ``FedPartMeshTrainer`` on whisper-small at full
              width (bf16): an FNU round, then a partial round on
              ``dec_blocks/0``, B 8 x 1,500 frames and 416 tokens, 2 steps
              each; seconds and peak memory of each; every leaf outside the
              group bit for bit unchanged by the partial round.
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
14. claims   — the paper's claims experiment through
              ``repro_torch.experiments.claims_experiment.run`` at the
              reference's defaults with ``fused_adam=True``: 25 FedPart
              rounds and the matched 25 FNU rounds, 4 clients x 48 local
              steps (8 epochs), step sizes tracked (sequential engine).
              Masked-Adam launches equal the client-steps replayed from the
              server's draws (9,600); the comm and comp books equal the
              reference's (pinned by ``tests/test_torch_claims.py``); every
              accuracy in [0, 1], both post-aggregation spikes finite.
              Prints both runs' best and final accuracy, curves, spikes,
              books and seconds per round, and whether the paper's
              direction showed (not asserted).
15. examples — the six examples through their ``run`` functions at the
              reference's defaults, ``fused_adam=True`` for the FL ones:
              the quickstart on the sequential, vmap and shard_map engines
              (a one-rank NCCL group made for it), with a nested plan
              (tiers 0.5 / 1.0), int8 compression and a streamed
              population of 10**6 (cohorts of 4); fedpart_language (FedAvg
              and FedProx, FedPart and FNU), fedpart_ablations (6 runs),
              fedpart_async (3 variants, two cohorts in flight on the
              card's one slot); masked-Adam launches equal the replayed
              client-steps or bucket-steps in each, the quickstart's
              FedPart comm book the reference's.  fedpart_mesh_training at
              its defaults (TinyLlama smoke) and ``launch.fedtrain``'s
              xLSTM-125m FedPart rounds at full width (B 4 x 512, an FNU
              round and group 0, 2 steps each): seconds and peak memory per
              round.  serve_llm on the ten assigned architectures at smoke
              size (f32, B 4 x 32, 12 tokens): flash and SSD launches equal
              ``kernel_launches`` (20 and 7), tokens equal an
              ``impl="plain"`` session's on the same weights, logits within
              the kernels' f32 tolerances.

Every serve phase checks the dry run's per-device parameter residency at
mesh (1, 1) (``launch.dryrun.param_residency``) against the bytes of the
params on the card, equal to the byte.  At (1, 1) every placement is
whole, so this shows only that the fake init's shapes and dtypes are the
card's; the placements themselves are held on the CPU
(``tests/test_torch_sharding.py``, ``per_device_bytes`` against the
reference's specs).

Each phase logs its host seconds (``[time]``).  The line before the last
carries ``nvidia-smi``'s name and power limit, the
one before it the ``kernels`` JSON (the masked-Adam entries count their
launches by path: ``fedpart``, ``nlp``, ``fedtrain_sim``, ``claims`` and
``examples_seq`` for the one-client launches, ``fedpart_vmap``,
``fedpart_shard``, ``nlp``, ``compress``, ``async``, ``fedtrain_sim``,
``examples_vmap`` and ``examples_shard`` for the cohort launches; the
SSD entry by path, ``serve_hybrid``, ``serve_xlstm``, ``sharded_step`` and
``serve_llm``, and by body within each, with the xLSTM layer's two scans
beside Zamba2's layer; the flash entry by path, ``serve_moe``,
``serve_moe_ep``, ``serve_encdec``, ``serve_vlm`` and ``serve_llm`` among
them, with Zamba2's, Gemma's, Llama-4's, whisper's encoder, decoder and cross
and LLaVA's layers beside TinyLlama's); the last line is the ``ok`` JSON.
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
# the smoke configs' prefill attentions as serve_llm launches them (B 4,
# prompt 32): whisper's encoder over its 12 stub frames, decoder and cross
# attention at D 16, and the decoders' GQA 2 and MQA at D 32
FLASH_SMOKE = [
    (4, 4, 4, 12, 12, 16, False, 0),
    (4, 4, 4, 32, 32, 16, True, 0),
    (4, 4, 4, 32, 12, 16, False, 0),
    (4, 4, 2, 32, 32, 32, True, 0),
    (4, 4, 1, 32, 32, 32, True, 0),
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
# whisper-small served at the reference's prefill_32k batch, B 32, over its
# 1,500 stub encoder frames, with a 416-token decoder prompt and 32 generated
# tokens: 448 positions, the dec_pos table's size, so no position wraps
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN = 32, 416, 32
WHISPER_FRAMES = 1500
# its attentions (H 12 = Hkv 12, D 64): the encoder's self-attention over the
# frames (non-causal) and the cross-attention of the decoder's prompt over
# them (non-causal, Sq != Skv); the decoder's own is causal at S 416, which is
# 3 x 128 + 32, so its last query and key tiles are both partial under the mask
WHISPER_ENC_ATTN = (WHISPER_BATCH, 12, 12, WHISPER_FRAMES, WHISPER_FRAMES, 64)
WHISPER_DEC_ATTN = (WHISPER_BATCH, 12, 12, WHISPER_PROMPT, WHISPER_PROMPT, 64)
WHISPER_CROSS_ATTN = (WHISPER_BATCH, 12, 12, WHISPER_PROMPT, WHISPER_FRAMES, 64)
# its f32 cross-check: B 4 x 1,500 frames, the 416-token prompt, 4 tokens
WHISPER_F32 = (4, WHISPER_PROMPT, 4)
# its FedPart rounds at full width: B 8 x 1,500 frames and 416 tokens, 2 steps
WHISPER_TRAIN = (8, WHISPER_PROMPT, 2)
# llava-next-34b's prefill attention at the serve prompt: B 4, H 56, Hkv 8 (a
# GQA group of 7), S 4,096 (576 media positions and 3,520 tokens), D 128
LLAVA_ATTN = (SERVE_BATCH, 56, 8, SERVE_PROMPT, SERVE_PROMPT, 128)
# llava-next-34b at full width, cut in depth to what one card holds with 8 GiB
# free at the serve run's peak: a layer is 557.8 M params (1.116 GB in bf16),
# and its K / V caches at B 4 x 4,128 67 MB, held twice while they are stacked;
# on an H100 80GB HBM3 (700 W) 52 layers left 8.716 and 8.444 GiB outside the
# allocator's reserved peak in two runs (1.102 GiB a layer); 51 left 9.501
# there but 8.555 by the driver's count, the CUDA context and what lies outside
# the allocator taking 0.946, so 50 keeps 8 GiB free with a layer to spare
SERVE_VLM_LAYERS = 50
VLM_FREE_GIB = 8.0
# its f32 cross-check: 4 layers at full width, B 4 x (576 media + 512 tokens)
SERVE_VLM_F32_LAYERS = 4
# The MoE decoders at full width, cut in depth to what one card holds.
# Llama-4: one MoE layer is 16.30 G params (32.6 GB in bf16) and the embedding
# and head 2.07 G; beside them a prefill of B 4 x 4,096 holds 13.2 GB of f32
# logits and the head's 4.1 GB f32 copy, so a second layer would pass 80 GB.
SERVE_MOE_LAYERS = 1
# its f32 cross-check: one full layer's f32 weights are 65 GB
SERVE_MOE_F32 = {"num_layers": 2, "num_experts": 8}
# The sharded-model layer on one card (a one-rank NCCL group, mesh (1, 1)):
# expert parallelism's f32 gradients at SERVE_MOE_F32, B 2 x 256 with labels,
# each leaf within EP_GRAD_TOL of its largest |gradient| without EP; the
# dry run's activation peak beside the card's for a plain-attention prefill
# at B PEAK_BATCH x 4,096 (at B 4 Llama-4's plain f32 scores would pass 80 GB)
EP_GRAD_TOL = 1e-5
EP_GRAD_BATCH = (2, 256)
PEAK_BATCH = 1
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
    return _flash_agrees(out, ref, q, case, dtype)


def _flash_agrees(out, ref, q, case, dtype) -> tuple[float, float]:
    """``out`` against the plain ``ref`` at the flash tolerances (abs + rel,
    and the row error over the row's norm); returns both errors."""
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


def _flash_layer(name: str, shape, gen, causal: bool = True) -> dict:
    """Times one bf16 layer (``shape`` = (B, H, Hkv, Sq, Skv, D)) in the
    model's (B, S, H, D) layout: the kernel, the plain version,
    ``F.scaled_dot_product_attention`` as the library yardstick (its causal
    flag to match), and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    b, h, hkv, sq, skv, d = shape
    q, k, v = _flash_qkv(b, h, hkv, sq, skv, d, torch.bfloat16, gen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = {"ms": cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal), 5),
           "plain_ms": cuda_ms(lambda: ops.attention_reference(q, k, v, causal=causal),
                               2, 3)}
    torch.cuda.empty_cache()
    out["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), 10)
    out["bound_ms"], out["bound_by"] = _flash_bound_ms(b, h, hkv, sq, skv, d, causal, 0,
                                                       torch.bfloat16)
    out["tflops"] = _flash_flops(b, h, sq, skv, d, causal, 0) / out["ms"] / 1e9
    mask = "causal" if causal else "non-causal"
    seq = f"S{sq}" if sq == skv else f"Sq{sq} Skv{skv}"
    log(f"[flash] {name} layer B{b} H{h} Hkv{hkv} {seq} D{d} bf16 {mask}: "
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
    (D 256), Llama-4's (GQA group 5, D 128), whisper's encoder layer
    (non-causal, S 1,500), decoder layer (causal, S 416) and cross layer
    (non-causal, Sq 416, Skv 1,500) and LLaVA's (GQA group 7, D 128); then
    times at those eight layers
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
        errs = [_flash_check(c, dtype, gen) for c in FLASH_SMOKE]
        err, row = max(e for e, _ in errs), max(r for _, r in errs)
        worst = max(worst, err)
        log(f"[flash] {len(FLASH_SMOKE)} smoke-config shapes at D "
            f"{' / '.join(str(c[5]) for c in FLASH_SMOKE)} {str(dtype)[6:]}: "
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
    layers = [("tinyllama", TINYLLAMA_ATTN, 0, True),
              ("tinyllama", TINYLLAMA_ATTN, 1024, True), ("zamba2", ZAMBA2_ATTN, 0, True),
              ("gemma", GEMMA_ATTN, 0, True), ("llama4", LLAMA4_ATTN, 0, True),
              ("whisper encoder", WHISPER_ENC_ATTN, 0, False),
              ("whisper decoder", WHISPER_DEC_ATTN, 0, True),
              ("whisper cross", WHISPER_CROSS_ATTN, 0, False),
              ("llava", LLAVA_ATTN, 0, True)]
    for name, (b, h, hkv, sq, skv, d), window, causal in layers:
        err, row = _flash_check((b, h, hkv, sq, skv, d, causal, window), torch.bfloat16,
                                gen)
        worst = max(worst, err)
        seq = f"S{sq}" if sq == skv else f"Sq{sq} Skv{skv}"
        log(f"[flash] {name} layer B{b} H{h} Hkv{hkv} {seq} D{d} bf16 "
            f"{'causal' if causal else 'non-causal'} window {window}: max abs err "
            f"{err:.3g} (tolerance "
            f"{FLASH_TOL[torch.bfloat16]:g} abs + rel), max row err {row:.3g} of the "
            f"row's norm (limit {FLASH_ROW_TOL[torch.bfloat16]:g})")
        torch.cuda.empty_cache()

    main = _flash_layer("tinyllama", TINYLLAMA_ATTN, gen)
    zamba2 = _flash_layer("zamba2", ZAMBA2_ATTN, gen)
    gemma = _flash_layer("gemma", GEMMA_ATTN, gen)
    llama4 = _flash_layer("llama4", LLAMA4_ATTN, gen)
    whisper_enc = _flash_layer("whisper encoder", WHISPER_ENC_ATTN, gen, causal=False)
    whisper_dec = _flash_layer("whisper decoder", WHISPER_DEC_ATTN, gen)
    whisper_cross = _flash_layer("whisper cross", WHISPER_CROSS_ATTN, gen, causal=False)
    llava = _flash_layer("llava", LLAVA_ATTN, gen)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
            "launches": None, "max_abs_err": worst, **main,
            "zamba2_layer": zamba2, "gemma_layer": gemma, "llama4_layer": llama4,
            "whisper_encoder_layer": whisper_enc, "whisper_decoder_layer": whisper_dec,
            "whisper_cross_layer": whisper_cross,
            "llava_layer": llava}


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


@contextlib.contextmanager
def _one_rank_group():
    """A one-rank NCCL default process group on card 0 (its store in a
    temporary directory), destroyed on exit."""
    import shutil
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, timeout=timedelta(seconds=120),
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


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

    import torch.distributed as dist
    from repro_torch.core.partition import group_param_bytes
    from repro_torch.core.schedule import (FedPartSchedule, FNUSchedule, RoundSpec,
                                           matched_fnu)
    from repro_torch.fl import AlgoConfig, FLRunConfig, resnet_task, run_federated
    from repro_torch.fl.batched import ShardMapEngine, _transmitted_rows
    from repro_torch.kernels.masked_adam import MaskedAdamCohort

    with _one_rank_group():
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
    must make, each run's cohorts replayed from the server's own draws (one
    ``np.random.default_rng(cfg.seed)`` a run, one Floyd sample a round, a
    streamed population's shards rebuilt): one per client and local step on
    the sequential engine, one per bucket and step (its longest client's
    steps) on the vmap engine and on the shard_map engine at one rank."""
    from repro_torch.data.pipeline import batch_plan, bucket_plans
    from repro_torch.fl.population import (as_population, client_round_seed,
                                           resolve_cohort_size,
                                           sample_without_replacement)
    population = as_population(clients)
    n = population.num_clients
    total = 0
    for rounds in rounds_list:
        rng = np.random.default_rng(cfg.seed)
        for spec in rounds:
            picked = sample_without_replacement(
                rng, n, resolve_cohort_size(n, cfg.sample_fraction, cfg.cohort_size))
            datasets = [population.dataset(c) for c in picked]
            seeds = [client_round_seed(cfg.seed, spec.index, c) for c in picked]
            if cfg.engine == "sequential":
                total += sum(len(batch_plan(len(d), cfg.batch_size, cfg.local_epochs, s))
                             for d, s in zip(datasets, seeds))
            else:
                total += sum(plans.shape[1] for _, plans, _ in bucket_plans(
                    datasets, cfg.batch_size, cfg.local_epochs, seeds))
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
    wall, launches, the top kernels and the masked-Adam kernels.  The
    device's busy and idle share is the benchmark's (``perfbench``, the
    union of device intervals), not a sum of kernel times."""
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
        f"{wall_us / 1e3:.3f} ms (under the profiler; {plain_us / 1e3:.3f} ms without "
        f"it, its warm-up), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:100]}")
    for e in kernels:
        if "masked_adam" in e.key:
            log(f"[{tag}] {e.key[:40]} on the main path: {e.count} launches, "
                f"{e.self_device_time_total / e.count:.3f} us device time each, "
                f"{100 * e.self_device_time_total / dev_us:.2f}% of the kernels' time")


def _log_kernel_table(tag: str, events, what: str, wall_us: float, n: int = 1,
                      top: int = 12, skip: tuple[str, ...] = ()) -> float:
    """Logs one profile's device time by kernel (``events`` from
    ``key_averages()``, the keys in ``skip`` left out), over ``n`` runs of
    ``what`` that took ``wall_us`` each: wall and device busy per run, the
    launches and the ``top`` kernels.  Returns the device busy time per run
    in us, 0 (logged as not measured) when the profiler recorded none."""
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in skip]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels) / n
    if dev_us <= 0:
        log(f"[{tag}] the profiler recorded no device time: not measured")
        return 0.0
    each = "" if n == 1 else " a step"
    log(f"[{tag}] profile of {what}: wall {wall_us / 1e3:.3f} ms{each} (under the "
        f"profiler), device busy {dev_us / 1e3:.3f} ms{each} "
        f"({100 * dev_us / wall_us:.1f}%), {sum(e.count for e in kernels) // n} kernel "
        f"launches{each}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / n / 1e3
        log(f"[{tag}]   {ms:9.3f} ms{each} ({100 * ms * 1e3 / dev_us:5.1f}%) "
            f"{e.count // n:5d}x {e.key[:90]}")
    return dev_us


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
    dev_us = _log_kernel_table(tag, events, "one prefill", wall_us, skip=labels)
    if dev_us <= 0:
        return
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


def _decode_profile(cfg, params, prompt, s: int, tag: str) -> None:
    """Device time by kernel over three warm decode steps (under
    torch.profiler), after a prefill of ``prompt`` (``s`` positions) and
    its cache growth: wall and device busy per step, launches per step, the
    top kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve, steps
    n_steps = 3
    step = steps.make_serve_step(cfg)
    with torch.inference_mode():
        logits, cache = steps.make_prefill_step(cfg)(params, prompt)
        cache = serve._grow_attention_caches(cache, s, s + n_steps + 1)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        del logits
        step(params, tok, cache, s)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n_steps):
                step(params, tok, cache, s + 1 + i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / n_steps
    del cache
    _log_kernel_table(tag, prof.key_averages(), f"{n_steps} decode steps", wall_us,
                      n=n_steps, top=8)


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


def _f32_cross_check(tag: str, cfg32, b: int, what: str, prompt_len: int = 512,
                     gen: int = 4) -> None:
    """``cfg32`` (f32, TF32 off) served at ``prompt_len`` (512; a VLM's counts
    its media), ``gen`` tokens (4), from random weights (seed 1): the kernel
    path against plain PyTorch, every step's logits within
    ``SERVE_CROSS_TOL``, the same tokens and, in a model with MoE layers,
    the same router choices (routing is discontinuous: a flip would change
    a token's expert, not move its logits by a rounding)."""
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api
    from repro_torch.models.api import InputShape
    rng = torch.Generator(device="cuda").manual_seed(1)
    params = api.init(rng, cfg32, "cuda")
    prompt = api.synth_batch(rng, cfg32, InputShape("serve", prompt_len, b, "prefill"),
                             "cuda")
    out, routes = {}, {}
    for impl in ("kernel", "plain"):
        with _recorded_routes() as routes[impl]:
            out[impl] = serve_session(cfg32, b, prompt_len, gen, device="cuda",
                                      params=params, prompt=prompt, impl=impl,
                                      verbose=False)
    diffs = [float((k - p).abs().max())
             for k, p in zip(out["kernel"].logits, out["plain"].logits)]
    scale = max(float(x.abs().max()) for x in out["plain"].logits)
    same = torch.equal(out["kernel"].tokens, out["plain"].tokens)
    msg = (f"[{tag}] f32 cross-check B{b} prompt {prompt_len} gen {gen}, {what}: max abs "
           f"logit diff per step {[f'{d:.3g}' for d in diffs]} (tolerance "
           f"{SERVE_CROSS_TOL:g}; max |logit| {scale:.3g}); tokens equal: {same}")
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


def _count_flash(cfg, params, prompt, b: int, s: int, g: int, tag: str):
    """One counted ``serve_session`` run (the flash counters set to 0 just
    before it, read just after), peak memory reset first; returns the run,
    its flash launches and their split by head dim."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch.serve import serve_session
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
    return res, launches, by_d


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
    _check_residency(tag, cfg, params)
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    log(f"[{tag}] {cfg.name} full: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} head dim {hd} d_ff {cfg.d_ff} "
        f"({cfg.mlp_kind}) vocab {cfg.vocab_size} tied {cfg.tie_embeddings} "
        f"{cfg.param_dtype}, {n_params} params")
    # warm-up at full width (cuBLAS handles, kernel loads), then the counted run
    serve_session(cfg, b, 256, 2, device="cuda", params=params, verbose=False)
    res, launches, by_d = _count_flash(cfg, params, prompt, b, s, g, tag)
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


def phase_sharded_step() -> tuple[int, int, dict]:
    """The DTensor-propagated steps (``launch.steps`` ``make_sharded_*``) at
    mesh (1, 1) (``make_host_mesh``) over a one-rank NCCL group, every leaf
    a DTensor, the kernels launched on each rank's heads through
    ``models.sharded_heads``' ``local_map`` regions:

    * TinyLlama-1.1B at full width, bf16, B 4 x 4,096 prompt, 32 tokens,
      ``serve_session(..., mesh=mesh)``: 22 flash launches per prefill
      (counted over the sharded run), its logits and 32 greedy tokens held
      to the plain ``serve_session`` on the same seeded weights and prompt
      (bit-equal predicted at one rank; fails past ``SERVE_CROSS_TOL`` or on
      any token), both prefills' seconds;
    * one FedPart step of TinyLlama's ``blocks/7`` at full width in f32
      (TF32 off), B 4 x 512, Adam ``eps`` 1e-3: the sharded step's loss and
      updated leaves against the plain ``make_fedpart_train_step``'s within
      ``SHARDED_TRAIN_TOL``;
    * Zamba2-7B at full width cut to ``SHARDED_ZAMBA2_LAYERS`` of 81 layers,
      bf16, B 4 x 4,096: the sharded prefill's SSD launches (one per Mamba2
      layer, all through the wgmma body) and flash launches (one per
      chunk), its last logits against the plain prefill's.

    Returns the sharded runs' (flash, ssd_chunk) launches and the SSD
    launches by body."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api, transformer
    from repro_torch.models.api import InputShape
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.tree import tree_paths

    b, s, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    with _one_rank_group():
        mesh = make_host_mesh(1, 1, "cuda")
        cfg = get_config("tinyllama-1.1b")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = api.init(gen, cfg, "cuda")
        prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
        placed = sharding.shard_params(params, mesh)
        serve_session(cfg, b, 256, 2, device="cuda", params=placed, verbose=False,
                      mesh=mesh)
        plain, _, _ = _count_flash(cfg, params, prompt, b, s, g, "sharded_step/plain")
        torch.cuda.synchronize()
        flash_attention_kernel.launches = 0
        res = serve_session(cfg, b, s, g, device="cuda", params=placed, prompt=prompt,
                            verbose=False, mesh=mesh)
        torch.cuda.synchronize()
        flash_n = flash_attention_kernel.launches
        _log_serve_run("sharded_step", cfg, res, b, s, g)
        worst = max(float((x - y).abs().max()) for x, y in zip(res.logits, plain.logits))
        same = all(torch.equal(x, y) for x, y in zip(res.logits, plain.logits))
        log(f"[sharded_step] tinyllama-1.1b mesh (1, 1), NCCL: flash_attention launches "
            f"{flash_n} (one per layer: {cfg.num_layers}); logits vs plain serve: max "
            f"|diff| {worst:.3e}, bit-equal {same}; tokens equal "
            f"{torch.equal(res.tokens, plain.tokens)}; prefill {res.prefill_seconds:.6f} s "
            f"sharded vs {plain.prefill_seconds:.6f} s plain")
        if flash_n != cfg.num_layers:
            raise AssertionError(f"sharded prefill: flash launches {flash_n} != "
                                 f"{cfg.num_layers}")
        if worst > SERVE_CROSS_TOL or not torch.equal(res.tokens, plain.tokens):
            raise AssertionError(f"sharded serve vs plain: logits {worst}, tokens differ")
        del params, placed, prompt, res, plain
        torch.cuda.empty_cache()

        # one FedPart step, f32 (TF32 off), sharded against plain
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = api.init(gen, cfg32, "cuda")
        batch = api.synth_batch(gen, cfg32, InputShape("t", SHARDED_TRAIN[1],
                                                       SHARDED_TRAIN[0], "train"), "cuda")
        group = steps.list_groups(params)[SHARDED_TRAIN_GROUP]
        adam = AdamConfig(eps=1e-3)
        p_ref, _, l_ref = steps.make_fedpart_train_step(cfg32, group, adam)(
            params, steps.init_partial_opt_state(params, group), batch)
        placed = sharding.shard_params(params, mesh)
        opt = steps.shard_opt_state(steps.init_partial_opt_state(params, group),
                                    steps._select_group(placed, group))
        step = steps.make_sharded_train_step(cfg32, mesh, adam, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_new, _, loss = step(placed, opt, steps.shard_inputs(batch, mesh))
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        diffs = {"/".join(k): float((a.to_local() - b_).abs().max())
                 for (k, a), (_, b_) in zip(tree_paths(p_new), tree_paths(p_ref))}
        bad = {k: v for k, v in diffs.items() if v > SHARDED_TRAIN_TOL}
        ldiff = abs(float(loss.to_local()) - float(l_ref))
        log(f"[sharded_step] FedPart step {group.key}[{group.index}] f32 B "
            f"{SHARDED_TRAIN[0]} x {SHARDED_TRAIN[1]}: loss {float(l_ref):.6f}, sharded "
            f"vs plain |diff| {ldiff:.3e}; leaves worst |diff| {max(diffs.values()):.3e}, "
            f"bit-equal {sum(v == 0 for v in diffs.values())} of {len(diffs)}; "
            f"redistributed {step.redistributed}; sharded step {t_step:.3f} s")
        if ldiff > SHARDED_TRAIN_TOL or bad:
            raise AssertionError(f"sharded FedPart step vs plain: loss {ldiff}, {bad}")
        del params, placed, opt, p_new, p_ref, batch
        torch.cuda.empty_cache()

        # Zamba2-7B prefill, cut in depth: the SSD kernel under local_map
        cfg = get_config("zamba2-7b").with_(num_layers=SHARDED_ZAMBA2_LAYERS)
        n_chunks, tail = transformer.hybrid_layout(cfg)
        mamba_layers = n_chunks * cfg.attn_every + tail
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = api.init(gen, cfg, "cuda")
        prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
        with torch.inference_mode():
            ref, _ = steps.make_prefill_step(cfg)(params, prompt)
        placed = sharding.shard_params(params, mesh)
        step = steps.make_sharded_prefill_step(cfg, mesh)
        with torch.no_grad():
            step(placed, steps.shard_inputs(
                api.synth_batch(gen, cfg, InputShape("w", 256, b, "prefill"), "cuda"), mesh))
            torch.cuda.synchronize()
            ssd_chunk_kernel.launches = 0
            ssd_chunk_kernel.launches_by_body = dict.fromkeys(
                ssd_chunk_kernel.launches_by_body, 0)
            flash_attention_kernel.launches = 0
            t0 = time.perf_counter()
            logits, _ = step(placed, steps.shard_inputs(prompt, mesh))
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
        ssd_n, flash_z = ssd_chunk_kernel.launches, flash_attention_kernel.launches
        by_body = dict(ssd_chunk_kernel.launches_by_body)
        zdiff = float((logits.to_local() - ref).abs().max())
        log(f"[sharded_step] zamba2-7b cut to {cfg.num_layers} of 81 layers ({n_chunks} "
            f"chunks + {tail} tail), mesh (1, 1): ssd_chunk launches {ssd_n} (one per "
            f"Mamba2 layer: {mamba_layers}; by body {by_body}), flash_attention launches "
            f"{flash_z} (one per chunk: {n_chunks}); last logits vs plain prefill |diff| "
            f"{zdiff:.3e}, bit-equal {torch.equal(logits.to_local(), ref)}; prefill "
            f"{t_prefill:.6f} s")
        if ssd_n != mamba_layers or flash_z != n_chunks or by_body["wgmma"] != mamba_layers:
            raise AssertionError(f"zamba2 sharded prefill: ssd {ssd_n} ({by_body}), flash "
                                 f"{flash_z}")
        if not bool(torch.isfinite(logits.to_local()).all()) or zdiff > SERVE_CROSS_TOL:
            raise AssertionError(f"zamba2 sharded prefill vs plain: {zdiff}")
        del params, placed, prompt, logits, ref
        torch.cuda.empty_cache()
        _check_rank_heads()
    return flash_n + flash_z, ssd_n, by_body


class _RankOf:
    """Rank ``r``'s view of a (1, ``m``) ("data", "model") mesh: what
    ``sharded_heads.layout`` and ``offsets`` read of a ``DeviceMesh``."""

    mesh_dim_names = ("data", "model")

    def __init__(self, m: int, r: int):
        self.m, self.r = m, r

    def size(self, i: int) -> int:
        return (1, self.m)[i]

    def get_local_rank(self, i: int) -> int:
        return (0, self.r)[i]


def _check_rank_heads() -> None:
    """What each model rank's ``sharded_heads.sdpa`` region does, on the
    card, for the head layouts of ``SHARDED_HEAD_CASES``: bf16 q / k / v at
    B 4 x 4,096, placed as the model's ``split_heads`` places them (heads
    ``Shard(2)`` where they divide M), each rank's layout and offsets from
    ``layout`` / ``offsets``, its contiguous local blocks, and
    ``rank_sdpa`` (``kv_for_heads``, then the flash wrapper, causal) on
    them; the ranks' outputs joined over the heads (or, replicated, each
    equal to rank 0's) against the plain version at the flash tolerances,
    one batch row at a time.  These launches are checks, not the main
    path's."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention, sharded_heads

    def core(ql, kl, vl, _ml):
        return attention._sdpa(ql, kl, vl, None, "kernel", causal=True)

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, s = SERVE_BATCH, SERVE_PROMPT
    for tag, h, hkv, d, m, kind in SHARDED_HEAD_CASES:
        q, k, v = _flash_qkv(b, h, hkv, s, s, d, torch.bfloat16, gen)
        outs, kinds = [], set()
        for r in range(m):
            mesh = _RankOf(m, r)

            def view(x, n):
                return SimpleNamespace(device_mesh=mesh, shape=x.shape, ndim=x.ndim,
                                       placements=[Replicate(),
                                                   Shard(2) if n % m == 0 else Replicate()])

            qp, kvp, _ = sharded_heads.layout(view(q, h), h, hkv)
            b_off, s_off, h0, _ = sharded_heads.offsets(view(q, h), qp)
            kv_sharded = isinstance(kvp[1], Shard)
            ql = q.chunk(m, dim=2)[r].contiguous() if isinstance(qp[1], Shard) else q
            kl, vl = ((k.chunk(m, dim=2)[r].contiguous(), v.chunk(m, dim=2)[r].contiguous())
                      if kv_sharded else (k, v))
            h_loc = ql.shape[2]
            if kv_sharded:
                kinds.add("kv shard")
            elif h_loc == h:
                kinds.add("all heads")
            else:
                kk, _ = sharded_heads.kv_for_heads(kl, vl, h0, h_loc, h, hkv)
                shared = kk.untyped_storage().data_ptr() == kl.untyped_storage().data_ptr()
                kinds.add("one kv view" if shared else "per-head copy")
            outs.append(sharded_heads.rank_sdpa(core, ql, kl, vl, None, (b_off, s_off, h0),
                                                h, hkv, kv_sharded))
        if ", ".join(sorted(kinds)) != kind:
            raise AssertionError(f"rank heads {tag} M {m}: ranks ran {kinds}, not {kind}")
        if isinstance(qp[1], Shard):
            out = torch.cat(outs, dim=2)
        else:
            out = outs[0]
            if not all(torch.equal(o, out) for o in outs):
                raise AssertionError(f"rank heads {tag} M {m}: replicated ranks differ")
        errs = [_flash_agrees(out[i:i + 1], ops.attention_reference(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True), q[i:i + 1], (tag, m),
            torch.bfloat16) for i in range(b)]
        log(f"[sharded_step] rank heads {tag} H {h} / Hkv {hkv} D {d} at model {m}: "
            f"{m} ranks x {outs[0].shape[2]} heads ({kind}); joined vs "
            f"plain max abs err {max(e[0] for e in errs):.3e}, row err "
            f"{max(e[1] for e in errs):.3e}")
        del q, k, v, outs, out
        torch.cuda.empty_cache()



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
    _check_residency("serve_hybrid", cfg, params)
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
    _check_residency("serve_xlstm", cfg, params)
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


def _check_residency(tag: str, cfg, params) -> None:
    """The dry run's per-device parameter bytes of ``cfg`` at mesh (1, 1)
    (fake tensors, their placements) against the params on the card;
    fails on any difference.  Every placement is whole at (1, 1): this
    holds the fake init's shapes and dtypes to the card's, not the
    placements."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.tree import tree_leaves
    on_card = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    predicted = dryrun.param_residency(cfg, MeshShape((1, 1)))
    log(f"[{tag}] residency: the dry run's params per device at (1, 1) {predicted} B, "
        f"on the card {on_card} B: {'equal' if predicted == on_card else 'DIFFERENT'}")
    if predicted != on_card:
        raise AssertionError(f"{cfg.name}: dry-run residency {predicted} != {on_card}")


def _prefill_peak(cfg, params, batch: dict, impl: str) -> int:
    """Bytes the card's allocator held at the peak of one prefill
    (``steps.make_prefill_step``), above what was allocated before it."""
    from repro_torch.launch import steps
    step = steps.make_prefill_step(cfg, impl=impl)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = step(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    torch.cuda.empty_cache()
    return peak


def _log_peaks(tag: str, cfg, params, batch: dict, impl: str, what: str) -> None:
    """The dry run's predicted activation peak of a prefill of ``batch``
    (fake tensors, plain attention, mesh (1, 1)) beside the card's."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.api import InputShape
    b, s = batch["tokens"].shape
    trace, _ = dryrun.trace_step(cfg, InputShape("serve", s, b, "prefill"), MeshShape((1, 1)))
    measured = _prefill_peak(cfg, params, batch, impl)
    log(f"[{tag}] activation peak of a B{b} x {s} prefill ({what}): dry run "
        f"{int(trace.act_peak_bytes)} B ({trace.act_peak_bytes / 2**30:.3f} GiB, plain "
        f"attention), the card's allocator {measured} B ({measured / 2**30:.3f} GiB, "
        f"impl={impl}); card / dry run {measured / trace.act_peak_bytes:.4f}")


def phase_serve_moe():
    """The MoE serving path: first the f32 cross-check at full width, cut to
    ``SERVE_MOE_F32``: kernel against plain attention, the logits within
    ``SERVE_CROSS_TOL``, the same tokens and router choices.  Then
    ``serve_session`` on llama4-maverick-400b-a17b at full width (d_model
    5,120, 40 query heads over 8 kv heads of 128, 128 experts of 8,192 top-1
    plus a shared one, vocab 202,048), cut to ``SERVE_MOE_LAYERS`` of its 48
    layers, bf16, random weights from a seed, B 4 x 4,096 prompt, 32
    tokens; every prefill attention through the flash kernel at D 128 (one
    launch per layer), the expert products through cuBLAS.  One prefill
    under ``torch.profiler``, split by the MoE layer's parts.  Returns the
    counted run's flash launches, and the config, weights, prompt and run
    that ``phase_serve_moe_ep`` reuses (a list, which that phase empties so
    that the weights are freed before its f32 check)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api, moe
    from repro_torch.models.api import InputShape
    from repro_torch.tree import tree_leaves

    full = get_config("llama4-maverick-400b-a17b")
    cfg = full.with_(num_layers=SERVE_MOE_LAYERS)
    hd = cfg.resolved_head_dim
    b, s, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    cfg32 = full.with_(param_dtype="float32", activation_dtype="float32", **SERVE_MOE_F32)
    layer_gb = 4 * 3 * full.num_experts * full.d_model * full.moe_d_ff / 1e9
    _f32_cross_check("serve_moe", cfg32, b,
                     f"full width, {cfg32.num_layers} of {full.num_layers} layers and "
                     f"{cfg32.num_experts} of {full.num_experts} experts (one full layer's "
                     f"f32 experts are {layer_gb:.1f} GB), kernel vs plain attention")

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = api.init(gen, cfg, "cuda")
    prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _check_residency("serve_moe", cfg, params)
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
    res, launches, by_d = _count_flash(cfg, params, prompt, b, s, g, "serve_moe")
    log(f"[serve_moe] flash_attention launches {launches} (one per layer: "
        f"{cfg.num_layers}), by head dim {by_d}")
    if launches != cfg.num_layers or by_d != {hd: cfg.num_layers}:
        raise AssertionError(f"flash launches {launches} (by head dim {by_d}) != "
                             f"layers {cfg.num_layers} at D {hd}")
    _serve_profile(cfg, params, prompt, tag="serve_moe", labels=moe.PROFILE_LABELS)
    return launches, [cfg, params, prompt, res]


def phase_serve_moe_ep(state) -> int:
    """Expert parallelism (``models.moe_ep``) on ``serve_moe``'s weights and
    prompt, at mesh (1, 1) (``make_host_mesh``) over a one-rank NCCL group:
    ``serve_session`` under ``expert_parallel(mesh)``, its flash launches
    counted (one per layer at D 128), its prefill logits and every step's
    logits and tokens held to ``serve_moe``'s run (bit-equal expected at
    world size 1; fails past ``SERVE_CROSS_TOL`` or on any token), the
    layer's traffic per prefill (one all-reduce per MoE layer of B x S x
    d_model x 2 bytes: 167,772,160) and the prefill seconds beside
    ``serve_moe``'s.  The dry run's parameter residency equals the params
    on the card, and its predicted activation peak is printed beside the
    card's: at B 4 with the flash kernel, and at B ``PEAK_BATCH`` with plain
    attention, the dry run's own path.  Then the f32 check at
    ``SERVE_MOE_F32``: ``api.loss``'s gradients with and without expert
    parallelism, each leaf within ``EP_GRAD_TOL`` of its largest |gradient|.
    At one rank every all-reduce is an identity, so this holds the masked
    combine and shows that the autograd functions' collectives run on NCCL,
    not their reductions: those are held on the CPU over gloo at (1, 2) and
    (2, 2) (``tests/test_torch_moe_ep.py``) and wait for a four-card run.
    Returns the counted run's flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api, moe_ep
    from repro_torch.models.api import InputShape
    from repro_torch.models.layers import act_dtype
    from repro_torch.tree import tree_paths

    cfg, params, prompt, base = state
    state.clear()
    hd = cfg.resolved_head_dim
    b, s, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    n_moe = cfg.num_layers - cfg.first_dense_layers
    with _one_rank_group():
        mesh = make_host_mesh(1, 1, "cuda")
        with moe_ep.expert_parallel(mesh) as ep:
            serve_session(cfg, b, 256, 2, device="cuda", params=params, verbose=False)
            ep.traffic.clear()
            res, launches, by_d = _count_flash(cfg, params, prompt, b, s, g, "serve_moe_ep")
    log(f"[serve_moe_ep] mesh (1, 1) over a one-rank NCCL group; flash_attention launches "
        f"{launches} (one per layer: {cfg.num_layers}), by head dim {by_d}")
    if launches != cfg.num_layers or by_d != {hd: cfg.num_layers}:
        raise AssertionError(f"EP flash launches {launches} (by head dim {by_d}) != "
                             f"layers {cfg.num_layers} at D {hd}")
    diffs = [float((x.float() - y.float()).abs().max())
             for x, y in zip(res.logits, base.logits)]
    bit_equal = all(torch.equal(x, y) for x, y in zip(res.logits, base.logits))
    same = torch.equal(res.tokens, base.tokens)
    log(f"[serve_moe_ep] against serve_moe's run: prefill logits max abs diff {diffs[0]:.3g}, "
        f"every step's {max(diffs):.3g} (tolerance {SERVE_CROSS_TOL:g}); logits bit-equal "
        f"{bit_equal}; tokens equal {same}")
    if max(diffs) > SERVE_CROSS_TOL or not same:
        raise AssertionError("expert-parallel serving differs from serve_moe's")
    want = b * s * cfg.d_model * act_dtype(cfg).itemsize
    pre = [r for r in ep.traffic if r["tokens"] == b * s]
    log(f"[serve_moe_ep] per prefill: {len(pre)} MoE layer calls, all-reduce calls "
        f"{[r['all_reduce_calls'] for r in pre]} of {[r['all_reduce_bytes'] for r in pre]} B "
        f"(expected one per MoE layer: {n_moe} of {want} B); all-gathers "
        f"{sum(r['all_gather_calls'] for r in pre)}; decode steps {len(ep.traffic) - len(pre)} "
        f"calls of {b} tokens")
    if len(pre) != n_moe or any(r["all_reduce_calls"] != 1 or r["all_reduce_bytes"] != want
                                for r in pre):
        raise AssertionError("expert-parallel traffic is not one all-reduce per MoE layer")
    log(f"[serve_moe_ep] prefill {b}x{s}: {res.prefill_seconds:.6f} s with expert "
        f"parallelism, {base.prefill_seconds:.6f} s in serve_moe "
        f"(EP / serve_moe {res.prefill_seconds / base.prefill_seconds:.4f}); decode "
        f"{res.decode_seconds:.6f} s vs {base.decode_seconds:.6f} s")
    # each run's first logits are a view of its prefill's (B, S, V) f32 logits
    del res, base
    torch.cuda.empty_cache()
    _log_peaks("serve_moe_ep", cfg, params, prompt, "kernel",
               "the card's flash kernel against the dry run's plain scores")
    one = {"tokens": prompt["tokens"][:PEAK_BATCH]}
    _log_peaks("serve_moe_ep", cfg, params, one, "plain", "plain attention on both")
    del params, prompt
    torch.cuda.empty_cache()

    full = get_config("llama4-maverick-400b-a17b")
    cfg32 = full.with_(param_dtype="float32", activation_dtype="float32", **SERVE_MOE_F32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = api.init(gen, cfg32, "cuda")
    gb, gs = EP_GRAD_BATCH
    batch = api.synth_batch(gen, cfg32, InputShape("train", gs, gb, "train"), "cuda")
    loss0, g0 = steps.loss_and_grads(cfg32, params, batch, remat=False)
    with _one_rank_group():
        with moe_ep.expert_parallel(make_host_mesh(1, 1, "cuda")) as ep:
            loss1, g1 = steps.loss_and_grads(cfg32, params, batch, remat=False)
    torch.cuda.synchronize()
    worst, worst_path, equal = 0.0, "", 0
    for (path, a), (_, c) in zip(tree_paths(g0), tree_paths(g1)):
        rel = float((a - c).abs().max()) / max(float(a.abs().max()), 1e-30)
        equal += bool(torch.equal(a, c))
        if rel >= worst:
            worst, worst_path = rel, "/".join(path)
    n = len(tree_paths(g0))
    calls = {k: sum(r[k] for r in ep.traffic) for k in ("all_reduce_calls",
                                                       "grad_all_reduce_calls",
                                                       "aux_all_reduce_calls")}
    log(f"[serve_moe_ep] f32 gradients at full width, {cfg32.num_layers} layers, "
        f"{cfg32.num_experts} experts, B{gb} x {gs}: loss {float(loss0):.6f} without EP, "
        f"{float(loss1):.6f} with; worst leaf {worst_path} at {worst:.3g} of its largest "
        f"|gradient| (tolerance {EP_GRAD_TOL:g}); {equal} of {n} leaves bit-equal; "
        f"collectives {calls}")
    if worst > EP_GRAD_TOL or not math.isfinite(float(loss1)):
        raise AssertionError("expert-parallel gradients differ from the non-EP ones")
    del params, batch, g0, g1
    torch.cuda.empty_cache()
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
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api, attention, moe, moe_ep, transformer
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
    _check_residency("serve_mla", cfg, params)
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
    del res
    torch.cuda.empty_cache()

    # the MoE layer under FSDP expert parallelism at mesh (1, 1): the weight
    # all-gathers over "data" run, and the prefill equals the non-EP one
    prefill = steps.make_prefill_step(cfg)
    with _one_rank_group():
        with torch.inference_mode():
            want, _ = prefill(params, prompt)
            with moe_ep.expert_parallel(make_host_mesh(1, 1, "cuda"), fsdp=True) as ep:
                got, _ = prefill(params, prompt)
        torch.cuda.synchronize()
    diff = float((got.float() - want.float()).abs().max())
    calls = [(r["all_gather_calls"], r["all_reduce_calls"]) for r in ep.traffic]
    log(f"[serve_mla] FSDP expert parallelism at (1, 1), prefill B{b} x {s}: last-position "
        f"logits max abs diff {diff:.3g} against the non-EP prefill (tolerance "
        f"{SERVE_CROSS_TOL:g}), bit-equal {torch.equal(got, want)}; per MoE layer "
        f"(all-gathers, all-reduces) {calls}, all-gathered "
        f"{sum(r['all_gather_bytes'] for r in ep.traffic)} B")
    if diff > SERVE_CROSS_TOL or calls != [(3, 1)] * n_moe:
        raise AssertionError("FSDP expert-parallel prefill differs from the non-EP one")
    del got, want
    _log_peaks("serve_mla", cfg, params, prompt, "plain",
               "MLA has no kernel: its plain scores on both")
    del prompt
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


def phase_serve_encdec() -> int:
    """The encoder-decoder serving path: ``serve_session`` on whisper-small
    at full width (12 encoder and 12 decoder layers, d_model 768, 12 heads
    of 64, vocab 51,865, tied embedding), bf16, random weights from a seed,
    B 32 x 1,500 stub frames with a 416-token prompt, 32 tokens; every
    attention of the prefill through the flash kernel at D 64: 12 encoder
    self-attentions (non-causal, S 1,500), 12 decoder self-attentions
    (causal, S 416) and 12 cross-attentions (non-causal, Sq 416, Skv 1,500),
    36 launches.  One prefill under ``torch.profiler``.  Then the f32
    cross-check at full width (B 4 x 1,500 frames, the 416-token prompt, 4
    tokens, TF32 off): kernel against plain attention, every step's logits
    within ``SERVE_CROSS_TOL`` and the same tokens.  Returns the counted
    run's flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api
    from repro_torch.models.api import InputShape
    from repro_torch.tree import tree_leaves

    cfg = get_config("whisper-small")
    hd = cfg.resolved_head_dim
    b, s, g = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN
    per_prefill = cfg.encoder_layers + 2 * cfg.num_layers
    if cfg.encoder_seq != WHISPER_FRAMES or s + g > cfg.max_position_embeddings:
        raise AssertionError("serve_encdec's shapes no longer match whisper-small's")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(gen, cfg, "cuda")
    prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
    _check_residency("serve_encdec", cfg, params)
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    log(f"[serve_encdec] {cfg.name} full: {cfg.encoder_layers} encoder + {cfg.num_layers} "
        f"decoder layers, d_model {cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} "
        f"head dim {hd} d_ff {cfg.d_ff} ({cfg.mlp_kind}, {cfg.norm_kind}) vocab "
        f"{cfg.vocab_size} tied {cfg.tie_embeddings} {cfg.param_dtype}, {n_params} params; "
        f"frames {tuple(prompt['frames'].shape)}, tokens {tuple(prompt['tokens'].shape)}")
    # warm-up at the counted run's shapes (cuBLAS handles and heuristics, kernel
    # loads; the first prefill at a new shape took 0.199 s against 0.115 s in
    # two runs on an H100 80GB HBM3, 700 W), then the counted run
    serve_session(cfg, b, s, 2, device="cuda", params=params, verbose=False)
    res, launches, by_d = _count_flash(cfg, params, prompt, b, s, g, "serve_encdec")
    log(f"[serve_encdec] flash_attention launches {launches} (three per layer pair: "
        f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder self + {cfg.num_layers} "
        f"cross = {per_prefill}), by head dim {by_d}")
    if launches != per_prefill or by_d != {hd: per_prefill}:
        raise AssertionError(f"flash launches {launches} (by head dim {by_d}) != "
                             f"{per_prefill} at D {hd}")
    _serve_profile(cfg, params, prompt, tag="serve_encdec")
    _decode_profile(cfg, params, prompt, s, "serve_encdec")
    del params, prompt, res
    torch.cuda.empty_cache()

    fb, fs, fg = WHISPER_F32
    _f32_cross_check("serve_encdec", cfg.with_(param_dtype="float32",
                                               activation_dtype="float32"), fb,
                     f"full depth and width, {cfg.encoder_seq} frames, kernel vs plain "
                     f"(encoder, decoder and cross attention)", prompt_len=fs, gen=fg)
    return launches


def phase_serve_vlm() -> int:
    """The VLM serving path: ``serve_session`` on llava-next-34b at full width
    (d_model 7,168, 56 query heads over 8 kv heads of 128: a GQA group of 7,
    SwiGLU d_ff 20,480, vocab 64,000), cut in depth to ``SERVE_VLM_LAYERS``
    of its 60 layers, bf16, random weights from a seed, B 4 x 4,096 prompt
    positions (576 stub media embeddings, then 3,520 tokens), 32 tokens;
    every prefill attention through the flash kernel at D 128 (one launch
    per layer).  Fails unless ``VLM_FREE_GIB`` of the card stay free at the
    run's peak: the free memory the driver reports after the run, less what
    the allocator released since its reserved peak.  One prefill under ``torch.profiler``.  Then the
    f32 cross-check at full width, cut to ``SERVE_VLM_F32_LAYERS`` layers
    (B 4 x (576 + 512), 4 tokens, TF32 off): kernel against plain
    attention, every step's logits within ``SERVE_CROSS_TOL`` and the same
    tokens.  Returns the counted run's flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import api
    from repro_torch.models.api import InputShape
    from repro_torch.tree import tree_leaves

    full = get_config("llava-next-34b")
    cfg = full.with_(num_layers=SERVE_VLM_LAYERS)
    hd, m = cfg.resolved_head_dim, cfg.num_media_tokens
    b, s, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    torch.cuda.empty_cache()   # the free-memory check reads this phase's peak only
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = api.init(gen, cfg, "cuda")
    prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _check_residency("serve_vlm", cfg, params)
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    layer_params = sum(int(x.numel()) for x in tree_leaves(params["blocks"])) // cfg.num_layers
    log(f"[serve_vlm] {cfg.name} full width, {cfg.num_layers} of {full.num_layers} layers "
        f"(one layer: {layer_params} params, {2 * layer_params / 1e9:.3f} GB in bf16): "
        f"d_model {cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} (group "
        f"{cfg.num_heads // cfg.num_kv_heads}) head dim {hd} d_ff {cfg.d_ff} "
        f"({cfg.mlp_kind}) vocab {cfg.vocab_size} {cfg.param_dtype}, {n_params} params; "
        f"random init {init_s:.1f} s; media {tuple(prompt['media'].shape)}, tokens "
        f"{tuple(prompt['tokens'].shape)}")
    # warm-up at full width (cuBLAS handles, kernel loads), then the counted run
    serve_session(cfg, b, m + 64, 2, device="cuda", params=params, verbose=False)
    res, launches, by_d = _count_flash(cfg, params, prompt, b, s, g, "serve_vlm")
    free_now, total = torch.cuda.mem_get_info()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    free = (free_now - (reserved - torch.cuda.memory_reserved())) / 2**30
    layer_bytes = 2 * layer_params + 2 * 2 * b * (s + g) * cfg.num_kv_heads * hd
    log(f"[serve_vlm] flash_attention launches {launches} (one per layer: "
        f"{cfg.num_layers}), by head dim {by_d}; decode started at position {s} "
        f"({m} media + {s - m} tokens)")
    log(f"[serve_vlm] {cfg.num_layers} layers kept: peak device memory "
        f"{peak / 2**30:.3f} GiB allocated, {reserved / 2**30:.3f} GiB reserved, of "
        f"{total / 2**30:.3f} GiB: {free:.3f} GiB free at the peak by the driver's count "
        f"(CUDA context and all; {(total - reserved) / 2**30:.3f} GiB outside the reserved "
        f"peak) (limit "
        f"{VLM_FREE_GIB:g}); a layer's weights and K / V caches are "
        f"{layer_bytes / 2**30:.3f} GiB")
    if launches != cfg.num_layers or by_d != {hd: cfg.num_layers}:
        raise AssertionError(f"flash launches {launches} (by head dim {by_d}) != "
                             f"layers {cfg.num_layers} at D {hd}")
    if free < VLM_FREE_GIB:
        raise AssertionError(f"serve_vlm leaves {free:.3f} GiB free at its peak")
    del res
    _serve_profile(cfg, params, prompt, tag="serve_vlm")
    _decode_profile(cfg, params, prompt, s, "serve_vlm")
    del params, prompt
    torch.cuda.empty_cache()

    cfg32 = full.with_(param_dtype="float32", activation_dtype="float32",
                       num_layers=SERVE_VLM_F32_LAYERS)
    _f32_cross_check("serve_vlm", cfg32, b,
                     f"full width, {cfg32.num_layers} of {full.num_layers} layers, {m} media "
                     f"positions, kernel vs plain attention", prompt_len=m + 512)
    return launches


# ---------------------------------------------------------------------------
# The launchers: FedPart training of a served architecture, the simulation's
# command line, the paper's driver with its checkpoint, the DLG attack
# ---------------------------------------------------------------------------

SHARDED_TRAIN = (4, 512)       # the sharded FedPart step: B x S, f32, TF32 off
SHARDED_TRAIN_GROUP = 8        # steps.list_groups()[8]: TinyLlama's blocks/7
SHARDED_TRAIN_TOL = 1e-5       # sharded vs plain step at one rank, adam_eps 1e-3
SHARDED_ZAMBA2_LAYERS = 13     # 2 chunks of (shared attention, 6 Mamba2) + 1 tail of 81
# Each model rank's flash launch on its heads (``sharded_heads.layout`` /
# ``offsets`` / ``rank_sdpa``) for the head layouts a (1, M) mesh gives:
# (tag, heads, kv heads, head dim, M, what the ranks' K / V are).  Gemma's
# MQA (a view of its one kv head), LLaVA's GQA 7 with kv heads sharded (M
# 8), copied one kv head per query head where a rank's 4 heads cross a
# group (M 14; the others' sit in one) and replicated (M 16: 56 does not
# divide), TinyLlama's 4 kv heads fewer than M 8 (a one-head view).
SHARDED_HEAD_CASES = (("gemma-2b", 8, 1, 256, 4, "one kv view"),
                      ("llava-next-34b", 56, 8, 128, 8, "kv shard"),
                      ("llava-next-34b", 56, 8, 128, 14, "one kv view, per-head copy"),
                      ("llava-next-34b", 56, 8, 128, 16, "all heads"),
                      ("tinyllama-1.1b", 32, 4, 64, 8, "one kv view"))


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
# the claims run's books as fractions of FNU's: the reference's, pinned by
# tests/test_torch_claims.py
CLAIMS_COMM_RATIO = 0.28
CLAIMS_COMP_RATIO = 0.6859794101279911
# the quickstart's runs: (name, keyword arguments of examples.quickstart.run)
QUICKSTART_RUNS = (("sequential", {}), ("vmap", {"engine": "vmap"}),
                   ("shard_map", {"engine": "shard_map"}),
                   ("nested", {"plan": "nested", "capacity_tiers": (0.5, 1.0)}),
                   ("int8", {"compression": "int8"}),
                   ("population", {"population": 1_000_000, "cohort_size": 4}))
# FedPart's comm book of the quickstart (12 rounds, ResNet-8 with 8 classes)
# by compression: the reference's, pinned by tests/test_torch_examples.py
QUICKSTART_COMM = {"none": 1833888, "int8": 467244}
# launch.fedtrain's xLSTM-125m FedPart rounds at full width: an FNU round,
# then group 0
FEDTRAIN_XLSTM = ["--arch", "xlstm-125m", "--full-size", "--batch", "4", "--seq", "512",
                  "--rounds", "2", "--steps-per-round", "2"]
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


def phase_fedtrain_encdec() -> None:
    """FedPart training of whisper-small at full width on the card, through
    ``FedPartMeshTrainer`` (bf16, random weights from a seed): an FNU round,
    then a partial round on ``dec_blocks/0``, ``WHISPER_TRAIN`` (B 8 x
    1,500 frames and 416 tokens with labels, 2 steps a round; training
    differentiates ``impl="plain"``).  Seconds and peak memory of each; the
    loss finite; every leaf outside the group bit for bit unchanged by the
    partial round (the other 11 decoder layers of each ``dec_blocks`` leaf
    included) and some leaf of the group moved."""
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import FULL_NETWORK, RoundSpec
    from repro_torch.launch import fedtrain, steps
    from repro_torch.models import api
    from repro_torch.models.api import InputShape
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.tree import tree_leaves, tree_paths

    cfg = get_config("whisper-small")
    b, s, n_steps = WHISPER_TRAIN
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = api.init(gen, cfg, "cuda")
    trainer = fedtrain.FedPartMeshTrainer(cfg, AdamConfig())
    groups = trainer.groups(params)
    g = groups.index(steps.StackedGroup("dec_blocks", 0))
    shape = InputShape("t", s, b, "train")
    total = sum(int(x.numel()) for x in tree_leaves(params))
    log(f"[fedtrain_encdec] {cfg.name} full, {total} params, {len(groups)} groups "
        f"({', '.join(f'{x.key}/{x.index}' if x.index is not None else x.key for x in groups[:2])}, "
        f"..., {groups[-1].key}); B {b} x {cfg.encoder_seq} frames and {s} tokens, "
        f"{n_steps} steps a round")
    for spec in (RoundSpec(0, "warmup", -1, FULL_NETWORK), RoundSpec(1, "partial", 0, g)):
        batches = [api.synth_batch(gen, cfg, shape, "cuda") for _ in range(n_steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, loss = trainer.run_round(params, spec, batches)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        tx = trainer.transmitted_params(new, spec)
        name = "FNU" if spec.is_full else "dec_blocks/0"
        changed, outside = [], 0
        for (path, a), (_, old) in zip(tree_paths(new), tree_paths(params)):
            if spec.is_full:
                changed.append(not torch.equal(a, old))
            elif path[0] == "dec_blocks":
                if not torch.equal(a[1:], old[1:]):
                    raise AssertionError(f"{'/'.join(path)}: frozen decoder layers changed")
                changed.append(not torch.equal(a[0], old[0]))
            elif not torch.equal(a, old):
                raise AssertionError(f"{'/'.join(path)} changed outside dec_blocks/0")
            else:
                outside += 1
        log(f"[fedtrain_encdec] round {spec.index} {name}: loss {loss:.6f}, {secs:.6f} s, "
            f"peak device memory {peak:.3f} GiB, tx {tx} params; leaves moved "
            f"{sum(changed)} of {len(changed)}"
            + ("" if spec.is_full else
               f" (layer 0 of each dec_blocks leaf); bit for bit unchanged: the other "
               f"{cfg.num_layers - 1} layers of each and all {outside} leaves outside "
               f"dec_blocks"))
        if not math.isfinite(loss) or not any(changed):
            raise AssertionError(f"round {spec.index}: loss {loss}, nothing moved")
        params = new
    del params, new, batches, trainer
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


# ---------------------------------------------------------------------------
# The claims experiment and the examples (repro_torch.experiments / .examples)
# ---------------------------------------------------------------------------

def _check_launches(tag: str, launches: int, expected: int, what: str) -> None:
    log(f"[{tag}] masked_adam launches {launches} ({what}: {expected})")
    if launches != expected:
        raise AssertionError(f"{tag}: masked-Adam launches {launches} != {expected}")


def _check_accs(tag: str, res) -> None:
    accs = [h["acc"] for h in res.history if "acc" in h]
    losses = [h["loss"] for h in res.history]
    if not accs or not all(0.0 <= a <= 1.0 for a in accs) or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: accuracies {accs} or losses {losses} out of range")


def phase_claims() -> int:
    """``experiments.claims_experiment.run`` at the reference's defaults with
    ``fused_adam=True``: 25 FedPart rounds and the matched 25 FNU rounds, 4
    clients x 48 local steps each (200 samples: 6 batches of 32, 8 epochs)
    on the sequential engine, the first client's step sizes tracked.
    Masked-Adam launches equal the client-steps replayed from the server's
    draws (9,600); the books equal the reference's (``CLAIMS_COMM_RATIO``,
    ``CLAIMS_COMP_RATIO``, pinned by tests/test_torch_claims.py); every
    accuracy in [0, 1], both spikes finite.  The paper's direction (FedPart
    above FNU, a smaller spike) is reported, not asserted.  Returns the
    launches."""
    from repro_torch.core.schedule import matched_fnu
    from repro_torch.experiments import claims_experiment
    from repro_torch.kernels.masked_adam import MaskedAdamCohort

    _, clients, _, sched, cfg = claims_experiment.build(fused_adam=True)
    expected = _expected_launches(clients, [sched.rounds(), matched_fnu(sched).rounds()],
                                  cfg)
    MaskedAdamCohort.launches = 0
    out = claims_experiment.run(fused_adam=True, verbose=False)
    torch.cuda.synchronize()
    launches = MaskedAdamCohort.launches

    fp, fnu = out["fedpart"], out["fnu"]
    n_rounds = len(fp["acc_curve"]) + len(fnu["acc_curve"])
    for name, r in (("FedPart", fp), ("FNU", fnu)):
        log(f"[claims] {name}: best acc {r['best_acc']:.6f} final acc "
            f"{r['final_acc']:.6f} post-aggregation spike {r['spike']:.6f}; acc curve "
            f"{[round(a, 4) for a in r['acc_curve']]}")
    log(f"[claims] books (FedPart / FNU): comm {fp['comm_ratio']!r} (pinned "
        f"{CLAIMS_COMM_RATIO!r}), comp {fp['comp_ratio']!r} (pinned "
        f"{CLAIMS_COMP_RATIO!r}); {out['local_epochs']} local epochs, {n_rounds} "
        f"rounds in {out['elapsed_s']:.3f} s, {out['elapsed_s'] / n_rounds:.4f} s per "
        f"round; the paper's direction: FedPart best acc above FNU's "
        f"{fp['best_acc'] > fnu['best_acc']}, FedPart spike below FNU's "
        f"{fp['spike'] < fnu['spike']}")
    _check_launches("claims", launches, expected, "client-steps, replayed")
    if fp["comm_ratio"] != CLAIMS_COMM_RATIO or fp["comp_ratio"] != CLAIMS_COMP_RATIO:
        raise AssertionError("claims: the books differ from the reference's")
    for r in (fp, fnu):
        if not all(0.0 <= a <= 1.0 for a in r["acc_curve"]) or \
                not math.isfinite(r["spike"]):
            raise AssertionError(f"claims: accuracies or spike out of range: {r}")
    return launches


def _examples_quickstart() -> dict:
    """The quickstart's six runs; masked-Adam launches by engine."""
    from repro_torch.core.schedule import matched_fnu
    from repro_torch.examples import quickstart
    from repro_torch.kernels.masked_adam import MaskedAdamCohort

    launches = {"sequential": 0, "vmap": 0, "shard_map": 0}
    for name, kw in QUICKSTART_RUNS:
        ctx = _one_rank_group() if kw.get("engine") == "shard_map" else \
            contextlib.nullcontext()
        with ctx:
            _, clients, _, sched, cfg = quickstart.build(fused_adam=True, **kw)
            expected = _expected_launches(
                clients, [sched.rounds(), matched_fnu(sched).rounds()], cfg)
            MaskedAdamCohort.launches = 0
            t0 = time.perf_counter()
            fp, fnu = quickstart.run(fused_adam=True, verbose=False, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = MaskedAdamCohort.launches
        launches[cfg.engine] += n
        tag = f"examples quickstart {name}"
        log(f"[{tag}] FedPart best acc {fp.best_acc:.4f} comm {fp.comm_total_bytes} B "
            f"comp {fp.comp_total_flops / fp.comp_fnu_flops:.4%} of FNU; FNU best acc "
            f"{fnu.best_acc:.4f} comm {fnu.comm_total_bytes} B; {secs:.3f} s, "
            f"{statistics.median(h['seconds'] for h in fp.history + fnu.history):.4f} s "
            f"per round (median)")
        _check_launches(tag, n, expected, "client-steps" if cfg.engine == "sequential"
                        else "bucket-steps, replayed")
        book = QUICKSTART_COMM[cfg.compression]
        if fp.comm_total_bytes != book:
            raise AssertionError(f"{tag}: FedPart comm {fp.comm_total_bytes} B != {book}")
        for res in (fp, fnu):
            _check_accs(tag, res)
    return launches


def _examples_fl() -> tuple[int, int]:
    """fedpart_language, fedpart_ablations and fedpart_async; returns the
    (one-client, cohort) masked-Adam launches."""
    from repro_torch.core.schedule import matched_fnu
    from repro_torch.examples import fedpart_ablations, fedpart_async, fedpart_language
    from repro_torch.fl.population import as_population
    from repro_torch.kernels.masked_adam import MaskedAdamCohort

    _, clients, _, sched = fedpart_language.build()
    expected = sum(_expected_launches(clients,
                                      [sched.rounds(), matched_fnu(sched).rounds()],
                                      fedpart_language.run_config(a, fused_adam=True))
                   for a in fedpart_language.ALGOS)
    MaskedAdamCohort.launches = 0
    t0 = time.perf_counter()
    out = fedpart_language.run(fused_adam=True, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    seq = lang = MaskedAdamCohort.launches
    for algo, (fp, fnu) in out.items():
        log(f"[examples language] {algo}: FedPart best acc {fp.best_acc:.4f} (comm "
            f"{fp.comm_total_bytes / fp.comm_fnu_bytes:.1%} of FNU) | FNU best acc "
            f"{fnu.best_acc:.4f}")
        for res in (fp, fnu):
            _check_accs(f"examples language {algo}", res)
    log(f"[examples language] 4 runs in {secs:.3f} s")
    _check_launches("examples language", lang, expected, "client-steps, replayed")

    expected = 0
    for order in fedpart_ablations.ORDERS:
        _, clients, _, sched, cfg = fedpart_ablations.build(order, fused_adam=True)
        expected += _expected_launches(clients, [sched.rounds()], cfg)
    for warmup in fedpart_ablations.WARMUPS:
        _, clients, _, sched, cfg = fedpart_ablations.build(warmup=warmup,
                                                            fused_adam=True)
        expected += _expected_launches(clients, [sched.rounds()], cfg)
    MaskedAdamCohort.launches = 0
    t0 = time.perf_counter()
    out = fedpart_ablations.run(fused_adam=True, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    abl = MaskedAdamCohort.launches
    seq += abl
    log(f"[examples ablations] best acc " + ", ".join(
        f"{k}={v}: {res.best_acc:.4f}" for (k, v), res in out.items())
        + f"; 6 runs in {secs:.3f} s")
    for res in out.values():
        _check_accs("examples ablations", res)
    _check_launches("examples ablations", abl, expected, "client-steps, replayed")

    adapter, data, _ = fedpart_async.setup(8)
    rounds = fedpart_async.schedule_rounds()
    MaskedAdamCohort.launches = 0
    t0 = time.perf_counter()
    out = fedpart_async.run(fused_adam=True, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cohort = MaskedAdamCohort.launches
    expected = 0
    for (name, res), (_, cfg) in zip(out.items(), fedpart_async.variants(fused_adam=True)):
        tl = res.timeline
        tta = tl.time_to_accuracy(0.5)
        log(f"[examples async] {name}: merges {len(tl.of_kind('merge'))}, virtual "
            f"{tl.total_seconds:.4f} s, best acc {res.best_acc:.4f}, tta@0.50 "
            f"{'never' if math.isinf(tta) else f'{tta:.4f} s'}, overlap "
            f"{tl.overlap_seconds():.4f} s, host s {sum(res.host_seconds.values()):.4f}")
        if not tl.of_kind("merge") or not math.isfinite(tl.total_seconds):
            raise AssertionError(f"examples async {name}: no merge or a non-finite total")
        _check_accs(f"examples async {name}", res)
        expected += _async_expected_launches(tl, as_population(data), rounds, cfg)
    log(f"[examples async] 3 variants in {secs:.3f} s")
    _check_launches("examples async", cohort, expected,
                    "bucket-steps of every launched cohort, from the dispatch events")
    return seq, cohort


def _examples_mesh_training() -> None:
    """fedpart_mesh_training at its defaults, then launch.fedtrain's xLSTM
    round at full width (``FEDTRAIN_XLSTM``)."""
    from repro_torch.examples import fedpart_mesh_training
    from repro_torch.launch import fedtrain
    from repro_torch.tree import tree_leaves

    for tag, run in (("examples mesh_training", fedpart_mesh_training.run),
                     ("examples fedtrain_xlstm", lambda: fedtrain.run_mesh(
                         fedtrain.parse_args(FEDTRAIN_XLSTM)))):
        torch.cuda.empty_cache()
        params, records = run()
        torch.cuda.synchronize()
        n_params = sum(int(x.numel()) for x in tree_leaves(params))
        for r in records:
            log(f"[{tag}] round {r['round']} group {r['group']}: loss {r['loss']:.6f}, "
                f"{r['seconds']:.4f} s, peak {r['peak_bytes'] / 2**30:.3f} GiB, tx "
                f"{r['tx']} of {n_params} params")
        if not all(math.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"{tag}: non-finite loss")
        del params
    torch.cuda.empty_cache()


def _examples_serve_llm() -> tuple[int, int, dict]:
    """serve_llm on each of ``ASSIGNED_ARCHS`` at its smoke config (f32): the
    flash / SSD launches of the counted kernel session equal
    ``serve_llm.kernel_launches``; an ``impl="plain"`` session on the same
    weights and prompt (same seed) gives the same tokens, every step's
    logits within the kernels' f32 tolerances (abs + rel; SSD's where a
    scan runs).  Returns the flash and SSD launches and the SSD launches by
    body."""
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.examples import serve_llm
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel

    flash = ssd = 0
    by_body = dict.fromkeys(ssd_chunk_kernel.launches_by_body, 0)
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch, smoke=True)
        want = serve_llm.kernel_launches(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention_kernel.launches = 0
        flash_attention_kernel.launches_by_head_dim = {}
        ssd_chunk_kernel.launches = 0
        ssd_chunk_kernel.launches_by_body = dict.fromkeys(ssd_chunk_kernel.launches_by_body,
                                                          0)
        res = serve_llm.run(arch=arch, verbose=False)
        torch.cuda.synchronize()
        got = flash_attention_kernel.launches, ssd_chunk_kernel.launches
        by_d = dict(flash_attention_kernel.launches_by_head_dim)
        bodies = {k: v for k, v in ssd_chunk_kernel.launches_by_body.items() if v}
        plain = serve_llm.run(arch=arch, impl="plain", verbose=False)
        tol = SSD_TOL[torch.float32] if want[1] else FLASH_TOL[torch.float32]
        excess = max(float(((k - p).abs() - tol * (1 + p.abs())).max())
                     for k, p in zip(res.logits, plain.logits))
        diff = max(float((k - p).abs().max()) for k, p in zip(res.logits, plain.logits))
        same = torch.equal(res.tokens, plain.tokens)
        log(f"[examples serve_llm] {arch} ({cfg.param_dtype}): flash {got[0]} (by head "
            f"dim {by_d}), ssd {got[1]} ({bodies}); expected {want}; prefill "
            f"{res.prefill_seconds:.6f} s, decode {res.decode_seconds:.6f} s; tokens "
            f"{tuple(res.tokens.shape)} equal to the plain session's: {same}; max abs "
            f"logit diff {diff:.3g} (tolerance {tol:g} abs + rel)")
        if got != want or not same or excess > 0:
            raise AssertionError(f"serve_llm {arch}: launches {got} != {want}, or tokens "
                                 f"/ logits differ from the plain session")
        _log_serve_run(f"examples serve_llm {arch}", cfg, res, 4, 32, 12)
        flash, ssd = flash + got[0], ssd + got[1]
        for body, n in bodies.items():
            by_body[body] += n
    return flash, ssd, by_body


def phase_examples() -> dict:
    """The six examples (``repro_torch.examples``) through their ``run``
    functions at the reference's defaults, ``fused_adam=True`` for the FL
    ones: the quickstart on the sequential, vmap and shard_map engines (the
    last over a one-rank NCCL group made here, which the engine's client
    mesh joins), a nested plan, int8 compression and a streamed population
    of 10**6; fedpart_language (FedAvg and FedProx), fedpart_ablations (6
    runs), fedpart_async (3 variants, two cohorts in flight on one slot);
    fedpart_mesh_training (TinyLlama smoke) and the xLSTM-125m FedPart round
    at full width; serve_llm on the ten assigned architectures.  Masked-Adam
    launches equal the client-steps / bucket-steps each time.  Returns the
    launches by path."""
    quick = _examples_quickstart()
    seq, cohort = _examples_fl()
    _examples_mesh_training()
    flash, ssd, ssd_bodies = _examples_serve_llm()
    return {"examples_seq": quick["sequential"] + seq,
            "examples_vmap": quick["vmap"] + cohort,
            "examples_shard": quick["shard_map"], "flash": flash, "ssd": ssd,
            "ssd_bodies": ssd_bodies}


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
    flash_moe, moe_state = _timed(phase_serve_moe)
    flash_moe_ep = _timed(phase_serve_moe_ep, moe_state)
    _timed(phase_serve_mla)
    flash_encdec = _timed(phase_serve_encdec)
    flash_vlm = _timed(phase_serve_vlm)
    flash_sharded, ssd_sharded, sharded_bodies = _timed(phase_sharded_step)
    ssd["launches_by_path"] = {"serve_hybrid": ssd_hybrid, "serve_xlstm": ssd_xlstm,
                               "sharded_step": ssd_sharded}
    ssd["launches"] = sum(ssd["launches_by_path"].values())
    ssd["launches_by_body"] = {"serve_hybrid": hybrid_bodies, "serve_xlstm": xlstm_bodies,
                               "sharded_step": sharded_bodies}
    flash["launches_by_path"] = {"serve": flash_serve, **flash_dense,
                                 "serve_hybrid": flash_hybrid, "serve_moe": flash_moe,
                                 "serve_moe_ep": flash_moe_ep,
                                 "serve_encdec": flash_encdec, "serve_vlm": flash_vlm,
                                 "sharded_step": flash_sharded}
    flash["launches"] = sum(flash["launches_by_path"].values())
    _timed(phase_fedtrain_llm)
    _timed(phase_fedtrain_encdec)
    sim_seq_n, sim_vmap_n = _timed(phase_fedtrain_sim)
    _timed(phase_train_cli)
    _timed(phase_dlg)
    claims_n = _timed(phase_claims)
    examples = _timed(phase_examples)
    log(f"[time] all phases {time.perf_counter() - t_start:.1f} s")
    flash["launches_by_path"]["serve_llm"] = examples["flash"]
    flash["launches"] = sum(flash["launches_by_path"].values())
    ssd["launches_by_path"]["serve_llm"] = examples["ssd"]
    ssd["launches_by_body"]["serve_llm"] = examples["ssd_bodies"]
    ssd["launches"] = sum(ssd["launches_by_path"].values())
    adam["launches_by_path"] = {"fedpart": fedpart_n, "nlp": nlp_seq_n,
                                "fedtrain_sim": sim_seq_n, "claims": claims_n,
                                "examples_seq": examples["examples_seq"]}
    cohort["launches_by_path"] = {"fedpart_vmap": fedpart_vmap_n,
                                  "fedpart_shard": fedpart_shard_n, "nlp": nlp_vmap_n,
                                  "compress": compress_n, "async": async_n,
                                  "fedtrain_sim": sim_vmap_n,
                                  "examples_vmap": examples["examples_vmap"],
                                  "examples_shard": examples["examples_shard"]}
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
