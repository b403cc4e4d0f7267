// Flash attention, forward, for Hopper (sm_90a): online softmax over tiles
// of keys, with GQA head sharing, causal and sliding-window masks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py,
// `_attn_kernel` (launched by `flash_attention_kernel`, reached through
// `ops.flash_attention` from `models/attention.py` `_sdpa(impl="pallas")`).
//
// What it computes, for every batch b, query head h and query row i:
//   s_j = (q_i . k_j) / sqrt(D)          over keys j of kv head h / (H/Hkv)
//   keep j where  j < kv_len,  j <= i (causal),  j > i - window (window > 0)
//   o_i = sum_j softmax(s)_j v_j         (f32 scores, sums and accumulator;
//                                         stored in q's dtype)
// Causal is aligned top-left (key j against query row i by absolute index),
// as the reference aligns it, also when Sq != Skv.
//
// Bound: operations.  Per kept (query, key) pair and head, 2·D FLOPs for
// q.k and 2·D for p·v; TinyLlama's prefill layer (B 4, H 32, Hkv 4,
// S 4,096, D 64, causal) is 2.75e11 FLOPs against 151 MB of q, k, v and o:
// 0.278 ms at the card's 989 TFLOP/s bf16 tensor-core peak, 0.045 ms of
// bytes at 3.35 TB/s; Zamba2's shared attention (H 32 = Hkv 32, D 112) is
// 0.487 ms; Gemma-2b's (H 8, Hkv 1, D 256) is the same 2.75e11 FLOPs as
// TinyLlama's, 0.278 ms.  Only Hopper's `wgmma` reaches that peak, and only
// when its operands arrive in shared memory without costing the tensor
// cores' issue slots, so the input dtype picks one of two bodies:
//
// - bfloat16 (the serving path): the Hopper design.  One CTA of three
//   warpgroups (384 threads) per (query tile of 128 rows, head, batch):
//   * a producer warpgroup (registers lowered to 40 with `setmaxnreg`), one
//     thread of which issues TMA loads: the Q tile once, then K and V tiles
//     of BK keys (128, or 64 at DP 256) into a two-stage ring.  Each stage
//     has a "full" mbarrier for K and one for V (arrive.expect_tx with the
//     K or V tile's bytes; the TMA completes the transaction) and an
//     "empty" mbarrier that both
//     consumers arrive on once the P·V product that read the stage has
//     retired.
//   * two consumer warpgroups (registers raised to 232), each owning 64
//     query rows: S = Q Kᵀ as `wgmma.mma_async m64n{BK}k16` with Q and K
//     read from shared memory through descriptors (128-byte swizzle,
//     K-major), DP/16 k-steps; the online softmax in registers (the
//     accumulator gives each thread two rows, reduced over the quad with
//     shuffles; exp2f with scale·log2(e) folded into one FMA; masks only on
//     edge tiles); then O += P V as `wgmma m64n{DP}k16` with P from
//     registers (the score accumulator's n-tiles 2kk and 2kk+1, rounded to
//     bf16, are the A fragment of k-step kk) and V from shared memory as an
//     MN-major operand.
//   * tensor maps (built per launch with cuTensorMapEncodeTiled, found
//     through the runtime's entry-point query, so no -lcuda) describe q, k
//     and v as 4-d (D, S, heads, B) arrays with the caller's byte strides,
//     boxes of {64, 128} for q and {64, BK} for k and v, 128-byte swizzle
//     and zero fill out of bounds: ragged S and D < DP arrive as zeros
//     (a column block wholly past D as a box of zeros), and no thread
//     computes an address.
//   * DP is 64 (D <= 64), 128 (D <= 128; D 96 and 112 run here) or 256
//     (D <= 256; Gemma's 256, and 136 .. 248).  A tile is DP/64 column
//     blocks of its rows x 128 bytes.  Shared memory: Q 16 KB + 2 stages x
//     (K 16 KB + V 16 KB) = 80 KB at DP 64, Q 32 KB + 2 x (32 + 32 KB) =
//     160 KB at DP 128, both with 128-key tiles.  At DP 256 a 128-key ring
//     would need Q 64 KB + 2 x (64 + 64 KB) = 320 KB, past the 227 KB a
//     block may opt in to, so K and V tiles hold 64 keys: Q 64 KB + 2 x
//     (32 + 32 KB) = 192 KB (S = Q Kᵀ is m64n64k16 over 16 k-steps, P·V
//     m64n256k16 over 4; a causal 128-row query tile meets two 64-key
//     diagonal tiles).  Plus 1 KB of alignment slack and the barriers.
//     Registers of a consumer thread at DP 256: O 128 f32, S 32, P 16
//     (packed bf16), under the 232 `setmaxnreg` gives it.  One CTA per SM
//     (the consumers' registers).
//   * Left for later: one warpgroup's softmax overlapping the other's
//     GEMMs (FA3's ping-pong), S and P·V of consecutive tiles in flight
//     together, persistent CTAs, packing GQA query heads into one CTA.
//     Both consumers wait on the same barriers, so they run nearly in step:
//     their softmaxes contend for the same issue slots and exp2 units while
//     the tensor cores idle (kernels/flash_attention/phase_timing.py
//     measures it; times in PERF.md).
// - float32: f32 FMAs on the CUDA cores, as the reference's f32 math does
//   it (tensor cores would round to TF32).  One CTA of 128 threads per
//   (query tile of 64 rows, head, batch) walks key tiles of 64; thread
//   (rg, cg) = (tid / 8, tid % 8) owns score rows rg + 16i (i < 4) and
//   columns cg + 8j (j < 8); rows in shared memory are padded by 4 floats
//   so the float4 reads of the 8 column groups fall in distinct banks.
//   DP is 32, 64, 96, 128 or 256; at DP 256 Q, K, V and P take 212 KB.
//   Only the f32 cross-checks run it.
// Both:
// - GQA: the kv head is read in place (no repeated K/V in memory).
// - Tiles wholly above the diagonal (causal) or below the window are never
//   loaded: the loop starts and ends at the first and last tile that can
//   hold a kept key.  Query tiles run heaviest first (the last tile of a
//   causal sequence does the most work).
// - Ragged edges: rows >= Sq and keys >= kv_len are zero-filled and
//   masked; D is padded with zeros (a zero lane adds nothing to q.k or to
//   the output it is not stored to); the scale uses the true D.
// - A masked score gets probability exactly 0 (the reference's -1e30
//   sentinel gives the same 0 once a row has a kept key).  A row with no
//   kept key at all ends with l = 0 and is stored as 0, never NaN or inf.
// - No fast-math: IEEE expf / exp2f and division.

#include "hopper.cuh"


// Mirrored by ctypes.Structure `_Params` in kernels/flash_attention/kernel.py;
// keep the field order and types in step.
struct FlashParams {
  const void* q;            // (B, H, Sq, D) by the strides below
  const void* k;            // (B, Hkv, Skv, D)
  const void* v;            // (B, Hkv, Skv, D)
  void* o;                  // (B, H, Sq, D), q's dtype
  long long q_stride[3];    // batch, head, row strides in elements; D is unit-stride
  long long k_stride[3];
  long long v_stride[3];
  long long o_stride[3];
  int batch, heads, kv_heads, sq, skv, head_dim, kv_len;
  int causal, window;       // window 0 = no sliding window
  int dtype;                // 0 = float32, 1 = bfloat16
  float scale;              // 1 / sqrt(head_dim)
};

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// ---- float32: CUDA-core version (f32 FMAs, as the reference's f32 math) ----

template <int DP>
constexpr int f32_smem_bytes() {
  return (3 * kBQ * (DP + 4) + kBQ * (kBK + 4)) * static_cast<int>(sizeof(float));
}

static_assert(f32_smem_bytes<256>() <= 232448, "DP 256 exceeds the opt-in shared memory");

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const FlashParams p) {
  constexpr int LD = DP + 4;      // padded row of Qs / Ks / Vs, in floats
  constexpr int LDP = kBK + 4;    // padded row of Ps
  constexpr int NC = DP / 32;     // float4 output chunks a thread owns per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;                     // [kBK][LD]
  float* Vs = Ks + kBK * LD;                     // [kBK][LD]
  float* Ps = Vs + kBK * LD;                     // [kBQ][LDP]

  const int tid = threadIdx.x;
  const int cg = tid & 7;
  const int rg = tid >> 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int D = p.head_dim;

  const float* q = static_cast<const float*>(p.q) + b * p.q_stride[0] + h * p.q_stride[1];
  const float* k = static_cast<const float*>(p.k) + b * p.k_stride[0] + hk * p.k_stride[1];
  const float* v = static_cast<const float*>(p.v) + b * p.v_stride[0] + hk * p.v_stride[1];
  float* o = static_cast<float*>(p.o) + b * p.o_stride[0] + h * p.o_stride[1];

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float x = 0.f;
    if (q0 + r < p.sq && d < D) x = q[(q0 + r) * p.q_stride[2] + d];
    Qs[r * LD + d] = x;
  }

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // Key tiles that can hold a kept key for some row of this query tile.
  int k_lo = 0, k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, q0 + kBQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_hi = (k_hi + kBK - 1) / kBK;

  for (int t = k_lo / kBK; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's reads of Ks / Vs / Ps are done
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int c = idx / DP, d = idx % DP;
      const bool in = k0 + c < p.kv_len && d < D;
      Ks[c * LD + d] = in ? k[(k0 + c) * p.k_stride[2] + d] : 0.f;
      Vs[c * LD + d] = in ? v[(k0 + c) * p.v_stride[2] + d] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(rg + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(cg + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg + 16 * i;
      unsigned kept = 0u;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + cg + 8 * j;
        const bool ok = kj < p.kv_len && (!p.causal || kj <= qi) &&
                        (p.window <= 0 || kj > qi - p.window);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        kept |= ok ? (1u << j) : 0u;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = (kept >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        Ps[(rg + 16 * i) * LDP + cg + 8 * j] = pj;
        sum += pj;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();  // Ps is complete

#pragma unroll 2
    for (int c4 = 0; c4 < kBK; c4 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(rg + 16 * i) * LDP + c4]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vs[(c4 + cc) * LD + 4 * (cg + 8 * c)]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pc = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(pc, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pc, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pc, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pc, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (cg + 8 * c) + e;
        if (d < D) o[qi * p.o_stride[2] + d] = acc[i][c][e] / denom;
      }
  }
}


// ---- bfloat16: Hopper version (TMA, wgmma, warp specialisation) ----

constexpr int kQTile = 128;                // query rows per CTA (two warpgroups of 64)
constexpr int kWG = 128;                   // threads per warpgroup
constexpr int kBf16Threads = 3 * kWG;      // consumers 0 and 1, producer 2
constexpr int kStages = 2;                 // depth of the K/V ring
constexpr int kBox = 64;                   // bf16 per 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kProducerRegs = 40;          // 40·128 + 232·256 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the bf16 body, in bytes from a 1024-aligned base (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes, and both the TMA and
// the wgmma descriptors assume tiles start on that boundary).  A tile is
// DP/64 column blocks of its rows x 128 bytes: the Q tile 128 rows, a K or V
// tile kKeys rows (128 keys up to DP 128, 64 at DP 256, where 128-key tiles
// would need 320 KB).
template <int DP>
struct Bf16Smem {
  static constexpr int kKeys = DP <= 128 ? 128 : 64;                  // keys per K/V tile
  static constexpr int kQCol = kQTile * kRowBytes;                    // one Q column block
  static constexpr int kKVCol = kKeys * kRowBytes;                    // one K/V column block
  static constexpr int kQBytes = (DP / kBox) * kQCol;
  static constexpr int kKVBytes = (DP / kBox) * kKVCol;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                    // [kStages] tiles
  static constexpr int kV = kK + kStages * kKVBytes;         // [kStages] tiles
  static constexpr int kBar = kV + kStages * kKVBytes;       // q_full, k_full[], v_full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;   // + alignment slack
};
static_assert(Bf16Smem<256>::kBytes <= 232448, "DP 256 exceeds the opt-in shared memory");

// Online-softmax update of one thread's two rows of a 64 x (2·NS) score
// tile, in place: raw scores become probabilities, the running max /
// denominator move, and the output accumulator is rescaled.
// s[4j + 2·half + e] is row r_lo + 8·half, key k0 + 8j + 2·(lane % 4) + e
// (the wgmma accumulator layout).  The max is kept in raw-score units and
// `c` = scale·log2(e), so exp(scale·(x - m)) = exp2f(x·c - m·c), one FMA per
// score.  kMasked: apply
// the kv_len / causal / window masks (edge tiles only; an interior tile
// keeps every key).
template <bool kMasked, int NS, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m_i)[2],
                                             float (&l_i)[2], float (&o)[NO],
                                             const FlashParams& p, float c, int r_lo,
                                             int k0, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = r_lo + 8 * half;
    unsigned kept = 0xffffffffu;   // bit 2j + e: key kept
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * half + e];
        if (kMasked) {
          const int kj = k0 + 8 * j + 2 * (lane & 3) + e;
          const bool ok = kj < p.kv_len && (!p.causal || kj <= qi) &&
                          (p.window <= 0 || kj > qi - p.window);
          if (!ok) {
            x = kNegInf;
            kept &= ~(1u << (2 * j + e));
          }
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i[half], mx);
    const float alpha = exp2f((m_i[half] - m_new) * c);
    const float mc = m_new * c;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * half + e];
        x = (!kMasked || ((kept >> (2 * j + e)) & 1u)) ? exp2f(fmaf(x, c, -mc)) : 0.f;
        sum += x;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_i[half] = alpha * l_i[half] + sum;
    m_i[half] = m_new;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      o[4 * n + 2 * half] *= alpha;
      o[4 * n + 2 * half + 1] *= alpha;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_fwd_bf16_kernel(const FlashParams p, const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v) {
  using L = Bf16Smem<DP>;
  constexpr int BK = L::kKeys;                   // keys per K/V tile
  constexpr int CB = DP / kBox;                  // 64-wide column blocks per tile
  constexpr int NS = BK / 2;                     // score floats per thread (m64nBK)
  constexpr int NO = DP / 2;                     // output floats per thread (m64nDP)
  constexpr uint32_t TX = L::kKVBytes;           // bytes one K or V tile's TMA boxes deliver
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  auto k_full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto v_full = [&](int st) { return bar_q + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bar_q + 8u * (1 + 2 * kStages + st); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQTile;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);

  // Key tiles that can hold a kept key for some row of this query tile.
  int k_lo = 0, k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, q0 + kQTile);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / BK;
  const int n_tiles = max(0, (k_hi + BK - 1) / BK - t_lo);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to ptxas (as CUTLASS's canonical_warp_group_idx), so the
  // setmaxnreg regions below are too
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWG, 0);
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWG && n_tiles > 0) {
      mbar_arrive_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
        tma_load_4d(sQ + cb * L::kQCol, &tm_q, bar_q, cb * kBox, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int k0 = (t_lo + i) * BK;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);   // the first round passes
        mbar_arrive_expect_tx(k_full(st), TX);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
          tma_load_4d(sK + st * TX + cb * L::kKVCol, &tm_k, k_full(st), cb * kBox, k0, hk, b);
        mbar_arrive_expect_tx(v_full(st), TX);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
          tma_load_4d(sV + st * TX + cb * L::kKVCol, &tm_v, v_full(st), cb * kBox, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64·wg .. + 63 ----
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int qw0 = q0 + 64 * wg;
    const int r_lo = qw0 + 16 * warp + (lane >> 2);   // this thread's rows: r_lo, r_lo + 8
    const float c = p.scale * kLog2e;
    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float s[NS];

    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      const int k0 = (t_lo + i) * BK;

      // S = Q Kᵀ: A = this warpgroup's 64 rows of Q, B = the K tile, both
      // K-major; k-step kk is 32 bytes into column block kk / 4 (Q's column
      // blocks are 128 rows apart, K's BK rows).
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = 0.f;
      mbar_wait(k_full(st), phase);
      fence_acc(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t da = smem_desc(sQ + 64 * wg * kRowBytes + (kk / 4) * L::kQCol + col,
                                      16, 1024);
        const uint64_t db = smem_desc(sK + st * TX + (kk / 4) * L::kKVCol + col, 16, 1024);
        if constexpr (BK == 128)
          wgmma_ss_n128(s, da, db, kk > 0);
        else
          wgmma_ss_n64<0, 0>(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(s);

      // Every key of this tile is kept for every row of this warpgroup?
      const bool interior = k0 + BK <= p.kv_len &&
                            (!p.causal || k0 + BK - 1 <= qw0) &&
                            (p.window <= 0 || k0 > qw0 + 63 - p.window);
      if (interior)
        softmax_tile<false, NS>(s, m_i, l_i, o, p, c, r_lo, k0, lane);
      else
        softmax_tile<true, NS>(s, m_i, l_i, o, p, c, r_lo, k0, lane);

      // O += P V: the score n-tiles 2kk, 2kk + 1, rounded to bf16, are the
      // A fragment of k-step kk (keys 16kk .. 16kk + 15); V is MN-major,
      // k-step kk 16 rows (2,048 bytes) down, column blocks BK rows apart
      // (the descriptor's leading offset: 128 rows at BK 64 would read the
      // wrong keys without any error).
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      mbar_wait(v_full(st), phase);
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = smem_desc(sV + st * TX + kk * 16 * kRowBytes, L::kKVCol, 1024);
        if constexpr (DP == 64)
          wgmma_rs_n64(o, pa[kk], dv);
        else if constexpr (DP == 128)
          wgmma_rs_n128(o, pa[kk], dv);
        else
          wgmma_rs_n256(o, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(o);
      if (threadIdx.x % kWG == 0) mbar_arrive(empty(st));   // K and V of this stage are free
    }

    // O / l, rounded to bf16, into the strided output (the wrapper does not
    // require its rows aligned, so element stores); rows >= Sq and columns
    // >= D are not stored.
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_stride[0] + h * p.o_stride[1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = r_lo + 8 * half;
      if (qi >= p.sq) continue;
      const float denom = fmaxf(l_i[half], 1e-30f);
      __nv_bfloat16* row = out + qi * p.o_stride[2];
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        const int d = 8 * n + 2 * (lane & 3);
        if (d >= p.head_dim) continue;   // D % 8 == 0: d + 1 < D too
        row[d] = __float2bfloat16_rn(o[4 * n + 2 * half] / denom);
        row[d + 1] = __float2bfloat16_rn(o[4 * n + 2 * half + 1] / denom);
      }
    }
  }
}

// ---- host side ----

constexpr int kBadParams = -1;
template <typename Kernel>
int opt_in_smem(Kernel kernel, int bytes) {
  // Above 48 KB a kernel must opt in to dynamic shared memory (per device;
  // cheap to repeat, so no cached flag to go stale across devices).
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int DP>
int launch_f32(const FlashParams& p, cudaStream_t stream) {
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.heads, p.batch);
  constexpr int bytes = f32_smem_bytes<DP>();
  if (int err = opt_in_smem(flash_fwd_f32_kernel<DP>, bytes)) return err;
  flash_fwd_f32_kernel<DP><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const FlashParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (int err = encode_bf16(&tq, p.q, p.q_stride, p.batch, p.heads, p.sq, p.head_dim)) return err;
  constexpr int keys = Bf16Smem<DP>::kKeys;   // K and V boxes: 64 columns x keys rows
  if (int err = encode_bf16(&tk, p.k, p.k_stride, p.batch, p.kv_heads, p.skv, p.head_dim, keys))
    return err;
  if (int err = encode_bf16(&tv, p.v, p.v_stride, p.batch, p.kv_heads, p.skv, p.head_dim, keys))
    return err;
  constexpr int bytes = Bf16Smem<DP>::kBytes;
  if (int err = opt_in_smem(flash_fwd_bf16_kernel<DP>, bytes)) return err;
  const dim3 grid((p.sq + kQTile - 1) / kQTile, p.heads, p.batch);
  flash_fwd_bf16_kernel<DP><<<grid, kBf16Threads, bytes, stream>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const FlashParams& p, cudaStream_t stream) {
  if (p.dtype == 1) {
    if (p.head_dim <= 64) return launch_bf16<64>(p, stream);
    if (p.head_dim <= 128) return launch_bf16<128>(p, stream);
    return launch_bf16<256>(p, stream);
  }
  if (p.head_dim <= 32) return launch_f32<32>(p, stream);
  if (p.head_dim <= 64) return launch_f32<64>(p, stream);
  if (p.head_dim <= 96) return launch_f32<96>(p, stream);
  if (p.head_dim <= 128) return launch_f32<128>(p, stream);
  return launch_f32<256>(p, stream);
}

}  // namespace

// Launches on `stream`; returns 0, a cudaError_t, -1 for parameters the
// kernel does not take, -2 if libcuda has no tensor-map encoder, or
// -1000 - r when encoding a tensor map failed with CUresult r.  The Python
// wrapper has checked devices, dtypes, shapes and strides already.
extern "C" int flash_attention_launch(const FlashParams* params, cudaStream_t stream) {
  const FlashParams& p = *params;
  if (p.head_dim < 8 || p.head_dim > 256 || p.head_dim % 8 != 0 || p.kv_heads < 1 ||
      p.heads % p.kv_heads != 0 || p.sq < 1 || p.skv < 1 || p.kv_len > p.skv ||
      p.heads > 65535 || p.batch > 65535)
    return kBadParams;
  if (p.dtype != 0 && p.dtype != 1) return kBadParams;
  return dispatch(p, stream);
}
