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
// Design: one CTA of 128 threads (4 warps) per (query tile of 64 rows,
// head, batch).  The CTA walks its key tiles of 64 in order (the TPU grid's
// sequential kv axis becomes this loop), stages K and V in shared memory,
// rescales its running max / denominator / accumulator and adds P·V.  The
// input dtype picks one of two bodies:
// - bfloat16 (the serving path): tensor cores through `mma.sync`
//   m16n8k16, f32 accumulators.  Each warp owns 16 query rows; its Q
//   fragments stay in registers, K and V fragments come from shared memory
//   through `ldmatrix` (`.trans` for V).  The score fragments are the P
//   fragments of the P·V product, rounded to bf16 (FlashAttention-2's
//   layout trick); softmax and the denominator stay f32.  Tiles move as
//   16-byte `cp.async` copies into a two-stage ring: the next K/V tile is
//   in flight while the tensor cores work on this one.
// - float32: f32 FMAs on the CUDA cores, as the reference's f32 math does
//   it (tensor cores would round to TF32).  Thread (rg, cg) = (tid / 8,
//   tid % 8) owns score rows rg + 16i (i < 4) and columns cg + 8j (j < 8);
//   rows in shared memory are padded by 4 floats so the float4 reads of the
//   8 column groups fall in distinct banks.
// Both:
// - GQA: the kv head is read in place (no repeated K/V in memory).
// - Tiles wholly above the diagonal (causal) or below the window are never
//   loaded: the loop starts and ends at the first and last tile that can
//   hold a kept key.  Query tiles run heaviest first (the last tile of a
//   causal sequence does the most work).
// - Ragged edges: rows >= Sq and keys >= kv_len are zero-filled and
//   masked.  D is a multiple of 8 up to 128 and every row starts on a
//   16-byte boundary (the wrapper checks both); D is padded to DP in
//   {32, 64, 96, 128} with zeros (a zero lane adds nothing to q.k or to the
//   output it is not stored to); the scale uses the true D.
// - A masked score gets probability exactly 0 (the reference's -1e30
//   sentinel gives the same 0 once a row has a kept key).  A row with no
//   kept key at all ends with l = 0 and is stored as 0, never NaN or inf.
// - No fast-math: IEEE expf and division.
//
// Bound: operations.  Per kept (query, key) pair and head, 2·D FLOPs for
// q.k and 2·D for p·v; TinyLlama's prefill layer (B 4, H 32, Hkv 4,
// S 4,096, D 64, causal) is 2.75e11 FLOPs against 151 MB of q, k, v and o
// (67 MB each for q and o, 8.4 MB each for k and v): 0.28 ms at the card's
// 989 TFLOP/s bf16 tensor-core peak, 0.045 ms of bytes at 3.35 TB/s.  This
// version uses `mma.sync`, not Hopper's `wgmma` / TMA; those are the next
// steps toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ---- bfloat16: tensor-core version (mma.sync m16n8k16, f32 accumulators) ----

template <int DP>
constexpr int bf16_smem_bytes() {   // Q, and two stages of K and V
  return 5 * kBQ * (DP + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes global -> shared without passing through registers; src_bytes 0
// fills the 16 bytes with zeros (and reads nothing).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool in) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(gmem), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows [row0, row0 + 64) of a (rows, D) bf16 matrix with row stride `ld`
// into shared [64][DP + 8], zero beyond `nrows` and D, as 16-byte cp.async
// copies (D % 8 == 0, rows 16-byte aligned), in flight until the caller
// waits.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long ld, int row0, int nrows, int D) {
  constexpr int LDS = DP + 8;
  constexpr int CH = DP / 8;
  for (int idx = threadIdx.x; idx < kBK * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool in = row0 + r < nrows && c < D;
    cp_async_16(dst + r * LDS + c, in ? src + (row0 + r) * ld + c : src, in);
  }
}

// Online-softmax update of one warp's 16 x 64 score tile, in place: scores
// become probabilities, the running max / denominator move, and the output
// accumulator is rescaled.  kMasked: apply the kv_len / causal / window
// masks (edge tiles only; an interior tile keeps every key).
template <bool kMasked, int NT_O>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 8][4], float (&m_i)[2],
                                             float (&l_i)[2], float (&acc)[NT_O][4],
                                             const FlashParams& p, int r_lo, int k0,
                                             int lane) {
  constexpr int NT_S = kBK / 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = r_lo + 8 * half;
    unsigned kept = 0xffffffffu;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * half + e];
        if (kMasked) {
          const int kj = k0 + j * 8 + 2 * (lane & 3) + e;
          const bool ok = kj < p.kv_len && (!p.causal || kj <= qi) &&
                          (p.window <= 0 || kj > qi - p.window);
          x = ok ? x * p.scale : kNegInf;
          if (!ok) kept &= ~(1u << (2 * j + e));
        } else {
          x *= p.scale;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i[half], mx);
    const float alpha = expf(m_i[half] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * half + e];
        x = (!kMasked || ((kept >> (2 * j + e)) & 1u)) ? expf(x - m_new) : 0.f;
        sum += x;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_i[half] = alpha * l_i[half] + sum;
    m_i[half] = m_new;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][2 * half] *= alpha;
      acc[n][2 * half + 1] *= alpha;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const FlashParams p) {
  constexpr int LDS = DP + 8;      // padded row of the tiles, in bf16
  constexpr int KSTEPS = DP / 16;  // k-steps of q.k
  constexpr int NT_S = kBK / 8;    // score n-tiles (8 keys each) per warp
  constexpr int NT_O = DP / 8;     // output n-tiles (8 dims each) per warp
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);   // [kBQ][LDS]
  bf16* Ks = Qs + kBQ * LDS;                   // [2][kBK][LDS], two stages
  bf16* Vs = Ks + 2 * kBK * LDS;               // [2][kBK][LDS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int D = p.head_dim;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_stride[0] + h * p.q_stride[1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_stride[0] + hk * p.k_stride[1];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_stride[0] + hk * p.v_stride[1];
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_stride[0] + h * p.o_stride[1];

  int k_lo = 0, k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, q0 + kBQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

  // Stage 0 gets Q and the first K/V tile in one group of copies.
  load_tile_bf16<DP>(Qs, q, p.q_stride[2], q0, p.sq, D);
  if (t_lo < t_hi) {
    load_tile_bf16<DP>(Ks, k, p.k_stride[2], t_lo * kBK, p.kv_len, D);
    load_tile_bf16<DP>(Vs, v, p.v_stride[2], t_lo * kBK, p.kv_len, D);
  }
  cp_async_commit();

  // A thread holds rows r_lo (half 0) and r_lo + 8 (half 1) of the warp's
  // 16, at columns 2 (lane % 4) + {0, 1} of each 8-wide n-tile.
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KSTEPS][4];   // this warp's 16 query rows as A fragments

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    const int stage = (t - t_lo) & 1;
    // Prefetch the next tile into the other stage (free: the previous
    // iteration ended with a barrier), then wait for this one.
    if (t + 1 < t_hi) {
      load_tile_bf16<DP>(Ks + (stage ^ 1) * kBK * LDS, k, p.k_stride[2], k0 + kBK,
                         p.kv_len, D);
      load_tile_bf16<DP>(Vs + (stage ^ 1) * kBK * LDS, v, p.v_stride[2], k0 + kBK,
                         p.kv_len, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == t_lo) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], &Qs[(warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS +
                                kk * 16 + (lane >> 4) * 8]);
    }
    const bf16* Kt = Ks + stage * kBK * LDS;
    const bf16* Vt = Vs + stage * kBK * LDS;

    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT_S; j += 2) {
        uint32_t kb[4];   // B fragments (k 0-7, k 8-15) of n-tiles j and j + 1
        ldmatrix_x4(kb, &Kt[((j + (lane >> 4)) * 8 + (lane & 7)) * LDS + kk * 16 +
                            ((lane >> 3) & 1) * 8]);
        mma_bf16(s[j], qf[kk], kb[0], kb[1]);
        mma_bf16(s[j + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // Every key of this tile is kept for every row of the query tile?
    const bool interior = k0 + kBK <= p.kv_len && (!p.causal || k0 + kBK - 1 <= q0) &&
                          (p.window <= 0 || k0 > q0 + kBQ - 1 - p.window);
    if (interior)
      softmax_tile<false>(s, m_i, l_i, acc, p, r_lo, k0, lane);
    else
      softmax_tile<true>(s, m_i, l_i, acc, p, r_lo, k0, lane);

    // O += P V: the score fragments of n-tiles 2kk, 2kk + 1 are the A
    // fragment of k-step kk (keys 16kk..16kk+15), rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t vb[4];   // B fragments of dim n-tiles n and n + 1 (V^T via .trans)
        ldmatrix_x4_trans(vb, &Vt[(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS +
                                  (n + (lane >> 4)) * 8]);
        mma_bf16(acc[n], pa, vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();   // no copy outlives the CTA (a query tile with no key tile)

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = r_lo + 8 * half;
    if (qi >= p.sq) continue;
    const float denom = fmaxf(l_i[half], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * (lane & 3) + e;
        if (d < D) o[qi * p.o_stride[2] + d] = __float2bfloat16_rn(acc[n][2 * half + e] / denom);
      }
  }
}

template <typename Kernel>
int opt_in_smem(Kernel kernel, int bytes) {
  // Above 48 KB a kernel must opt in to dynamic shared memory (per device;
  // cheap to repeat, so no cached flag to go stale across devices).
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int DP>
int launch(const FlashParams& p, cudaStream_t stream) {
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.heads, p.batch);
  if (p.dtype == 0) {
    constexpr int bytes = f32_smem_bytes<DP>();
    if (int err = opt_in_smem(flash_fwd_f32_kernel<DP>, bytes)) return err;
    flash_fwd_f32_kernel<DP><<<grid, kThreads, bytes, stream>>>(p);
  } else {
    constexpr int bytes = bf16_smem_bytes<DP>();
    if (int err = opt_in_smem(flash_fwd_bf16_kernel<DP>, bytes)) return err;
    flash_fwd_bf16_kernel<DP><<<grid, kThreads, bytes, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dim(const FlashParams& p, cudaStream_t stream) {
  if (p.head_dim <= 32) return launch<32>(p, stream);
  if (p.head_dim <= 64) return launch<64>(p, stream);
  if (p.head_dim <= 96) return launch<96>(p, stream);
  return launch<128>(p, stream);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched), or -1 for
// parameters the kernel does not take.  The Python wrapper has checked
// devices, dtypes, shapes and strides already.
extern "C" int flash_attention_launch(const FlashParams* params, cudaStream_t stream) {
  const FlashParams& p = *params;
  if (p.head_dim < 8 || p.head_dim > 128 || p.head_dim % 8 != 0 || p.kv_heads < 1 ||
      p.heads % p.kv_heads != 0 || p.sq < 1 || p.skv < 1 || p.kv_len > p.skv ||
      p.heads > 65535 || p.batch > 65535)
    return -1;
  if (p.dtype != 0 && p.dtype != 1) return -1;
  return dispatch_dim(p, stream);
}
