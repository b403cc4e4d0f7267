// SSD chunk scan, forward, for Hopper (sm_90a): the chunked decay-weighted
// linear-attention scan at the core of Mamba2.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk/kernel.py,
// `_ssd_kernel` (launched by `ssd_chunk_kernel`, reached through
// `ops.ssd_scan`).  In the port, `models/ssm.py` `mamba2_forward
// (impl="kernel")` sends every Mamba2 prefill scan through it, and
// `mlstm_forward(impl="kernel")` both scans of every mLSTM prefill (xLSTM:
// N = P = 192 for the values, P = 1 for the normaliser).
//
// What it computes, for every batch b and head h, from a zero state, with
// a_t = exp(log_a_t) <= 1:
//   S_t = a_t S_{t-1} + k_t (x) v_t        y_t = q_t . S_t
// chunk by chunk (Q rows each), as the reference does:
//   cum   = inclusive prefix sum of log_a over the chunk; total = cum[Q-1]
//   y     = select(i >= j, (q_i . k_j) exp(cum_i - cum_j), 0) @ v
//         + (q (.) exp(cum)) @ S_prev
//   S     = exp(total) S_prev + (k (.) exp(total - cum))^T @ v
// Sums and the carried state are f32 (the bf16 body's operand rounding is
// set out below); y is stored in v's dtype, the final state in f32.  The
// causal mask is a select, never a multiply:
// above the diagonal exp(cum_i - cum_j) >= 1 can overflow, and inf * 0 is
// NaN.
//
// Bound: bytes.  Per chunk of Zamba2's layer 6.29 M FLOPs (2 Q^2 N + 2 Q^2 P
// + 2 Q N P twice, the full Q x Q products as the TPU kernel does them),
// 9.02e10 in all: 0.091 ms at the card's 989 TFLOP/s bf16 tensor-core peak,
// against 489 MB moved (v and y 235 MB each, q and k 2.1 MB each as
// head-broadcast views, log_a and the state 7.3 MB each): 0.146 ms at
// 3.35 TB/s.  The TPU grid carries the (N, P) state in VMEM across its
// minor chunk axis; on Hopper CTAs run in no order, so one CTA per (b, h)
// walks its chunks in order and carries the state itself.  Two bodies, and
// the wrapper (kernels/ssd_chunk/kernel.py `body_for`) picks one before the
// launch from the shapes and strides; `wgmma_ok` below is the same test,
// and the launch refuses a body that cannot take the call:
//
// - bf16 on Hopper ("wgmma"; every Mamba2 scan of the Zamba2 path): N, P
//   <= 64, Q <= 128, and q, k, v and y views a tensor map can describe
//   (16-byte-aligned bases, unit-stride features, other strides 16-byte
//   multiples, 0 included: the head-broadcast q and k).  One CTA of three
//   warpgroups (384 threads) per (b, h):
//   * a producer warpgroup: one thread issues TMA loads of each chunk's q,
//     k and v boxes (64 columns x 128 rows, 128-byte swizzle, zeros past
//     the tensor's end) into a two-stage ring, q and k on one "full"
//     mbarrier and v on another, so Q Kᵀ starts before v lands; one warp
//     scans the chunk's log_a into the stage's vectors (cum, the decay
//     factors, exp(cum), k_dec's weights) and arrives on the q / k barrier;
//     two warps then build the stage's k_dec tiles (below) and arrive on a
//     third.  An "empty" barrier per stage takes one arrival from each
//     consumer when it is done with the stage.
//   * two consumer warpgroups; warpgroup W owns the chunk's rows 64W ..
//     64W + 63, which only keys 0 .. 64W + 63 reach: S = Q Kᵀ as `wgmma
//     m64n{64,128}k16` (both operands K-major in shared memory); the decay
//     and the causal select in registers; y = W V as `wgmma m64n64k16` with
//     W from registers, V MN-major; + exp(cum) ⊙ (q S_prev) with S_prev
//     from shared memory; y stored as bf16 pairs from registers.
//   * warpgroup 0 carries the (N, P) state in f32 accumulator registers (32
//     a thread): S = exp(total) S + k_decᵀ V as `wgmma` with the stage's
//     k_dec tiles (MN-major) and V, then writes S as bf16 hi + lo into one
//     of two S_prev buffers, which a named barrier hands to both consumers
//     for the next chunk's q S_prev.
//   * Rounding (kernels/ssd_chunk/ref.py `ssd_rounded` emulates it, and the
//     CPU tests hold that against the reference): q, k and v are bf16 and
//     enter as they are; W, k_dec = k ⊙ exp(total - cum) and S_prev enter as
//     two bf16 terms each, hi + (x - hi): one bf16 W reaches 0.018 of the
//     0.02 element limit, one bf16 k_dec puts the f32 state 17-23x past its
//     limit, and one bf16 S_prev puts y at 2x its limit where slow decays
//     let the state grow; every product accumulates in f32.  That is 8.9 M
//     tensor FLOPs per chunk and head at Zamba2's widths (the 64 x 64 score
//     block above warpgroup 0's rows is skipped).
//   * The decay: exp(cum_i - cum_j) = exp(cum_i - c)·exp(c - cum_j), c =
//     total/2, where the chunk's total log-decay is at least -2·kFactorSpan
//     (2·Q exps a chunk, not Q²); else per element with expf.
//   * Ragged chunks: a box always reads 128 rows, so past a chunk shorter
//     than 128 it holds the next chunk's rows (or zeros past S): the select
//     keeps them out of every stored row, k_dec's weight 0 out of the state,
//     and their y rows are not stored.  N, P < 64 arrive zero-padded.
//   * Shared memory 198 KB (q, k, v 96 KB and k_dec hi / lo 64 KB over the
//     two stages, S_prev hi / lo 32 KB, vectors 5 KB): one CTA per SM, so
//     448 CTAs at Zamba2's layer run in 4 waves over 132 SMs, the last 39%
//     full.  Every warpgroup fits in the 168 registers a thread has at 384
//     threads, so there is no `setmaxnreg` (its increase draws only on what
//     the CTA's other warps release).
// - CUDA cores ("cuda_core"; f32, and bf16 views a tensor map cannot take,
//   N or P above 64, Q above 128): one CTA of 256 threads per (b, h, P
//   tile) keeps its P tile of the state in shared memory.  P is split into
//   tiles of kPTile columns over the grid's y axis (one launch still): the
//   state's and y's P columns evolve independently, so the split is exact;
//   each CTA holds all of N and recomputes the chunk's q.k^T scores.  Per
//   chunk it stages K (transposed, N x Q) and its V tile (Q x PT) in shared
//   memory as f32, then walks the chunk's query rows in tiles of TQ: Q^T
//   tile (N x TQ), the decayed score tile W^T (Q x TQ, only the keys that
//   reach the tile's rows), then y for the tile (the intra-chunk product
//   stops at each row's diagonal).  Last the state update.  Every product
//   is a 4 x 4 register tile per thread fed by float4 reads from shared
//   memory, f32 FMAs on the CUDA cores; at Zamba2's layer 112 KB of shared
//   memory at TQ 32, so two CTAs share an SM; at xLSTM's N 192 and a P tile
//   of 64, 230,912 of the 232,448 bytes a block may use at TQ 32 (one CTA
//   per SM; 96 CTAs for B 4 x H 8 x 3 P tiles).
//   * Strided inputs: every tensor comes with its element strides (stride-0
//     heads included).  Rows with unit-stride, 16-byte-aligned columns are
//     staged as 16-byte loads; other layouts element by element.
//   * Ragged sizes: N, the P tile and Q are padded to multiples of 4 in
//     shared memory with zeros (q = k = v = 0, log_a = 0); the last P tile
//     may be narrower than kPTile (P 130: 64, 64, 2).
//   * Limits (the wrapper checks them on either device, this file again):
//     N <= 192, any P (at most 65,535 tiles), Q <= 256, S a multiple of Q,
//     shared memory <= 227 KB; the wrapper picks TQ (32, or less where the
//     chunk would not fit; N 192 at chunk 256 fits at none).
// No fast-math in either: IEEE expf.

#include "hopper.cuh"

// Mirrored by ctypes.Structure `_Params` in kernels/ssd_chunk/kernel.py;
// keep the field order and types in step.
struct SsdParams {
  const void* q;            // (B, H, S, N) by the strides below
  const void* k;            // (B, H, S, N)
  const void* v;            // (B, H, S, P)
  const float* log_a;       // (B, H, S), float32
  void* y;                  // (B, H, S, P), v's dtype
  float* state;             // (B, H, N, P), float32, contiguous
  long long q_stride[4];    // batch, head, row, feature strides in elements
  long long k_stride[4];
  long long v_stride[4];
  long long y_stride[4];
  long long la_stride[3];   // batch, head, row
  int batch, heads, seq, n, p, chunk;
  int tile_q;               // query rows per tile, a multiple of 4 (CUDA-core body)
  int dtype;                // 0 = float32, 1 = bfloat16 (q, k, v and y)
  int body;                 // 0 = CUDA cores, 1 = bf16 wgmma (wgmma_ok must hold)
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 192;            // N: all of it sits in each CTA
constexpr int kPTile = 64;            // P columns per CTA (the grid's y axis)
constexpr int kMaxPTiles = 65535;     // gridDim.y's limit
constexpr int kMaxChunk = 256;
constexpr int kPerLane = kMaxChunk / 32;   // log_a rows per lane of warp 0
constexpr int kBatch = 8;             // global loads in flight per thread (per stage)
constexpr int kMaxSmem = 232448;      // 227 KB, Hopper's per-block limit

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Shared-memory floats for one CTA of `pt` P columns (its P tile);
// kernels/ssd_chunk/kernel.py `_smem_bytes` computes the same.
__host__ __device__ inline long long smem_floats(int n, int pt, int chunk, int tq) {
  const long long np = round4(n), pp = round4(pt), qp = round4(chunk);
  return np * (qp + 4) + qp * pp + np * pp + np * (tq + 4) + qp * (tq + 4) + 3 * qp;
}

template <typename T> __device__ inline float load(const T* ptr);
template <> __device__ inline float load<float>(const float* ptr) { return *ptr; }
template <> __device__ inline float load<__nv_bfloat16>(const __nv_bfloat16* ptr) {
  return __bfloat162float(*ptr);
}
template <typename T> __device__ inline void store(T* ptr, float x);
template <> __device__ inline void store<float>(float* ptr, float x) { *ptr = x; }
template <> __device__ inline void store<__nv_bfloat16>(__nv_bfloat16* ptr, float x) {
  *ptr = __float2bfloat16_rn(x);
}

// 16 bytes of T (kVec<T> values) to f32; bf16 -> f32 is exact (a shift).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4 r, float (&out)[4]) {
    out[0] = __uint_as_float(r.x); out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z); out[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4 r, float (&out)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// dst[row * dst_stride + col] (or [col * dst_stride + row] if `kTranspose`)
// = src[row * rs + col * cs] for row < rows_valid, col < cols_valid, else 0,
// over rows x cols.  Rows of unit-stride, 16-byte-aligned, unpadded columns
// (every tensor of the Zamba2 path) move as 16-byte loads, up to kBatch in
// flight per thread before the stores; anything else element by element.
template <typename T, bool kTranspose>
__device__ inline void stage(float* dst, int dst_stride, const T* src, long long rs,
                             long long cs, int rows, int cols, int rows_valid,
                             int cols_valid) {
  constexpr int kV = Vec<T>::kN;
  const bool vec = cs == 1 && cols_valid == cols && cols % kV == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   (rs * static_cast<long long>(sizeof(T))) % 16 == 0;
  if (vec) {
    const int per_row = cols / kV, total = rows * per_row;
    for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
      uint4 raw[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int e = base + r * kThreads;
        const int row = e / per_row, c0 = (e % per_row) * kV;
        raw[r] = (e < total && row < rows_valid)
                     ? *reinterpret_cast<const uint4*>(src + row * rs + c0)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int e = base + r * kThreads;
        if (e < total) {
          const int row = e / per_row, c0 = (e % per_row) * kV;
          float vals[kV];
          Vec<T>::unpack(raw[r], vals);
#pragma unroll
          for (int u = 0; u < kV; ++u) {
            if (kTranspose) dst[(c0 + u) * dst_stride + row] = vals[u];
            else dst[row * dst_stride + c0 + u] = vals[u];
          }
        }
      }
    }
    return;
  }
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float vals[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int e = base + r * kThreads;
      const int row = e / cols, col = e % cols;
      vals[r] = (e < total && row < rows_valid && col < cols_valid)
                    ? load(src + row * rs + col * cs) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int e = base + r * kThreads;
      if (e < total) {
        const int row = e / cols, col = e % cols;
        if (kTranspose) dst[col * dst_stride + row] = vals[r];
        else dst[row * dst_stride + col] = vals[r];
      }
    }
  }
}

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ inline void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

// acc[r][c] += sum_{t < len} A[t * as + r] * B[t * bs + c], four rows t at a
// time (len is a multiple of 4): the eight float4 reads of a step are all in
// flight before its 64 FMAs.
__device__ inline void outer_sum(float (&acc)[4][4], const float* A, int as, const float* B,
                                 int bs, int len) {
  for (int t = 0; t < len; t += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = ld4(A + (t + u) * as);
      b[u] = ld4(B + (t + u) * bs);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) fma4x4(acc, a[u], b[u]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const SsdParams prm) {
  extern __shared__ float4 smem_f4[];
  // this CTA's P tile: columns p_lo .. p_lo + p - 1 of the (b, h) scan
  const int p_lo = blockIdx.y * kPTile;
  const int n = prm.n, p = min(kPTile, prm.p - p_lo), Q = prm.chunk, TQ = prm.tile_q;
  const int NP = round4(n), PP = round4(p), QP = round4(Q);
  const int kts = QP + 4, qts = TQ + 4;       // row strides of kT and qT / WT
  float* kT = reinterpret_cast<float*>(smem_f4);   // (NP, kts): k transposed
  float* vs = kT + NP * kts;                  // (QP, PP)
  float* S = vs + QP * PP;                    // (NP, PP): the carried state
  float* qT = S + NP * PP;                    // (NP, qts): the tile's q transposed
  float* WT = qT + NP * qts;                  // (QP, qts): W transposed, [key][row]
  float* cum = WT + QP * qts;                 // (QP)
  float* ecum = cum + QP;                     // exp(cum)
  float* dec = ecum + QP;                     // exp(total - cum)

  const int b = blockIdx.x / prm.heads, h = blockIdx.x % prm.heads;
  const T* q = static_cast<const T*>(prm.q) + b * prm.q_stride[0] + h * prm.q_stride[1];
  const T* k = static_cast<const T*>(prm.k) + b * prm.k_stride[0] + h * prm.k_stride[1];
  const T* v = static_cast<const T*>(prm.v) + b * prm.v_stride[0] + h * prm.v_stride[1] +
               p_lo * prm.v_stride[3];
  const float* la = prm.log_a + b * prm.la_stride[0] + h * prm.la_stride[1];
  T* y = static_cast<T*>(prm.y) + b * prm.y_stride[0] + h * prm.y_stride[1] +
         p_lo * prm.y_stride[3];
  const int tid = threadIdx.x;
  const int npb = PP / 4;

  for (int e = tid; e < NP * PP; e += kThreads) S[e] = 0.f;

  for (int s0 = 0; s0 < prm.seq; s0 += Q) {
    __syncthreads();   // the previous chunk is done with kT, vs, S
    stage<T, true>(kT, kts, k + s0 * prm.k_stride[2], prm.k_stride[2], prm.k_stride[3],
                   QP, NP, Q, n);
    stage<T, false>(vs, PP, v + s0 * prm.v_stride[2], prm.v_stride[2], prm.v_stride[3],
                    QP, PP, Q, p);
    if (tid < 32) {
      // warp 0: each lane sums kPerLane consecutive log_a, then a shuffle
      // scan over the lanes' sums; padded rows hold 0
      float run = 0.f, part[kPerLane];
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const int j = tid * kPerLane + r;
        run += (j < Q) ? la[(s0 + j) * prm.la_stride[2]] : 0.f;
        part[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const int j = tid * kPerLane + r;
        if (j < QP) cum[j] = excl + part[r];
      }
      __syncwarp();
      const float total = cum[Q - 1];
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const int j = tid * kPerLane + r;
        if (j < QP) {
          ecum[j] = expf(cum[j]);
          dec[j] = expf(total - cum[j]);
        }
      }
    }

    for (int i0 = 0; i0 < QP; i0 += TQ) {
      const int tq = min(TQ, QP - i0);        // rows of this tile, a multiple of 4
      const int nib = tq / 4;
      __syncthreads();   // kT / vs / cum staged; the previous tile is done with qT, WT
      stage<T, true>(qT, qts, q + (s0 + i0) * prm.q_stride[2], prm.q_stride[2],
                     prm.q_stride[3], tq, NP, Q - i0, n);
      __syncthreads();

      // W^T[j][i] = (q_i . k_j) exp(cum_i - cum_j) for j <= i, else 0, over
      // the (key block, row block) pairs that hold a j <= i: every key block
      // before the tile, then the tile's lower triangle of 4 x 4 blocks
      const int rect = nib * (i0 / 4);
      const int pairs = rect + nib * (nib + 1) / 2;
      for (int m = tid; m < pairs; m += kThreads) {
        int ib, jb;
        if (m < rect) {
          ib = m % nib;
          jb = m / nib;
        } else {
          const int t = m - rect;
          ib = 0;
          while ((ib + 1) * (ib + 2) / 2 <= t) ++ib;
          jb = i0 / 4 + (t - ib * (ib + 1) / 2);
        }
        const int il0 = 4 * ib, j0 = 4 * jb;
        float acc[4][4] = {};                 // [key][row]
        outer_sum(acc, kT + j0, kts, qT + il0, qts, NP);
#pragma unroll
        for (int jr = 0; jr < 4; ++jr) {
          const int j = j0 + jr;
          float out[4];
#pragma unroll
          for (int ir = 0; ir < 4; ++ir) {
            const int i = i0 + il0 + ir;
            out[ir] = (j <= i) ? acc[jr][ir] * expf(cum[i] - cum[j]) : 0.f;
          }
          *reinterpret_cast<float4*>(WT + j * qts + il0) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      }
      __syncthreads();

      // y = W @ v (keys up to each row block's diagonal) + exp(cum) (q @ S)
      for (int m = tid; m < nib * npb; m += kThreads) {
        const int ib = m / npb, pb = m % npb;
        const int il0 = 4 * ib, p0 = 4 * pb;
        const int jend = i0 + il0 + 4;
        float intra[4][4] = {}, inter[4][4] = {};   // [row][col]
        outer_sum(intra, WT + il0, qts, vs + p0, PP, jend);
        outer_sum(inter, qT + il0, qts, S + p0, PP, NP);
#pragma unroll
        for (int ir = 0; ir < 4; ++ir) {
          const int i = i0 + il0 + ir;
          if (i >= Q) continue;
          T* row = y + (s0 + i) * prm.y_stride[2];
#pragma unroll
          for (int pc = 0; pc < 4; ++pc)
            if (p0 + pc < p)
              store(row + (p0 + pc) * prm.y_stride[3],
                    intra[ir][pc] + ecum[i] * inter[ir][pc]);
        }
      }
    }
    __syncthreads();   // every tile has read S

    // S = exp(total) S + sum_j (k_j exp(total - cum_j)) (x) v_j; each thread
    // reads and writes only its own 4 x 4 block of S
    const float etot = expf(cum[Q - 1]);
    for (int m = tid; m < (NP / 4) * npb; m += kThreads) {
      const int d0 = 4 * (m / npb), p0 = 4 * (m % npb);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = etot * S[(d0 + r) * PP + p0 + c];
      // padded rows j >= Q hold k = v = 0 and add nothing
      for (int j = 0; j < QP; j += 4) {
        const float4 w4 = ld4(dec + j);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
        float kr[4][4], vr[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 k4 = ld4(kT + (d0 + r) * kts + j);
          kr[r][0] = k4.x; kr[r][1] = k4.y; kr[r][2] = k4.z; kr[r][3] = k4.w;
          const float4 v4 = ld4(vs + (j + r) * PP + p0);
          vr[r][0] = v4.x; vr[r][1] = v4.y; vr[r][2] = v4.z; vr[r][3] = v4.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(kr[r][u] * w[u], vr[u][c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) S[(d0 + r) * PP + p0 + c] = acc[r][c];
    }
  }
  __syncthreads();

  float* out = prm.state + (static_cast<long long>(b) * prm.heads + h) * n * prm.p + p_lo;
  for (int e = tid; e < n * p; e += kThreads)
    out[(e / p) * static_cast<long long>(prm.p) + e % p] = S[(e / p) * PP + e % p];
}

// ---- bfloat16 on Hopper: TMA-fed chunks, wgmma products, the state in registers ----

constexpr int kWG = 128;                       // threads per warpgroup
constexpr int kWgThreads = 3 * kWG;            // consumers 0 and 1, producer 2
constexpr int kWgmmaDim = 64;                  // N, P <= one 64-column (128-byte) block
constexpr int kWgmmaChunk = 128;               // chunk rows <= one 128-row box
constexpr int kStages = 2;                     // depth of the q / k / v / k_dec ring
constexpr int kRowBytes = 128;                 // a swizzled row: 64 bf16
constexpr int kTileBytes = kWgmmaChunk * kRowBytes;   // 128 rows of 64 bf16: 16 KB
constexpr int kStateBytes = kWgmmaDim * kRowBytes;    // 64 rows of 64 bf16: 8 KB
constexpr int kDecThreads = 64;                // producer warps 2 and 3 build k_dec
constexpr int kFactorSpan = 80;                // kernels/ssd_chunk/ref.py FACTOR_SPAN
constexpr int kStateBar = 1;                   // named barrier (0 is __syncthreads)

// Per-stage f32 vectors over the box's 128 rows, written by the producer's
// scan warp: cum; exp(cum - total/2) and exp(total/2 - cum) (the factorised
// decay); exp(cum) (the inter-chunk row scale); exp(total - cum), 0 past the
// chunk (k_dec's weights).
enum { kCum, kRowF, kKeyF, kEcum, kDec, kVecs };

// Shared memory of the wgmma body, in bytes from a 1024-aligned base (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes; the TMA and wgmma
// descriptors assume tiles start on that boundary).
struct WgSmem {
  static constexpr int kQ = 0;                                    // [kStages] q tiles
  static constexpr int kK = kQ + kStages * kTileBytes;            // [kStages] k tiles
  static constexpr int kV = kK + kStages * kTileBytes;            // [kStages] v tiles
  static constexpr int kKdec = kV + kStages * kTileBytes;         // [kStages] k_dec hi, lo
  static constexpr int kS = kKdec + 2 * kStages * kTileBytes;     // [2] S_prev hi, lo
  static constexpr int kVec = kS + 4 * kStateBytes;               // [kStages][kVecs][128] f32
  static constexpr int kScal = kVec + kStages * kVecs * kWgmmaChunk * 4;   // [kStages] {exp(total), factorised}
  static constexpr int kBar = kScal + kStages * 8;                // qk_full[], v_full[], kdec_full[], empty[]
  static constexpr int kBytes = kBar + 8 * 4 * kStages + 1024;    // + alignment slack
};

// A tensor map can describe the (B, H, rows, cols) bf16 view: 16-byte-aligned
// base, unit-stride columns, the other strides 16-byte multiples (0 allowed)
// below 2^40 bytes.
inline bool tma_view(const void* ptr, const long long (&stride)[4]) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || stride[3] != 1) return false;
  for (int d = 0; d < 3; ++d)
    if (stride[d] < 0 || (stride[d] * 2) % 16 != 0 || stride[d] * 2 >= (1LL << 40)) return false;
  return true;
}

// The wgmma body takes the call; kernels/ssd_chunk/kernel.py `body_for`
// decides the same before the launch.
inline bool wgmma_ok(const SsdParams& P) {
  return P.dtype == 1 && P.n <= kWgmmaDim && P.p <= kWgmmaDim && P.chunk <= kWgmmaChunk &&
         tma_view(P.q, P.q_stride) && tma_view(P.k, P.k_stride) && tma_view(P.v, P.v_stride) &&
         tma_view(P.y, P.y_stride);
}

struct WgBars {
  uint32_t base;
  __device__ uint32_t qk_full(int st) const { return base + 8u * st; }
  __device__ uint32_t v_full(int st) const { return base + 8u * (kStages + st); }
  __device__ uint32_t kdec_full(int st) const { return base + 8u * (2 * kStages + st); }
  __device__ uint32_t empty(int st) const { return base + 8u * (3 * kStages + st); }
};

// The byte offset of (row, 16-byte group g) in a 128-byte-swizzled tile.
__device__ __forceinline__ int swizzled(int row, int g) {
  return row * kRowBytes + ((g ^ (row & 7)) << 4);
}

// The decay and the causal select of one thread's scores, in place:
// s[4j + 2·half + e] is row i = row0 + 8·half, key 8j + 2·(lane % 4) + e.
// kFactored: s·(rf[i]·kf[key]), rf / kf the stage's exp(cum - total/2) and
// exp(total/2 - cum); else s·exp(rf[i] - kf[key]), both the stage's cum.  The
// mask is a select: above the diagonal the decay can overflow, and inf·0 is
// NaN.
template <int KEYS, bool kFactored>
__device__ __forceinline__ void decay_select(float (&s)[KEYS / 2], const float* rf,
                                             const float* kf, int row0, int lane) {
  const float r_i[2] = {rf[row0], rf[row0 + 8]};
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    const int key = 8 * j + 2 * (lane & 3);
    const float2 k2 = *reinterpret_cast<const float2*>(kf + key);
    const float k_j[2] = {k2.x, k2.y};
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * half + e];
        const float d = kFactored ? r_i[half] * k_j[e] : expf(r_i[half] - k_j[e]);
        x = key + e <= row0 + 8 * half ? x * d : 0.f;
      }
  }
}

// Consumer warpgroup W: the chunk's query rows 64W .. 64W + 63 (only keys
// 0 .. 64W + 63 reach them), and for W = 0 the carried state.  Per chunk:
// S = Q Kᵀ; W = select(j <= i, S·decay, 0) split into bf16 hi + lo A
// fragments; y = W V (hi and lo) + exp(cum) ⊙ (q S_prev); for W = 0 then
// S = exp(total) S + (k_dec hi)ᵀ V + (k_dec lo)ᵀ V and S_prev for the next
// chunk, as bf16 hi and lo, into shared memory.
template <int W>
__device__ __forceinline__ void ssd_consumer(const SsdParams& prm, uint32_t base, uint8_t* sm,
                                             WgBars bars, int b, int h) {
  constexpr int KEYS = 64 * (W + 1);
  constexpr int NS = KEYS / 2;                 // score floats per thread
  constexpr int KSTEPS = KEYS / 16;            // k-steps of W V
  const int tid = threadIdx.x % kWG, warp = tid / 32, lane = tid % 32;
  const int row0 = 64 * W + 16 * warp + (lane >> 2);   // this thread's rows: row0, row0 + 8
  const int Q = prm.chunk, nch = prm.seq / Q;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(prm.y) + b * prm.y_stride[0] +
                     h * prm.y_stride[1];
  float acc_s[32];                             // W = 0: the state, rows n, columns p
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_s[i] = 0.f;

  for (int c = 0; c < nch; ++c) {
    const int st = c % kStages;
    const uint32_t phase = (c / kStages) & 1;
    const uint32_t sQ = base + WgSmem::kQ + st * kTileBytes;
    const uint32_t sK = base + WgSmem::kK + st * kTileBytes;
    const uint32_t sV = base + WgSmem::kV + st * kTileBytes;
    const float* vec = reinterpret_cast<const float*>(sm + WgSmem::kVec) + st * kVecs * kWgmmaChunk;
    const float* scal = reinterpret_cast<const float*>(sm + WgSmem::kScal) + 2 * st;

    // S = Q Kᵀ: A = this warpgroup's 64 rows of q, B = the first KEYS keys of
    // k, both K-major; k-step kk is 32 bytes into the 128-byte rows.
    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    mbar_wait(bars.qk_full(st), phase);   // wait q/k
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = smem_desc(sQ + 64 * W * kRowBytes + kk * 32, 16, 1024);
      const uint64_t db = smem_desc(sK + kk * 32, 16, 1024);
      if constexpr (W == 0)
        wgmma_ss_n64<0, 0>(s, da, db, kk > 0);
      else
        wgmma_ss_n128(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);   // Q K^T done

    // the decay, factorised where the chunk's span allows it, and the select
    if (scal[1] != 0.f)
      decay_select<KEYS, true>(s, vec + kRowF * kWgmmaChunk, vec + kKeyF * kWgmmaChunk, row0, lane);
    else
      decay_select<KEYS, false>(s, vec + kCum * kWgmmaChunk, vec + kCum * kWgmmaChunk, row0, lane);
    // W as two bf16 A fragments per k-step: hi = bf16(W), lo = bf16(W - hi);
    // score n-tiles 2kk and 2kk + 1 are k-step kk (keys 16kk .. 16kk + 15).
    uint32_t w_hi[KSTEPS][4], w_lo[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        w_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        w_lo[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }   // decay and select done

    // y = W V: V is MN-major, k-step kk 16 rows (2,048 bytes) down.
    float yi[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) yi[i] = 0.f;
    mbar_wait(bars.v_full(st), phase);   // wait v
    fence_acc(yi);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint64_t dv = smem_desc(sV + kk * 16 * kRowBytes, kTileBytes, 1024);
      wgmma_rs_n64(yi, w_hi[kk], dv);
      wgmma_rs_n64(yi, w_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(yi);   // W V done

    // + q S_prev (zero before the first chunk): S_prev is chunk c - 1's state
    // as bf16 hi and lo, MN-major (rows n), written by warpgroup 0 into
    // buffer c % 2.
    float yx[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) yx[i] = 0.f;
    if (c > 0) {
      bar_sync(kStateBar, 2 * kWG);   // wait state
      const uint32_t sS = base + WgSmem::kS + (c & 1) * 2 * kStateBytes;
      fence_acc(yx);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64<0, 1>(yx, smem_desc(sQ + 64 * W * kRowBytes + kk * 32, 16, 1024),
                             smem_desc(sS + part * kStateBytes + kk * 16 * kRowBytes,
                                       kStateBytes, 1024), part + kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(yx);
    }   // q S_prev done

    // y = W V + exp(cum_i) (q S_prev)_i, rounded to bf16 pairs and stored
    // from registers (a TMA store through shared memory, with the barriers
    // it needs, ran 5% slower on the card); rows >= Q and columns >= P are
    // not stored.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = row0 + 8 * half;
      if (i >= Q) continue;
      const float ec = vec[kEcum * kWgmmaChunk + i];
      __nv_bfloat16* row = y + static_cast<long long>(c * Q + i) * prm.y_stride[2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const __nv_bfloat162 pair =
            __floats2bfloat162_rn(fmaf(ec, yx[4 * j + 2 * half], yi[4 * j + 2 * half]),
                                  fmaf(ec, yx[4 * j + 2 * half + 1], yi[4 * j + 2 * half + 1]));
        if (col + 1 < prm.p)
          *reinterpret_cast<__nv_bfloat162*>(row + col) = pair;
        else if (col < prm.p)
          row[col] = __low2bfloat16(pair);
      }
    }   // y stored

    if constexpr (W == 1) {
      if (tid == 0) mbar_arrive(bars.empty(st));   // q, k, v and the vectors of this stage are free
    } else {
      // S = exp(total) S + k_decᵀ V: A = the stage's k_dec hi and lo tiles
      // (built by the producer's k_dec warps; MN-major, rows are keys, the K
      // dimension), B = V (MN-major), both k-steps 16 rows down.
      const float etot = scal[0];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_s[i] *= etot;
      const uint32_t sKd = base + WgSmem::kKdec + st * 2 * kTileBytes;
      mbar_wait(bars.kdec_full(st), phase);
      fence_acc(acc_s);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss_n64<1, 1>(acc_s,
                             smem_desc(sKd + part * kTileBytes + kk * 16 * kRowBytes,
                                       kTileBytes, 1024),
                             smem_desc(sV + kk * 16 * kRowBytes, kTileBytes, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc_s);
      if (tid == 0) mbar_arrive(bars.empty(st));

      // S_prev of chunk c + 1 as bf16 hi and lo into buffer (c + 1) % 2, in
      // the swizzled MN-major layout: row n, 16-byte group p / 8.
      if (c + 1 < nch) {
        uint8_t* sS = sm + WgSmem::kS + ((c + 1) & 1) * 2 * kStateBytes;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = 16 * warp + (lane >> 2) + 8 * half;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float x0 = acc_s[4 * j + 2 * half], x1 = acc_s[4 * j + 2 * half + 1];
            const __nv_bfloat162 xh = __floats2bfloat162_rn(x0, x1);
            const int off = swizzled(n, j) + 4 * (lane & 3);
            *reinterpret_cast<__nv_bfloat162*>(sS + off) = xh;
            *reinterpret_cast<uint32_t*>(sS + kStateBytes + off) =
                pack_bf16(x0 - __low2float(xh), x1 - __high2float(xh));
          }
        }
        fence_proxy_async();   // published by the next chunk's kStateBar
      }
    }   // state update done (warpgroup 0), stage released (1)
  }

  if constexpr (W == 0) {
    float* out = prm.state + (static_cast<long long>(b) * prm.heads + h) * prm.n * prm.p;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 16 * warp + (lane >> 2) + 8 * half;
      if (n >= prm.n) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * (lane & 3) + e;
          if (col < prm.p) out[n * prm.p + col] = acc_s[4 * j + 2 * half + e];
        }
    }
  }
}

// One CTA of three warpgroups per (b, h): a producer (one thread issues the
// TMA loads of each chunk's q, k and v boxes into the ring, one warp scans
// log_a into the stage's vectors, two warps build the stage's k_dec tiles)
// and two consumers (ssd_consumer<0>, <1>).
__global__ void __launch_bounds__(kWgThreads, 1)
ssd_wgmma_kernel(const SsdParams prm, const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const WgBars bars{base + WgSmem::kBar};
  const int b = blockIdx.x / prm.heads, h = blockIdx.x % prm.heads;
  const int Q = prm.chunk, nch = prm.seq / Q;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars.qk_full(st), 1 + 32);   // the TMA thread and the scan warp's lanes
      mbar_init(bars.v_full(st), 1);
      mbar_init(bars.kdec_full(st), kDecThreads);
      mbar_init(bars.empty(st), 2);          // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    const int ptid = threadIdx.x - 2 * kWG;
    if (ptid == 0) {
      for (int c = 0; c < nch; ++c) {
        const int st = c % kStages;
        mbar_wait(bars.empty(st), ((c / kStages) & 1) ^ 1);   // wait free stage; the first round passes
        mbar_arrive_expect_tx(bars.qk_full(st), 2 * kTileBytes);
        tma_load_4d(base + WgSmem::kQ + st * kTileBytes, &tm_q, bars.qk_full(st), 0, c * Q, h, b);
        tma_load_4d(base + WgSmem::kK + st * kTileBytes, &tm_k, bars.qk_full(st), 0, c * Q, h, b);
        mbar_arrive_expect_tx(bars.v_full(st), kTileBytes);
        tma_load_4d(base + WgSmem::kV + st * kTileBytes, &tm_v, bars.v_full(st), 0, c * Q, h, b);
      }
    } else if (ptid >= 32 && ptid < 64) {
      // the scan warp: each lane sums 4 consecutive log_a, then a shuffle
      // scan over the lanes' sums; rows past the chunk hold log_a = 0
      const int lane = ptid - 32;
      const float* la = prm.log_a + b * prm.la_stride[0] + h * prm.la_stride[1];
      for (int c = 0; c < nch; ++c) {
        const int st = c % kStages;
        float part[4], run = 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * lane + r;
          run += j < Q ? la[static_cast<long long>(c * Q + j) * prm.la_stride[2]] : 0.f;
          part[r] = run;
        }
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += up;
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) excl = 0.f;
        const float total = __shfl_sync(0xffffffffu, incl, 31);
        const float mid = 0.5f * total;
        const bool factored = total >= -2.f * kFactorSpan;
        mbar_wait(bars.empty(st), ((c / kStages) & 1) ^ 1);
        float* vec = reinterpret_cast<float*>(sm + WgSmem::kVec) + st * kVecs * kWgmmaChunk;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * lane + r;
          const float cum = excl + part[r];
          vec[kCum * kWgmmaChunk + j] = cum;
          vec[kRowF * kWgmmaChunk + j] = factored ? expf(cum - mid) : 0.f;
          vec[kKeyF * kWgmmaChunk + j] = factored ? expf(mid - cum) : 0.f;
          vec[kEcum * kWgmmaChunk + j] = expf(cum);
          vec[kDec * kWgmmaChunk + j] = j < Q ? expf(total - cum) : 0.f;
        }
        if (lane == 0) {
          float* scal = reinterpret_cast<float*>(sm + WgSmem::kScal) + 2 * st;
          scal[0] = expf(total);
          scal[1] = factored ? 1.f : 0.f;
        }
        mbar_arrive(bars.qk_full(st));
      }
    } else if (ptid >= 64) {
      // the k_dec warps: k_dec = k ⊙ exp(total - cum) as bf16 hi + lo tiles
      // in k's layout (the swizzle permutes 16-byte groups within a row, and
      // the weight depends on the row only); rows past the chunk get weight
      // 0.  The stage's previous k_dec was read by warpgroup 0's state
      // product before it released the stage that this chunk's loads refill.
      const int t = ptid - 64;
      for (int c = 0; c < nch; ++c) {
        const int st = c % kStages;
        mbar_wait(bars.qk_full(st), (c / kStages) & 1);
        const uint8_t* k_tile = sm + WgSmem::kK + st * kTileBytes;
        const float* dec = reinterpret_cast<const float*>(sm + WgSmem::kVec) +
                           (st * kVecs + kDec) * kWgmmaChunk;
        uint8_t* kd = sm + WgSmem::kKdec + st * 2 * kTileBytes;
#pragma unroll 4
        for (int r = 0; r < kTileBytes / 16 / kDecThreads; ++r) {
          const int off = 16 * (t + kDecThreads * r);
          const float w = dec[off / kRowBytes];
          const uint4 raw4 = *reinterpret_cast<const uint4*>(k_tile + off);
          const uint32_t in[4] = {raw4.x, raw4.y, raw4.z, raw4.w};
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float x0 = __uint_as_float(in[u] << 16) * w;
            const float x1 = __uint_as_float(in[u] & 0xffff0000u) * w;
            const __nv_bfloat162 xh = __floats2bfloat162_rn(x0, x1);
            hi[u] = *reinterpret_cast<const uint32_t*>(&xh);
            lo[u] = pack_bf16(x0 - __low2float(xh), x1 - __high2float(xh));
          }
          *reinterpret_cast<uint4*>(kd + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(kd + kTileBytes + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        fence_proxy_async();
        mbar_arrive(bars.kdec_full(st));
      }
    }
  } else if (wg == 0) {
    ssd_consumer<0>(prm, base, sm, bars, b, h);
  } else {
    ssd_consumer<1>(prm, base, sm, bars, b, h);
  }
}

// ---- host side ----

constexpr int kBadParams = -1;

template <typename T>
int launch_cuda_core(const SsdParams& prm, cudaStream_t stream) {
  const int smem =
      static_cast<int>(smem_floats(prm.n, min(prm.p, kPTile), prm.chunk, prm.tile_q) * 4);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(prm.batch * prm.heads, (prm.p + kPTile - 1) / kPTile);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const SsdParams& prm, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (int err = encode_bf16(&tq, prm.q, prm.q_stride, prm.batch, prm.heads, prm.seq, prm.n))
    return err;
  if (int err = encode_bf16(&tk, prm.k, prm.k_stride, prm.batch, prm.heads, prm.seq, prm.n))
    return err;
  if (int err = encode_bf16(&tv, prm.v, prm.v_stride, prm.batch, prm.heads, prm.seq, prm.p))
    return err;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WgSmem::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_wgmma_kernel<<<prm.batch * prm.heads, kWgThreads, WgSmem::kBytes, stream>>>(prm, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns 0, a cudaError_t, -1 for parameters the
// chosen body does not take, -2 if libcuda has no tensor-map encoder, or
// -1000 - r when encoding a tensor map failed with CUresult r.
extern "C" int ssd_chunk_launch(const SsdParams* prm, void* stream) {
  const SsdParams& P = *prm;
  if (P.batch < 1 || P.heads < 1 || P.seq < 1 || P.n < 1 || P.n > kMaxN ||
      P.p < 1 || (P.p - 1) / kPTile >= kMaxPTiles || P.chunk < 1 || P.chunk > kMaxChunk ||
      P.seq % P.chunk != 0 || (P.dtype != 0 && P.dtype != 1) ||
      static_cast<long long>(P.batch) * P.heads > 0x7fffffffLL)
    return kBadParams;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.body == 1) return wgmma_ok(P) ? launch_wgmma(P, s) : kBadParams;
  if (P.body != 0 || P.tile_q < 4 || P.tile_q % 4 != 0 || P.tile_q > round4(P.chunk) ||
      smem_floats(P.n, P.p < kPTile ? P.p : kPTile, P.chunk, P.tile_q) * 4 > kMaxSmem)
    return kBadParams;
  return P.dtype == 1 ? launch_cuda_core<__nv_bfloat16>(P, s) : launch_cuda_core<float>(P, s);
}
