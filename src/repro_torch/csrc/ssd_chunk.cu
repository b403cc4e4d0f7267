// SSD chunk scan, forward, for Hopper (sm_90a): the chunked decay-weighted
// linear-attention scan at the core of Mamba2.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk/kernel.py,
// `_ssd_kernel` (launched by `ssd_chunk_kernel`, reached through
// `ops.ssd_scan`).  In the port, `models/ssm.py` `mamba2_forward
// (impl="kernel")` sends every Mamba2 prefill scan through it.
//
// What it computes, for every batch b and head h, from a zero state, with
// a_t = exp(log_a_t) <= 1:
//   S_t = a_t S_{t-1} + k_t (x) v_t        y_t = q_t . S_t
// chunk by chunk (Q rows each), as the reference does:
//   cum   = inclusive prefix sum of log_a over the chunk; total = cum[Q-1]
//   y     = select(i >= j, (q_i . k_j) exp(cum_i - cum_j), 0) @ v
//         + (q (.) exp(cum)) @ S_prev
//   S     = exp(total) S_prev + (k (.) exp(total - cum))^T @ v
// All arithmetic is f32 for either input dtype; y is stored in v's dtype,
// the final state in f32.  The causal mask is a select, never a multiply:
// above the diagonal exp(cum_i - cum_j) >= 1 can overflow, and inf * 0 is
// NaN.
//
// Design: one CTA of 256 threads per (b, h).  The TPU grid carries the
// (N, P) state in VMEM across its minor chunk axis; on Hopper CTAs run in
// no order, so each CTA loops over its chunks in order and keeps the state
// in shared memory (16 KB at N = P = 64).  Per chunk it stages K
// (transposed, N x Q) and V (Q x P) in shared memory as f32, then walks the
// chunk's query rows in tiles of TQ: Q^T tile (N x TQ), the decayed score
// tile W^T (Q x TQ, only the keys that reach the tile's rows), then y for
// the tile (the intra-chunk product stops at each row's diagonal).  Last
// the state update.  Every product is a 4 x 4 register tile per thread fed
// by float4 reads from shared memory (four rows of the reduction in flight
// at a time), on the CUDA cores.  Zamba2's layer shape (B 4, H 112,
// S 4,096, N 64, P 64, Q 128) gives 448 CTAs over 132 SMs with 112 KB of
// shared memory each at TQ 32, so two CTAs share an SM and one computes
// while the other waits on its loads (64-row tiles need 137 KB, one CTA
// per SM, and ran 16% slower on the card).
// - Strided inputs: every tensor comes with its element strides, so q and
//   k may be head-broadcast views (head stride 0, as `mamba2_forward`
//   passes them) and y is written straight into the model's (B, S, H, P)
//   layout.  Rows with unit-stride, 16-byte-aligned columns (the Zamba2
//   path's) are staged as 16-byte loads; other layouts element by element.
// - Ragged sizes: N, P and Q are padded to multiples of 4 in shared memory
//   with zeros (q = k = v = 0, log_a = 0).  A padded key adds nothing to a
//   real row (causal: it comes after every real row) and nothing to the
//   state (k = 0; log_a = 0 leaves total unchanged).
// - Limits (the wrapper checks them on either device, this file again):
//   N, P <= 128, Q <= 256, S a multiple of Q, shared memory <= 227 KB;
//   the wrapper picks TQ (32, or less where the chunk would not fit: 16 at
//   N = P = Q = 128).
// - No fast-math: IEEE expf.
//
// Bound: bytes.  Per chunk of Zamba2's layer 6.29 M FLOPs (2 Q^2 N + 2 Q^2 P
// + 2 Q N P twice, the full Q x Q products as the TPU kernel does them),
// 9.02e10 in all: 0.091 ms at the card's 989 TFLOP/s bf16 tensor-core peak,
// against 489 MB moved (v and y 235 MB each, q and k 2.1 MB each as
// head-broadcast views, log_a and the state 7.3 MB each): 0.146 ms at
// 3.35 TB/s.  This version runs f32 FMAs on the CUDA cores (1.35 ms of
// arithmetic at their 67 TFLOP/s peak); tensor cores (`mma.sync` / `wgmma`
// on bf16), TMA and several (b, h) per CTA are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
  int tile_q;               // query rows per tile, a multiple of 4
  int dtype;                // 0 = float32, 1 = bfloat16 (q, k, v and y)
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 128;          // N and P
constexpr int kMaxChunk = 256;
constexpr int kPerLane = kMaxChunk / 32;   // log_a rows per lane of warp 0
constexpr int kBatch = 8;             // global loads in flight per thread (per stage)
constexpr int kMaxSmem = 232448;      // 227 KB, Hopper's per-block limit

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Shared-memory floats for one CTA; kernels/ssd_chunk/kernel.py
// `_smem_bytes` computes the same.
__host__ __device__ inline long long smem_floats(int n, int p, int chunk, int tq) {
  const long long np = round4(n), pp = round4(p), qp = round4(chunk);
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
  const int n = prm.n, p = prm.p, Q = prm.chunk, TQ = prm.tile_q;
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
  const T* v = static_cast<const T*>(prm.v) + b * prm.v_stride[0] + h * prm.v_stride[1];
  const float* la = prm.log_a + b * prm.la_stride[0] + h * prm.la_stride[1];
  T* y = static_cast<T*>(prm.y) + b * prm.y_stride[0] + h * prm.y_stride[1];
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

  float* out = prm.state + (static_cast<long long>(b) * prm.heads + h) * n * p;
  for (int e = tid; e < n * p; e += kThreads) out[e] = S[(e / p) * PP + e % p];
}

template <typename T>
cudaError_t launch(const SsdParams& prm, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_floats(prm.n, prm.p, prm.chunk, prm.tile_q) * 4);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T><<<prm.batch * prm.heads, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// 0 on success, -1 for parameters the kernel does not take, else the
// cudaError_t of the launch.
extern "C" int ssd_chunk_launch(const SsdParams* prm, void* stream) {
  const SsdParams& P = *prm;
  if (P.batch < 1 || P.heads < 1 || P.seq < 1 || P.n < 1 || P.n > kMaxDim ||
      P.p < 1 || P.p > kMaxDim || P.chunk < 1 || P.chunk > kMaxChunk ||
      P.seq % P.chunk != 0 || P.tile_q < 4 || P.tile_q % 4 != 0 ||
      P.tile_q > round4(P.chunk) || (P.dtype != 0 && P.dtype != 1) ||
      smem_floats(P.n, P.p, P.chunk, P.tile_q) * 4 > kMaxSmem ||
      static_cast<long long>(P.batch) * P.heads > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = P.dtype == 1 ? launch<__nv_bfloat16>(P, s) : launch<float>(P, s);
  return err == cudaSuccess ? 0 : static_cast<int>(err);
}
