// Grouped float32 matrix products for Hopper (sm_90a): the expert products
// of the dropless MoE layer (models/moe.py `moe_apply_dropless`).
//
// Replaces no TPU kernel of src/repro/kernels: the reference's MoE layer is
// capacity-bounded (a dense (E, C, d) buffer, plain batched products).  A
// dropless layer's rows per expert are known only on the device, so without
// a grouped product the layer would read the group sizes back to the host
// every step (stalling the card) or compute every expert on every entry.
//
// What it computes.  Rows are grouped: group g of client c is rows
// ends[c, g-1] .. ends[c, g]-1 (from 0 for g = 0); rows at or past
// ends[c, G-1] belong to no group.
//   grouped_mm:    Y[c, r, :] = X[c, r, :] @ W[c, g(r)]   (r in a group)
//                  -- the forward products and the input gradient
//                  (dY @ W[c, g]^T: the same kernel on a transposed view);
//                  rows in no group are not written (the caller zeroes Y).
//   grouped_wgrad: dW[c, g] = X[c, rows of g]^T @ dY[c, rows of g]
//                  -- the weight gradient; an empty group writes zeros.
// Any strides: each operand's layout picks how a tile is loaded (template
// flags), never what is computed.  Products are fmaf in float32, no TF32.
//
// Bound: operations.  At DeepSeek-V2-Lite's expert widths (2,048 x 1,408)
// and ~384 rows a group, a product does 2 rows d_in d_out operations on
// (rows (d_in + d_out) + d_in d_out) 4 bytes, ~190 operations a byte,
// far above the card's float32 ridge (67 TFLOP/s / 3.35 TB/s = 20).
//
// Design: the classic SIMT tile.  A CTA of 256 threads computes a 128 x 128
// output tile, each thread an 8 x 8 block of it in registers, stepping
// through the shared dimension 8 deep: both operand tiles are staged in
// shared memory (double-buffered, the next step's loads in flight in
// registers while the current step's 512 FMAs a thread run), so each
// element read from device memory feeds 128 products.  grouped_mm is
// persistent: the grid is fixed by the shapes (two CTAs per SM); each CTA
// first turns the group ends into a prefix of tiles in shared memory, then
// walks the tiles t = blockIdx.x, + gridDim.x, ... finding each tile's
// group by binary search -- nothing about the routing goes back to the host
// and no CTA is launched for an empty tile.  grouped_wgrad's tiles are fixed
// by the shapes ((C G) x d_in/128 x d_out/128); each loops over its group's
// rows.

#include <cuda_runtime.h>
#include <cstdint>

// The launches' arguments, one struct each so the host marshals one pointer
// per call (kernels/grouped_mm/kernel.py mirrors them field for field).
struct GroupedParams {
  const float* x;          // (C, rows, k) any strides
  const float* w;          // (C, G, k, n) any strides
  float* y;                // (C, rows, n) any strides
  const int* ends;         // (C, G) int32, contiguous
  long long sxc, sxm, sxk;
  long long swc, swg, swk, swn;
  long long syc, sym, syn;
  int clients, groups, rows, k, n;
};

struct WgradParams {
  const float* x;          // (C, rows, m) any strides
  const float* dy;         // (C, rows, n) any strides
  float* dw;               // (C, G, m, n) any strides
  const int* ends;         // (C, G) int32, contiguous
  long long sxc, sxm, sxk;
  long long syc, sym, syn;
  long long swc, swg, swk, swn;
  int clients, groups, rows, m, n;
};

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kPad = 4, kThreads = 256;
constexpr int kMaxGroups = 2048;   // clients x groups a grouped_mm launch takes
constexpr int kTooManyGroups = 10000;  // the launchers' own error code

typedef float Stage[kBK][kBM + kPad];

// Four elements of a (kBK x 128) operand tile, element (i, kk) at
// base[i * si + (k_off + kk) * sk], zero where i >= i_lim or k_off + kk >=
// k_lim.  KC (the shared dimension contiguous): thread -> i = tid / 2 and 4
// consecutive kk; else kk = tid / 32 and 4 consecutive i.  Either way a warp
// reads whole 32-byte sectors.
template <bool KC>
__device__ __forceinline__ void load_tile(float (&r)[4], const float* base, long long si,
                                          long long sk, int i_lim, int k_off, int k_lim,
                                          int tid) {
  if (KC) {
    const int i = tid >> 1, kk = (tid & 1) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k_off + kk + j;
      r[j] = (i < i_lim && k < k_lim) ? base[i * si + k * sk] : 0.f;
    }
  } else {
    const int kk = tid >> 5, i = (tid & 31) * 4, k = k_off + kk;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = (k < k_lim && i + j < i_lim) ? base[(i + j) * si + k * sk] : 0.f;
  }
}

template <bool KC>
__device__ __forceinline__ void store_tile(Stage& s, const float (&r)[4], int tid) {
  if (KC) {
    const int i = tid >> 1, kk = (tid & 1) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) s[kk + j][i] = r[j];
  } else {
    const int kk = tid >> 5, i = (tid & 31) * 4;
    *reinterpret_cast<float4*>(&s[kk][i]) = make_float4(r[0], r[1], r[2], r[3]);
  }
}

// acc = A (m_lim x k_len) @ B (k_len x n_lim) for one 128 x 128 tile; A's
// element (i, k) at a[i * sam + k * sak], B's (k, j) at b[k * sbk + j * sbn].
// Thread (tx, ty) = (tid % 16, tid / 16) owns rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}.
template <bool A_KC, bool B_KC>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const float* a, long long sam,
                                             long long sak, int m_lim, const float* b,
                                             long long sbk, long long sbn, int n_lim,
                                             int k_len, Stage* as, Stage* bs) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ra[4], rb[4];
  load_tile<A_KC>(ra, a, sam, sak, m_lim, 0, k_len, tid);
  load_tile<B_KC>(rb, b, sbn, sbk, n_lim, 0, k_len, tid);
  store_tile<A_KC>(as[0], ra, tid);
  store_tile<B_KC>(bs[0], rb, tid);
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < k_len; k0 += kBK) {
    const bool more = k0 + kBK < k_len;
    if (more) {
      load_tile<A_KC>(ra, a, sam, sak, m_lim, k0 + kBK, k_len, tid);
      load_tile<B_KC>(rb, b, sbn, sbk, n_lim, k0 + kBK, k_len, tid);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store_tile<A_KC>(as[cur ^ 1], ra, tid);
      store_tile<B_KC>(bs[cur ^ 1], rb, tid);
    }
    __syncthreads();
    cur ^= 1;
  }
}

__device__ __forceinline__ void store_acc(const float (&acc)[8][8], float* y, long long sym,
                                          long long syn, int m_lim, int n_lim) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (r >= m_lim) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      if (col < n_lim) y[r * sym + col * syn] = acc[i][j];
    }
  }
}

// group g of client c: rows [*s, *e), clamped to the buffer's rows
__device__ __forceinline__ void group_rows(const int* ends, int cg, int g, int rows, int* s,
                                           int* e) {
  const int hi = min(max(ends[cg], 0), rows);
  const int lo = g ? min(max(ends[cg - 1], 0), hi) : 0;
  *s = lo;
  *e = hi;
}

template <bool A_KC, bool B_KC>
__global__ void __launch_bounds__(kThreads, 2) grouped_mm_kernel(const GroupedParams p) {
  __shared__ __align__(16) Stage as[2];
  __shared__ __align__(16) Stage bs[2];
  __shared__ int prefix[kMaxGroups + 1];
  const int cgs = p.clients * p.groups, ntn = (p.n + kBN - 1) / kBN;
  for (int i = threadIdx.x; i < cgs; i += kThreads) {
    int s, e;
    group_rows(p.ends, i, i % p.groups, p.rows, &s, &e);
    prefix[i + 1] = (e - s + kBM - 1) / kBM * ntn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    prefix[0] = 0;
    for (int i = 0; i < cgs; ++i) prefix[i + 1] += prefix[i];
  }
  __syncthreads();
  const int total = prefix[cgs];
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int lo = 0, hi = cgs - 1;                 // the last group whose tiles start at or before t
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (prefix[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const int local = t - prefix[lo], mt = local / ntn, nt = local % ntn;
    const int c = lo / p.groups, g = lo % p.groups;
    int s, e;
    group_rows(p.ends, lo, g, p.rows, &s, &e);
    const int row0 = s + mt * kBM, n0 = nt * kBN;
    const int m_lim = min(kBM, e - row0), n_lim = min(kBN, p.n - n0);
    const float* a = p.x + c * p.sxc + row0 * p.sxm;
    const float* b = p.w + c * p.swc + g * p.swg + n0 * p.swn;
    float acc[8][8];
    tile_product<A_KC, B_KC>(acc, a, p.sxm, p.sxk, m_lim, b, p.swk, p.swn, n_lim, p.k, as, bs);
    store_acc(acc, p.y + c * p.syc + row0 * p.sym + n0 * p.syn, p.sym, p.syn, m_lim, n_lim);
  }
}

// Grid (C G, m / 128, n / 128): the (m, n) tile of dW[c, g], over the group's rows.
template <bool A_KC, bool B_KC>
__global__ void __launch_bounds__(kThreads, 2) grouped_wgrad_kernel(const WgradParams p) {
  __shared__ __align__(16) Stage as[2];
  __shared__ __align__(16) Stage bs[2];
  const int cg = blockIdx.x, c = cg / p.groups, g = cg % p.groups;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.z * kBN;
  int s, e;
  group_rows(p.ends, cg, g, p.rows, &s, &e);
  const int m_lim = min(kBM, p.m - m0), n_lim = min(kBN, p.n - n0);
  const float* a = p.x + c * p.sxc + s * p.sxm + m0 * p.sxk;   // (i, k) = X[s + k, m0 + i]
  const float* b = p.dy + c * p.syc + s * p.sym + n0 * p.syn;  // (k, j) = dY[s + k, n0 + j]
  float acc[8][8];
  tile_product<A_KC, B_KC>(acc, a, p.sxk, p.sxm, m_lim, b, p.sym, p.syn, n_lim, e - s, as, bs);
  store_acc(acc, p.dw + c * p.swc + g * p.swg + m0 * p.swk + n0 * p.swn, p.swk, p.swn, m_lim,
            n_lim);
}

template <bool A_KC, bool B_KC>
int launch_mm(const GroupedParams& p, int ctas, cudaStream_t stream) {
  grouped_mm_kernel<A_KC, B_KC><<<ctas, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool A_KC, bool B_KC>
int launch_wgrad(const WgradParams& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(p.clients * p.groups),
                  static_cast<unsigned int>((p.m + kBM - 1) / kBM),
                  static_cast<unsigned int>((p.n + kBN - 1) / kBN));
  grouped_wgrad_kernel<A_KC, B_KC><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch each; returns cudaGetLastError() (0 = launched), or 10000 when
// clients x groups is over what grouped_mm's prefix holds.  `ctas`: the
// persistent grid (the wrapper passes two per SM).
extern "C" int grouped_mm_launch(const GroupedParams* p, int ctas, cudaStream_t stream) {
  if (p->clients * p->groups > kMaxGroups) return kTooManyGroups;
  if (p->clients <= 0 || p->groups <= 0 || p->n <= 0 || p->rows <= 0) return 0;
  const bool a_kc = p->sxk == 1, b_kc = p->swk == 1 && p->swn != 1;
  if (a_kc) return b_kc ? launch_mm<true, true>(*p, ctas, stream)
                        : launch_mm<true, false>(*p, ctas, stream);
  return b_kc ? launch_mm<false, true>(*p, ctas, stream)
              : launch_mm<false, false>(*p, ctas, stream);
}

extern "C" int grouped_wgrad_launch(const WgradParams* p, cudaStream_t stream) {
  if (p->clients <= 0 || p->groups <= 0 || p->m <= 0 || p->n <= 0) return 0;
  // A's (i, k) = X[s + k, m0 + i]: the shared dimension runs over rows
  const bool a_kc = p->sxm == 1, b_kc = p->sym == 1 && p->syn != 1;
  if (a_kc) return b_kc ? launch_wgrad<true, true>(*p, stream)
                        : launch_wgrad<true, false>(*p, stream);
  return b_kc ? launch_wgrad<false, true>(*p, stream)
              : launch_wgrad<false, false>(*p, stream);
}
