// Fused block-masked Adam for Hopper (sm_90a), in place on packed buffers.
//
// Replaces both Pallas TPU kernels of src/repro/kernels/masked_adam/kernel.py
// with one kernel, `masked_adam_cohort_kernel`: `_adam_kernel` (launched by
// `masked_adam_kernel`, one client) is its one-client case, and
// `masked_adam_stacked` (the client axis folded into one call) its cohort
// case, which takes a whole bucket's local step in one launch.
//
// What it computes, per element of a block that is trained:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = p - lr*(m'/bc1) / (sqrt(v'/bc2) + eps)
// with scalars = [lr, bc1, bc2, eps] read from device memory (bc = 1 - b**t,
// computed on the device from the step count, so no host sync and no
// rebuild per step).  A block that is not trained is not touched at all.
//
// Layout: p, g, m, v are (clients, rows, 128) f32, row-major and
// contiguous; a block is block_rows x 128 elements (8 x 128 = 1024 by
// default).  Each op is an explicit round-to-nearest intrinsic: no FMA
// contraction and IEEE sqrt / division (the build passes no
// --use_fast_math), so every trained element matches the plain PyTorch
// version bit for bit, whatever the cohort's size.
//
// Block b of client c is trained iff
//   gid[b] >= 0  &&  gmask[c, gid[b]] != 0  &&  valid[c] != 0
// — gid the per-block layer-group id (-1 for BN running moments and pad),
// gmask the (clients, groups) plan bitmask (every row the round's group on
// a homogeneous round), valid the step's column of the bucket's pad-and-
// mask table — the reference's `plan_block_mask` and its `where(keep, ...)`
// over padded steps, decided here, so no per-step mask tensor is built and
// no launch is spent on one.  A caller with a plain per-block mask passes
// gid = the block index and gmask = the mask.
//
// Bound: memory.  Per trained element the kernel reads p, g, m, v and
// writes p, m, v: 7 x 4 B = 28 B.  ResNet-8 with every block trained is
// 197 blocks x 1024 x 28 B = 5.65 MB, 1.7 us at 3.35 TB/s; a cohort of 8
// clients is 45.2 MB, 13.5 us.
//
// The launch-bound regime: one client's step at ResNet-8's size moves
// fewer bytes than a launch and its host call cost, so launching once per
// client and step leaves the card idle.  One launch here covers every
// client of a bucket (the vmap engine: 8 clients, 45 MB, enough to keep
// HBM busy for longer than the launch takes), and the host side is one
// pre-built argument struct (the wrapper validates a bucket's buffers once,
// when they are allocated).
//
// The grid is sized to the work: one CTA of 256 threads per (block,
// client) pair, one float4 of each of p, g, m, v per thread; a CTA whose
// pair is not trained returns before any load.  A grid-stride design (a
// few 128-thread CTAs per SM, two float4s per thread) was measured first
// and was slower at every size on the main path and at 2^20 rows
// (PERF.md §6): with one client the card runs only 197 CTAs, and the
// IEEE division chains need the extra threads to hide their latency.

#include <cuda_runtime.h>
#include <cstdint>

// The cohort launch's arguments, one struct so the host marshals one
// pointer per call (kernels/masked_adam/kernel.py ``_CohortParams`` mirrors it
// field for field).
struct CohortParams {
  float* p;                 // (clients, rows, 128), in place
  const float* g;           // (clients, rows, 128)
  float* m;                 // (clients, rows, 128), in place
  float* v;                 // (clients, rows, 128), in place
  const int32_t* gid;       // (num_blocks,) group id per block, -1 = never
  const int32_t* gmask;     // (clients, groups) 0 / 1
  const int32_t* valid;     // (clients,) this step's pad-and-mask column
  const float* scalars;     // (4,) [lr, bc1, bc2, eps] of this step
  float b1, omb1, b2, omb2;  // omb = 1 - b, rounded to f32 by the caller
  int block_rows, num_blocks, clients, groups;
  long long client_elems;   // rows * 128
};

namespace {

constexpr int kLanes = 128;

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v,
                                          float b1, float omb1, float b2,
                                          float omb2, float lr, float bc1,
                                          float bc2, float eps) {
  const float mn = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
  const float vn = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(omb2, g), g));
  const float mh = __fdiv_rn(mn, bc1);
  const float vh = __fdiv_rn(vn, bc2);
  const float step = __fdiv_rn(__fmul_rn(lr, mh), __fadd_rn(__fsqrt_rn(vh), eps));
  p = __fsub_rn(p, step);
  m = mn;
  v = vn;
}

constexpr int kThreads = 256;   // one float4 of each of p, g, m, v per thread

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m,
                                      float4& v, float b1, float omb1,
                                      float b2, float omb2, float lr,
                                      float bc1, float bc2, float eps) {
  adam_elem(p.x, g.x, m.x, v.x, b1, omb1, b2, omb2, lr, bc1, bc2, eps);
  adam_elem(p.y, g.y, m.y, v.y, b1, omb1, b2, omb2, lr, bc1, bc2, eps);
  adam_elem(p.z, g.z, m.z, v.z, b1, omb1, b2, omb2, lr, bc1, bc2, eps);
  adam_elem(p.w, g.w, m.w, v.w, b1, omb1, b2, omb2, lr, bc1, bc2, eps);
}

// Grid (num_blocks, clients): CTA (b, c) updates block b of client c.
__global__ void __launch_bounds__(kThreads)
masked_adam_cohort_kernel(const CohortParams a) {
  const int b = blockIdx.x, c = blockIdx.y;
  const int grp = a.gid[b];
  if (grp < 0 || a.valid[c] == 0 ||
      a.gmask[static_cast<long long>(c) * a.groups + grp] == 0)
    return;                                            // before any load
  const float lr = a.scalars[0], bc1 = a.scalars[1], bc2 = a.scalars[2],
              eps = a.scalars[3];
  const int vecs = a.block_rows * (kLanes / 4);        // float4s in one block
  const long long base =
      c * (a.client_elems / 4) + static_cast<long long>(b) * vecs;
  float4* p4 = reinterpret_cast<float4*>(a.p) + base;
  const float4* g4 = reinterpret_cast<const float4*>(a.g) + base;
  float4* m4 = reinterpret_cast<float4*>(a.m) + base;
  float4* v4 = reinterpret_cast<float4*>(a.v) + base;
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i];
    adam4(pp, gg, mm, vv, a.b1, a.omb1, a.b2, a.omb2, lr, bc1, bc2, eps);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
}

}  // namespace

// One launch for a cohort's local step; returns cudaGetLastError() (0 =
// launched).  The wrapper validated the buffers once, when the engine
// allocated them (clients <= 65535, the grid's y limit).
extern "C" int masked_adam_cohort_launch(const CohortParams* params,
                                         cudaStream_t stream) {
  if (params->clients <= 0 || params->num_blocks <= 0) return 0;
  const dim3 grid(static_cast<unsigned int>(params->num_blocks),
                  static_cast<unsigned int>(params->clients));
  masked_adam_cohort_kernel<<<grid, kThreads, 0, stream>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
