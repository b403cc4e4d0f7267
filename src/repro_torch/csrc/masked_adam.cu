// Fused block-masked Adam for Hopper (sm_90a), in place on packed buffers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/masked_adam/kernel.py,
// `_adam_kernel` (launched by `masked_adam_kernel`; `masked_adam_stacked`
// folds a client axis into the same launch, as the wrapper does here).
//
// What it computes, per element of a block whose mask bit is set:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = p - lr*(m'/bc1) / (sqrt(v'/bc2) + eps)
// with scalars = [lr, bc1, bc2, eps] read from device memory (bc = 1 - b**t,
// computed on the device from the step count, so no host sync and no
// rebuild per step).  A block whose bit is 0 is not touched at all.
//
// Layout: p, g, m, v are (rows, 128) f32, row-major and contiguous; a mask
// block is block_rows x 128 elements (8 x 128 = 1024 by default).
//
// Design: one CTA per mask block, 256 threads, one float4 per thread and
// iteration (a 1024-element block is exactly one float4 per thread).  A CTA
// whose bit is 0 returns before any load, and the update is in place, so
// frozen bytes are never read or written — what the TPU kernel's
// input/output aliasing was for.  Each op below is an explicit
// round-to-nearest intrinsic: no FMA contraction and IEEE sqrt / division
// (the build passes no --use_fast_math), so the result matches the plain
// PyTorch version op for op.
//
// Bound: memory.  Per trained element it reads p, g, m, v and writes p, m, v:
// 7 x 4 B = 28 B.  ResNet-8 with every block trained is 197 blocks x 1024 x
// 28 B = 5.65 MB, about 1.7 us at 3.35 TB/s — at that size the launch
// dominates.  Making it fast (e.g. one launch for several steps or clients,
// or CUDA graphs around the local step) is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
masked_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   const int32_t* __restrict__ block_mask,
                   const float* __restrict__ scalars, float b1, float omb1,
                   float b2, float omb2, int block_rows) {
  const int64_t blk = blockIdx.x;
  if (block_mask[blk] == 0) return;
  const float lr = scalars[0], bc1 = scalars[1], bc2 = scalars[2], eps = scalars[3];
  const int vecs = block_rows * (kLanes / 4);          // float4s in one block
  const int64_t base = blk * vecs;
  float4* p4 = reinterpret_cast<float4*>(p) + base;
  const float4* g4 = reinterpret_cast<const float4*>(g) + base;
  float4* m4 = reinterpret_cast<float4*>(m) + base;
  float4* v4 = reinterpret_cast<float4*>(v) + base;
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i];
    adam_elem(pp.x, gg.x, mm.x, vv.x, b1, omb1, b2, omb2, lr, bc1, bc2, eps);
    adam_elem(pp.y, gg.y, mm.y, vv.y, b1, omb1, b2, omb2, lr, bc1, bc2, eps);
    adam_elem(pp.z, gg.z, mm.z, vv.z, b1, omb1, b2, omb2, lr, bc1, bc2, eps);
    adam_elem(pp.w, gg.w, mm.w, vv.w, b1, omb1, b2, omb2, lr, bc1, bc2, eps);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// Python wrapper has checked devices, dtypes, shapes and contiguity.
// omb1 / omb2 are (1 - b1) / (1 - b2) rounded to f32 by the caller, as the
// reference's Python-float arithmetic rounds them.
extern "C" int masked_adam_launch(float* p, const float* g, float* m, float* v,
                                  const int32_t* block_mask,
                                  const float* scalars, float b1, float omb1,
                                  float b2, float omb2, int block_rows,
                                  long long num_blocks, cudaStream_t stream) {
  if (num_blocks <= 0) return 0;
  masked_adam_kernel<<<static_cast<unsigned int>(num_blocks), kThreads, 0,
                       stream>>>(p, g, m, v, block_mask, scalars, b1, omb1,
                                 b2, omb2, block_rows);
  return static_cast<int>(cudaGetLastError());
}
