// Device helpers shared by the kernel sources of this directory.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// layout of a fused solve's scalar buffers (ops/cuda/fused_cg.py keeps the
// same indices)
enum { S_RHO = 0, S_RNORM = 1, S_BETA = 2, S_ALPHA = 3, S_TOL = 4 };
enum { C_K = 0, C_DONE = 1, C_MAXITER = 2, C_LIVE = 3 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order block sum over a 1-D block of kThreads; valid in thread 0.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) s += red[i];
  }
  return s;
}

// True in every thread of the last CTA of a 1-D grid to finish.  Each
// CTA's thread 0 has written its partial before this call.
__device__ bool arrive_last(unsigned* counter) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// Sum of n partials in index order (per-thread strided, then block_sum);
// valid in thread 0.  __ldcg reads L2, where the other CTAs' writes are.
__device__ float sum_partials(const float* parts, int n, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s += __ldcg(parts + i);
  return block_sum(s, red);
}

// last CTA of a direction kernel (K1): pap, then alpha = rho / pap
// (alpha = 0 when rho == 0: a warm start at the solution keeps x intact)
__device__ void finish_pap(float pap, float* pap_out, float* scal) {
  pap_out[0] = pap;
  const float rho = scal[S_RHO];
  scal[S_ALPHA] = rho == 0.f ? 0.f : rho / pap;
}

// One rounding per product and per sum, never contracted into an FMA:
// the plain torch versions round each elementwise op the same way.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The 7-point stencil kernels' CTA: a (kStencilTY, kStencilTZ) tile of
// one (y, z) plane, one warp per y row, marching along x.
constexpr int kStencilTZ = 32;
constexpr int kStencilTY = kThreads / kStencilTZ;

}  // namespace
