// Device helpers shared by the kernel sources of this directory.
#pragma once

#include <cuda_bf16.h>
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

// The update kernels' tail (K2/K3, K16).  block_sum2 and sum_partials2
// reduce two values in one pass, each in exactly the order block_sum and
// sum_partials give it, so every bit is theirs; publish_last replaces
// arrive_last: only thread 0, whose partials are the only writes another
// CTA reads, publishes them.

// Loads the compiler keeps where they are written: issued before a branch
// that would otherwise delay them (a not-live return, the last CTA's test),
// so their round trips overlap.  The same ld.global as a plain load.
__device__ __forceinline__ float4 ld_now(const float4* p) {
  float4 v;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_now(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int ld_now(const int* p) {
  int v;
  asm volatile("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// block_sum of a and of b in one butterfly and one pair of barriers;
// valid in thread 0.
__device__ float2 block_sum2(float a, float b, float (*red)[kWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    red[0][w] = a;
    red[1][w] = b;
  }
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) {
      s.x += red[0][i];
      s.y += red[1][i];
    }
  }
  return s;
}

// sum_partials of parts1 and of parts2, both partials of an index loaded
// in one round; valid in thread 0.
__device__ float2 sum_partials2(const float* parts1, const float* parts2, int n,
                                float (*red)[kWarps]) {
  float a = 0.f, b = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    a += __ldcg(parts1 + i);
    b += __ldcg(parts2 + i);
  }
  return block_sum2(a, b, red);
}

// True in every thread of the last CTA of a 1-D grid to arrive.  Thread 0
// has stored this CTA's partials; its one acq_rel ticket releases them and,
// in the last CTA, acquires every other CTA's.  No other thread fences: its
// stores are read by the next launch only, which the kernel boundary orders.
__device__ bool publish_last(unsigned* counter) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(counter), "r"(1u) : "memory");
    last = old == gridDim.x - 1;
  }
  __syncthreads();
  return last;
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
// bfloat16 (the stencil on bf16 volumes): the op in float32, its result
// rounded to bf16 once, as torch computes a bf16 elementwise op (a float32
// scalar times a bf16 value: torch keeps the scalar in float32)
__device__ __forceinline__ __nv_bfloat16 mul_rn(float a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fmul_rn(a, __bfloat162float(b)));
}
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}
// The same two ops on a pair of bf16 values held in one 32-bit word (the
// lower half one point, the upper half the next), each rounded once per
// point.  add_rn2: add.rn.bf16x2 rounds each exact sum of two bf16 values
// to bf16 once; add_rn's float32 sum rounds it twice, to float32 and then
// to bf16, which gives the same bits (float32's 24 bits >= 2 x 8 + 2: a
// double rounding that cannot differ; the two types share their exponent
// range, so subnormal sums are exact in both).  mul_rn2: the two float32
// products of mul_rn, both rounded to bf16 by one cvt.rn.bf16x2.f32.
// Neither is ever contracted into an FMA (explicit .rn).
__device__ __forceinline__ unsigned add_rn2(unsigned a, unsigned b) {
  unsigned r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned mul_rn2(float a, unsigned b) {
  const float lo = __fmul_rn(a, __uint_as_float(b << 16));
  const float hi = __fmul_rn(a, __uint_as_float(b & 0xffff0000u));
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// An operator element (tile or diagonal entry) as float32: a float32 one as
// it is, a bfloat16 one widened, which is exact (its bits shifted up 16), so
// a kernel launched on bf16 operands gives the bits of its float32 launch on
// the widened operands.  ld_stream reads through the streaming path
// (__ldcs: the operator is read once and must not evict the vectors from
// L2), ld_ro through the read-only path (__ldg).
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_stream(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcs(p));
}
__device__ __forceinline__ float ld_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The 7-point stencil kernels' CTA: a (kStencilTY, kStencilTZ) tile of
// one (y, z) plane, one warp per y row, marching along x.
constexpr int kStencilTZ = 32;
constexpr int kStencilTY = kThreads / kStencilTZ;

}  // namespace
