// Tile products shared by the fused blocked-ELL kernels (fused_cg.cu,
// fused_minres.cu): one (BN, BN) tile applied forward, mirrored, or both.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

// One (BN, BN) row-major tile T.  Warp w takes rows m = w, w + kWarps, ...;
// lane l takes columns l + 32 j.  FWD: qacc[m] += sum_n T[m, n] xc[n]
// (written by lane 0 of the owning warp only, so tiles of one row chain
// without a barrier).  MIR: tacc[j] += sum_m T[m, l + 32 j] xr[m] over this
// warp's rows; the caller reduces tacc across warps.
template <int BN, bool FWD, bool MIR>
__device__ __forceinline__ void tile_apply(const float* T, const float* xc,
                                           const float* xr, float* qacc,
                                           float (&tacc)[BN / 32]) {
  constexpr int NJ = BN / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float xcv[NJ];
  if (FWD) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) xcv[j] = xc[lane + 32 * j];
  }
#pragma unroll 4
  for (int m = w; m < BN; m += kWarps) {
    float v[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) v[j] = __ldcs(T + (int64_t)m * BN + lane + 32 * j);
    if (FWD) {
      float f = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) f = fmaf(v[j], xcv[j], f);
      f = warp_sum(f);
      if (lane == 0) qacc[m] += f;
    }
    if (MIR) {
      const float xm = xr[m];
#pragma unroll
      for (int j = 0; j < NJ; ++j) tacc[j] = fmaf(v[j], xm, tacc[j]);
    }
  }
}

// Cross-warp sum of the mirror partials into dst[t] (t < BN), warp order.
template <int BN>
__device__ __forceinline__ void mirror_reduce(const float (&tacc)[BN / 32],
                                              float (*red2)[BN], float* dst) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) red2[w][lane + 32 * j] = tacc[j];
  __syncthreads();
  for (int t = threadIdx.x; t < BN; t += kThreads) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += red2[i][t];
    dst[t] = s;
  }
}

}  // namespace
