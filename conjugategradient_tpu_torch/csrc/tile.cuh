// Tile products shared by the fused blocked-ELL kernels (fused_cg.cu,
// fused_minres.cu, fused_bicgstab.cu): one (BN, BN) tile applied forward,
// mirrored, or both; and one row of the packed view of sparse tiles
// (bell_spmv.cu, fused_cg.cu, fused_bicgstab.cu).  Both take float32 or
// bfloat16 tile values E, each widened to float32 as it is loaded
// (common.cuh ld_stream / ld_ro); every product and sum is float32 in the
// same order for either E.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

// One (BN, BN) row-major tile T.  Warp w takes rows m = w, w + kWarps, ...;
// lane l takes columns l + 32 j.  FWD: qacc[m] += sum_n T[m, n] xc[n]
// (written by lane 0 of the owning warp only, so tiles of one row chain
// without a barrier).  MIR: tacc[j] += sum_m T[m, l + 32 j] xr[m] over this
// warp's rows; the caller reduces tacc across warps.
template <int BN, bool FWD, bool MIR, class E = float>
__device__ __forceinline__ void tile_apply(const E* T, const float* xc,
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
    for (int j = 0; j < NJ; ++j) v[j] = ld_stream(T + (int64_t)m * BN + lane + 32 * j);
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

// Row i of A y from the packed view (types/bell.py PackedBell: SELL-32,
// values and int32 global columns column-major within each 32-row chunk),
// y[c] = gather(c): the row's nonzeros in k order, one rounding per product
// and per sum (ops/cuda/bell_spmv.packed_apply's), four nonzeros' loads in
// flight.  Lane i % 32 of a warp takes row i, so a warp's loads of one k
// are one coalesced run.
template <class E, class Gather>
__device__ __forceinline__ float packed_row(const E* __restrict__ vals,
                                            const int* __restrict__ cols,
                                            const int* __restrict__ row_len,
                                            const long long* __restrict__ chunk_off,
                                            int64_t i, Gather gather) {
  const int len = __ldg(row_len + i);
  const int64_t base = __ldg(chunk_off + (i >> 5)) + (i & 31);
  const E* v = vals + base;
  const int* c = cols + base;
  float acc = 0.f;
  int k = 0;
  for (; k + 4 <= len; k += 4) {
    float vv[4], yy[4];
    int cc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      vv[u] = ld_ro(v + 32 * (k + u));
      cc[u] = __ldg(c + 32 * (k + u));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) yy[u] = gather(cc[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = add_rn(acc, mul_rn(vv[u], yy[u]));
  }
  for (; k < len; ++k) acc = add_rn(acc, mul_rn(ld_ro(v + 32 * k), gather(__ldg(c + 32 * k))));
  return acc;
}

}  // namespace
