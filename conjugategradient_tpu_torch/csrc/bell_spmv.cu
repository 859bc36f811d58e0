// Blocked-ELL SpMV for Hopper (sm_90a), bound through ctypes.
//
// Replaces conjugategradient_tpu/ops/pallas/ell_spmv.py:bell_spmv_pallas
// (:57, pallas_call :103): y (nrb*bm,) = sum_k blocks[i, k] @ x[block_cols[i, k]]
// over (nrb, kmax, bm, bn) f32 tiles and x as (ncb, bn) f32.  The same
// products the TPU kernel ran on the VPU: FP32 FMA on the CUDA cores, no
// tensor cores, no TF32.
//
// What bounds it on the H100: the tile stream (4 * nrb * kmax * bm * bn
// bytes, read once; 402.7 MB at n = 262,144 block-tridiagonal with 128 x 128
// tiles), so it is a memory-bandwidth kernel.  x is a few MB at most on the
// main path and stays in the 50 MB L2; it is read through the read-only
// path, the tiles with streaming loads (__ldcs) so they do not evict it.
//
// Design: one warp per output row (global row gr = block-row * bm + m);
// lane l reads columns l + 32 j of that row in each of the kmax tiles, so a
// warp's loads are 128-byte coalesced runs.  This mapping takes any row
// tile height bm at run time (the tester packs 128 x 128, load_matrix's
// default is 8 x 128): a CTA of 8 warps covers 8 rows, whatever block-rows
// they lie in, so a bm = 8 operator keeps as many loads in flight as a
// bm = 128 one.  Each lane sums its products over k and j in a fixed order
// and the warp reduces by butterfly, so every run gives the same bits.
// Padding slots (zero tiles at column block 0) are read like real ones, as
// on the TPU.  TMA rings and wider per-thread loads are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

template <int BN>
__global__ void __launch_bounds__(kThreads)
bell_spmv_kernel(const float* __restrict__ blocks, const int* __restrict__ cols,
                 const float* __restrict__ x, float* __restrict__ y,
                 int64_t rows, int bm, int kmax) {
  constexpr int NJ = BN / 32;
  const int lane = threadIdx.x & 31;
  const int64_t gr = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gr >= rows) return;  // the whole warp leaves together
  const int64_t row = gr / bm;
  const int m = (int)(gr - row * bm);
  const int* rc = cols + row * kmax;
  const int64_t tile = (int64_t)bm * BN;
  const float* t = blocks + row * kmax * tile + (int64_t)m * BN + lane;
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < kmax; ++k) {
    const float* xc = x + (int64_t)__ldg(rc + k) * BN + lane;
    const float* tk = t + k * tile;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc = fmaf(__ldcs(tk + 32 * j), __ldg(xc + 32 * j), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) y[gr] = acc;
}

template <int BN>
cudaError_t launch_bell_spmv(const float* blocks, const int* cols, const float* x,
                             float* y, int64_t rows, int bm, int kmax,
                             cudaStream_t s) {
  const int64_t grid = (rows + kWarps - 1) / kWarps;
  bell_spmv_kernel<BN><<<(unsigned)grid, kThreads, 0, s>>>(blocks, cols, x, y,
                                                           rows, bm, kmax);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = A x on blocked-ELL tiles; rows = nrb * bm.  Returns a cudaError_t.
int cg_bell_spmv(const float* blocks, const int* cols, const float* x, float* y,
                 int64_t rows, int bm, int kmax, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  switch (bn) {
    case 32: return launch_bell_spmv<32>(blocks, cols, x, y, rows, bm, kmax, s);
    case 64: return launch_bell_spmv<64>(blocks, cols, x, y, rows, bm, kmax, s);
    case 128: return launch_bell_spmv<128>(blocks, cols, x, y, rows, bm, kmax, s);
    case 256: return launch_bell_spmv<256>(blocks, cols, x, y, rows, bm, kmax, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
