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
//
// The packed kernel (bell_spmv_packed_kernel) computes the same function
// from the operator's nonzeros only (types/bell.py PackedBell: SELL-32,
// values and int32 global columns column-major within each 32-row chunk).
// On a sparse-tile matrix the dense kernel's tile stream is mostly zeros:
// poisson3d_48 at 128 x 128 streams 283.1 MB for 760,320 nonzeros, which
// need 6.1 MB of values and columns.  What bounds the packed kernel: those
// bytes, plus x read and y written (x is gathered, but it stays in the
// 50 MB L2).  Design: one lane per row, a warp per chunk, so each step k of
// a warp loads 32 consecutive values and 32 consecutive columns; a lane
// issues four nonzeros' loads before it uses them, and reads x through the
// read-only path.  A lane sums its row in k order with one rounding per
// product and per sum (__fmul_rn / __fadd_rn), the plain version's order
// and rounding, so the two agree bit for bit; entries past a row's length
// are never read, so 0 * Inf never enters a row that has no such nonzero.
// It takes any bm and bn.

#include <stdint.h>

#include "common.cuh"
#include "tile.cuh"

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

__global__ void __launch_bounds__(kThreads)
bell_spmv_packed_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                        const int* __restrict__ row_len,
                        const long long* __restrict__ chunk_off,
                        const float* __restrict__ x, float* __restrict__ y,
                        int64_t rows) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  y[r] = packed_row(vals, cols, row_len, chunk_off, r, [&](int c) { return __ldg(x + c); });
}

}  // namespace

extern "C" {

// y = A x from the packed nonzeros; rows = nrb * bm.  Returns a cudaError_t.
int cg_bell_spmv_packed(const float* vals, const int* cols, const int* row_len,
                        const long long* chunk_off, const float* x, float* y,
                        int64_t rows, void* stream) {
  if (rows <= 0) return cudaSuccess;
  const int64_t grid = (rows + kThreads - 1) / kThreads;
  bell_spmv_packed_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, cols, row_len, chunk_off, x, y, rows);
  return cudaGetLastError();
}

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
