// DIA and symmetric-DIA SpMV for Hopper (sm_90a), bound through ctypes.
//
// dia_spmv replaces three TPU kernels of conjugategradient_tpu/ops/pallas/
// dia_spmv.py, which compute one function, y = DIA x:
//   dia_spmv_pallas (:181, pallas_call :208), dia_spmv_pallas_2d (:130,
//   :151; the same y on lane-tiled x windows) and dia_spmv_pallas_blocked
//   (:398, :417; the same y on a pre-blocked (ng, ndiag, bl) copy).
//   y[i] = sum_d diags[d, i] * x[i + off_d] over (ndiag, n) f32 diagonals and
//   an f32 x of ncols entries (ncols may differ from n).
// sym_dia_spmv replaces sym_dia_spmv_pallas_blocked (:304, :350):
//   y[i] = sum_k d_k[i] x[i+k] + sum_{k>0} d_k[i-k] x[i-k] over the stored
//   offsets k >= 0 of a symmetric operator, (ndiag, n) f32.
//
// What bounds them on the H100: the diagonal stream.  Each diagonal is read
// once and x and y once, (ndiag + 2) * n * 4 bytes (the TPU kernels'
// cost_estimate, dia_spmv.py:226-228 and :366-369); about 2 flops per
// 4 bytes, so both are memory-bandwidth kernels (0.108 ms for the 41
// diagonals of n = 2,097,152 at 3.35 TB/s, 0.058 ms for its 21-diagonal
// symmetric half).
//
// Design: gather form, one thread per output row, no atomics, so a run
// repeats bit for bit.  A CTA first stages the offsets in shared memory;
// thread i then walks the diagonals in stored order, reading diags[d*n + i]
// (coalesced across the warp, streaming load so it does not evict x) and
// x[i + off_d] (coalesced; x of a few MB stays in the 50 MB L2 across the
// diagonals).  Each term is one __fmul_rn and one __fadd_rn, the plain
// torch version's order and rounding (ops/spmv.dia_apply, sym_dia_apply), so
// on the card the kernel is bit-equal to it.  A column outside the matrix
// contributes diags * 0, exactly as the plain version's zero padding does:
// the index is never clamped, so a NaN in x cannot leak into another row.
// The symmetric mirror's second read of d_k comes from rows i - k that a
// nearby CTA streamed just before (k * 4 bytes back per diagonal), which is
// what the TPU kernel's halo did in VMEM; here it is meant to hit L2.
// Wider per-thread loads and TMA staging are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const float* __restrict__ diags, const int* __restrict__ offs,
                const float* __restrict__ x, float* __restrict__ y, int64_t n,
                int64_t ncols, int ndiag) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < ndiag; d += blockDim.x) s_off[d] = offs[d];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
#pragma unroll 4
  for (int d = 0; d < ndiag; ++d) {
    const int64_t c = i + s_off[d];
    const float xv = (c >= 0 && c < ncols) ? __ldg(x + c) : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(__ldcs(diags + (int64_t)d * n + i), xv));
  }
  y[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
sym_dia_spmv_kernel(const float* __restrict__ diags, const int* __restrict__ offs,
                    const float* __restrict__ x, float* __restrict__ y, int64_t n,
                    int ndiag) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < ndiag; d += blockDim.x) s_off[d] = offs[d];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
#pragma unroll 2
  for (int d = 0; d < ndiag; ++d) {
    const int64_t k = s_off[d];
    const float* dk = diags + (int64_t)d * n;
    const float xv = (i + k < n) ? __ldg(x + i + k) : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(__ldg(dk + i), xv));
    if (k > 0) {
      // the mirror: row i - k's stored value, applied to x[i - k]
      const float t = (i >= k) ? __fmul_rn(__ldg(dk + i - k), __ldg(x + i - k)) : 0.f;
      acc = __fadd_rn(acc, t);
    }
  }
  y[i] = acc;
}

}  // namespace

extern "C" {

// y = DIA x.  offs: ndiag int32 offsets on the device.  Returns a cudaError_t.
int cg_dia_spmv(const float* diags, const int* offs, const float* x, float* y,
                int64_t n, int64_t ncols, int ndiag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  const int64_t grid = (n + kThreads - 1) / kThreads;
  dia_spmv_kernel<<<(unsigned)grid, kThreads, ndiag * sizeof(int), s>>>(
      diags, offs, x, y, n, ncols, ndiag);
  return cudaGetLastError();
}

// y = SymDIA x over the stored offsets >= 0.  Returns a cudaError_t.
int cg_sym_dia_spmv(const float* diags, const int* offs, const float* x, float* y,
                    int64_t n, int ndiag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  const int64_t grid = (n + kThreads - 1) / kThreads;
  sym_dia_spmv_kernel<<<(unsigned)grid, kThreads, ndiag * sizeof(int), s>>>(
      diags, offs, x, y, n, ndiag);
  return cudaGetLastError();
}

}  // extern "C"
