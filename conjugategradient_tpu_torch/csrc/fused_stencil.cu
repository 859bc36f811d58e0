// The fused stencil-CG direction kernel for Hopper (sm_90a), bound through
// ctypes.
//
// fused_stencil_dir replaces conjugategradient_tpu/ops/pallas/
// fused_stencil.py: fused_stencil_dir_dot (:69, pallas_call :102), the
// first of the two passes of a fused stencil-CG iteration:
//
//   p = r + beta*p_old;  q = c*p + w*((xm + xp) + (ym + yp) + (zm + zp));
//   pap = p.q
//
// on (nx, ny, nz) float32 volumes, zero Dirichlet boundaries.  The second
// pass (x += alpha p, r -= alpha q, r.r) is fused_cg.cu's update kernel on
// the volumes' flat view.
//
// What bounds it on the H100: bytes.  It reads r and p_old and writes p and
// q once (268.4 MB at 256^3, 0.080 ms at 3.35 TB/s) for ~14 flops a point.
//
// What the TPU design relied on and Hopper lacks, and what replaces it:
// * The TPU kernel recomputes the halo planes of p from r and p_old rather
//   than exchanging them (fused_stencil.py:9-12, 40-44).  Here every
//   neighbour value of p is recomputed the same way, never read back from
//   p_new, because other CTAs are writing p_new while this one runs; the
//   solver keeps p_new and p_old in two buffers that swap each step.  Halo
//   and interior p come from the same __fadd_rn / __fmul_rn formula, so they
//   are bit-identical, and the kernel is bit-equal in p and q to its plain
//   version (ops/cuda/fused_cg._dir_plain with the plain stencil).
// * The dot accumulated into one SMEM scalar across the sequential grid:
//   here each CTA writes a partial and the last CTA to arrive sums them in
//   index order (no float atomics: two runs give the same bits), then does
//   the solver's scalar step alpha = rho / pap with the rho == 0 guard.
// * The kernel is a no-op once ctl[C_LIVE] is 0.
//
// Design: stencil.cu's register march, (8, 32) (y, z) tile per CTA, along
// x over a chunk of planes; per step a thread loads r and p_old of its
// column at x+1 from device memory and its y/z neighbours' r and p_old
// through L1.

#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float dir_at(const float* __restrict__ r,
                                        const float* __restrict__ pold,
                                        float beta, int64_t i) {
  return __fadd_rn(__ldg(r + i), __fmul_rn(beta, __ldg(pold + i)));
}

__global__ void __launch_bounds__(kThreads)
fused_stencil_dir_kernel(const float* __restrict__ r, const float* __restrict__ pold,
                         const float* beta_p, float* __restrict__ pnew,
                         float* __restrict__ q, float* pap_out, float* partials,
                         unsigned* counter, float* scal, const int* ctl, int nx,
                         int ny, int nz, float c, float w, int tiles_z,
                         int tiles_y, int xchunk) {
  if (ctl[C_LIVE] == 0) return;
  __shared__ float red[kWarps];
  const float beta = *beta_p;
  const int tile = blockIdx.x;
  const int bz = tile % tiles_z;
  const int by = (tile / tiles_z) % tiles_y;
  const int bx = tile / (tiles_z * tiles_y);
  const int k = bz * kStencilTZ + (threadIdx.x & (kStencilTZ - 1));
  const int j = by * kStencilTY + threadIdx.x / kStencilTZ;
  float pap_acc = 0.f;
  if (k < nz && j < ny) {
    const int x0 = bx * xchunk;
    const int x1 = min(x0 + xchunk, nx);
    const int64_t plane = (int64_t)ny * nz;
    const int64_t col = (int64_t)j * nz + k;
    float pm = x0 > 0 ? dir_at(r, pold, beta, (x0 - 1) * plane + col) : 0.f;
    float pc = dir_at(r, pold, beta, x0 * plane + col);
#pragma unroll 2
    for (int x = x0; x < x1; ++x) {
      const int64_t i = x * plane + col;
      const float pp = x + 1 < nx ? dir_at(r, pold, beta, i + plane) : 0.f;
      const float ym = j > 0 ? dir_at(r, pold, beta, i - nz) : 0.f;
      const float yp = j + 1 < ny ? dir_at(r, pold, beta, i + nz) : 0.f;
      const float zm = k > 0 ? dir_at(r, pold, beta, i - 1) : 0.f;
      const float zp = k + 1 < nz ? dir_at(r, pold, beta, i + 1) : 0.f;
      const float nb = add_rn(add_rn(add_rn(pm, pp), add_rn(ym, yp)), add_rn(zm, zp));
      const float qv = add_rn(mul_rn(c, pc), mul_rn(w, nb));
      pnew[i] = pc;
      q[i] = qv;
      pap_acc = fmaf(pc, qv, pap_acc);
      pm = pc;
      pc = pp;
    }
  }
  const float s = block_sum(pap_acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
  if (arrive_last(counter)) {
    const float pap = sum_partials(partials, gridDim.x, red);
    if (threadIdx.x == 0) {
      finish_pap(pap, pap_out, scal);
      *counter = 0u;
    }
  }
}

}  // namespace

extern "C" {

// (p_new, q, pap) and alpha on the device.  partials holds at least one
// float per CTA, tz * ty * ceil(nx / xchunk).  Returns a cudaError_t.
int cg_fused_stencil_dir(const float* r, const float* pold, const float* beta,
                         float* pnew, float* q, float* pap, float* partials,
                         unsigned* counter, float* scal, const int* ctl, int nx,
                         int ny, int nz, float c, float w, int xchunk,
                         void* stream) {
  const int tz = (nz + kStencilTZ - 1) / kStencilTZ;
  const int ty = (ny + kStencilTY - 1) / kStencilTY;
  const int tx = (nx + xchunk - 1) / xchunk;
  fused_stencil_dir_kernel<<<tz * ty * tx, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      r, pold, beta, pnew, q, pap, partials, counter, scal, ctl, nx, ny, nz, c,
      w, tz, ty, xchunk);
  return cudaGetLastError();
}

}  // extern "C"
