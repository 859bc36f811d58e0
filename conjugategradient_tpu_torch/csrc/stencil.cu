// The matrix-free 3-D 7-point stencil for Hopper (sm_90a), bound through
// ctypes.
//
// stencil7 replaces conjugategradient_tpu/ops/pallas/stencil.py:
// stencil7_pallas (:136, pallas_call :169):
//   y = c*u + w*((xm + xp) + (ym + yp) + (zm + zp))
// on a row-major (nx, ny, nz) volume, zero Dirichlet boundaries, in the
// input's dtype (float, double or bfloat16).  Any grid with every axis
// >= 1: the TPU kernel's nz % 128 and ny % 8 rules are Mosaic tiling rules.
//
// What bounds it on the H100: bytes.  Each point is read once and written
// once (134.2 MB at 256^3 float32, 0.040 ms at 3.35 TB/s; 268.4 MB and
// 0.080 ms in float64) against 8 flops, so it is a memory-bandwidth
// kernel.  The TPU kernel's job was to read u once from HBM with a
// (1 + 2/SX) halo overhead (stencil.py:13-16); this one does the same with
// a register march:
//
// Design: a CTA owns a (kStencilTY, kStencilTZ) = (8, 32) tile of the
// (y, z) plane, one warp per y row (coalesced 128-byte rows), and marches
// along x over a chunk of planes.  Each thread keeps u[x-1], u[x], u[x+1]
// of its own (y, z) column in registers, so per step it loads one new value
// from device memory (u[x+1]); its y and z neighbours are the same plane's
// values that the neighbouring threads of the CTA loaded one step earlier,
// read again through L1 (__ldg).  Only the tile's edge rows and the chunk's
// two end planes come from other CTAs (L2).  Each product and sum is one
// mul_rn / add_rn (common.cuh) in the plain version's order, so the kernel
// is bit-equal to ops/stencil.stencil7_apply on the card; a neighbour past
// the boundary is the value 0 (never a clamped read), so a NaN reaches only
// its own point and its six neighbours, in both versions alike.  TMA
// staging of the tile and its halo is later work.
//
// bfloat16 volumes (the TPU kernel computes in the volume's own dtype,
// stencil.py:130, 166-167): the same kernel on __nv_bfloat16, whose
// mul_rn / add_rn (common.cuh) do each op in float32 and round the result to
// bf16 once, in the same order, as torch does each bf16 op of
// ops/stencil.stencil7_apply.  c and w stay float32, as torch keeps a
// scalar factor of a bf16 tensor in float32 (StencilOperator's are bf16
// values already).  So it is bit-equal to that plain version; it is not the
// float32 kernel on the widened volume, which rounds only its result.  Half
// the bytes: 67.1 MB at 256^3, 0.0200 ms at 3.35 TB/s.  Entry point
// cg_stencil7_bf16.

#include <stdint.h>

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

// T: the volume's type; C: the coefficients' (T, or float for bf16)
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
stencil7_kernel(const T* __restrict__ u, T* __restrict__ y, int nx, int ny,
                int nz, C c, C w, int tiles_z, int tiles_y, int xchunk) {
  const int tile = blockIdx.x;
  const int bz = tile % tiles_z;
  const int by = (tile / tiles_z) % tiles_y;
  const int bx = tile / (tiles_z * tiles_y);
  const int k = bz * kStencilTZ + (threadIdx.x & (kStencilTZ - 1));
  const int j = by * kStencilTY + threadIdx.x / kStencilTZ;
  if (k >= nz || j >= ny) return;
  const int x0 = bx * xchunk;
  const int x1 = min(x0 + xchunk, nx);
  const int64_t plane = (int64_t)ny * nz;
  const int64_t col = (int64_t)j * nz + k;
  const T zero = zero_of<T>();
  T um = x0 > 0 ? __ldg(u + (x0 - 1) * plane + col) : zero;
  T uc = __ldg(u + x0 * plane + col);
#pragma unroll 4
  for (int x = x0; x < x1; ++x) {
    const int64_t i = x * plane + col;
    const T up = x + 1 < nx ? __ldg(u + i + plane) : zero;
    const T ym = j > 0 ? __ldg(u + i - nz) : zero;
    const T yp = j + 1 < ny ? __ldg(u + i + nz) : zero;
    const T zm = k > 0 ? __ldg(u + i - 1) : zero;
    const T zp = k + 1 < nz ? __ldg(u + i + 1) : zero;
    const T nb = add_rn(add_rn(add_rn(um, up), add_rn(ym, yp)), add_rn(zm, zp));
    y[i] = add_rn(mul_rn(c, uc), mul_rn(w, nb));
    um = uc;
    uc = up;
  }
}

template <typename T, typename C>
cudaError_t launch(const T* u, T* y, int nx, int ny, int nz, C c, C w,
                   int xchunk, cudaStream_t s) {
  const int tz = (nz + kStencilTZ - 1) / kStencilTZ;
  const int ty = (ny + kStencilTY - 1) / kStencilTY;
  const int tx = (nx + xchunk - 1) / xchunk;
  stencil7_kernel<T, C><<<tz * ty * tx, kThreads, 0, s>>>(u, y, nx, ny, nz, c, w,
                                                          tz, ty, xchunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = stencil(u), float32.  Returns a cudaError_t.
int cg_stencil7_f32(const float* u, float* y, int nx, int ny, int nz, float c,
                    float w, int xchunk, void* stream) {
  return launch<float, float>(u, y, nx, ny, nz, c, w, xchunk,
                       static_cast<cudaStream_t>(stream));
}

// y = stencil(u), float64.  Returns a cudaError_t.
int cg_stencil7_f64(const double* u, double* y, int nx, int ny, int nz,
                    double c, double w, int xchunk, void* stream) {
  return launch<double, double>(u, y, nx, ny, nz, c, w, xchunk,
                        static_cast<cudaStream_t>(stream));
}

// y = stencil(u), bfloat16 (every op rounded to bf16; c and w float32).
// Returns a cudaError_t.
int cg_stencil7_bf16(const __nv_bfloat16* u, __nv_bfloat16* y, int nx, int ny, int nz,
                     float c, float w, int xchunk, void* stream) {
  return launch<__nv_bfloat16, float>(u, y, nx, ny, nz, c, w, xchunk,
                                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
