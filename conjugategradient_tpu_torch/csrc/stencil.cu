// The matrix-free 3-D 7-point stencil for Hopper (sm_90a), bound through
// ctypes: two kernels of one function, each a template in the element type.
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
// 0.080 ms in float64; 67.1 MB and 0.020 ms in bf16) against 8 flops.  The
// TPU kernel DMA'd (SX + 2)-plane windows into VMEM and took the y and z
// neighbours from them (stencil.py:1-21).  Every product and sum is one
// mul_rn / add_rn (common.cuh) in the plain version's order, so both
// kernels are bit-equal to ops/stencil.stencil7_apply on the card; a
// neighbour past the boundary is the value 0 (never a clamped read), so a
// NaN reaches only its own point and its six neighbours.  The wrapper picks
// the kernel before the launch (ops/cuda/stencil.stencil_route).
//
// stencil7_staged_kernel, where u's rows are whole 16-byte pieces on a
// 16-byte aligned base: each thread takes 16 bytes of a row (8 bf16, 4
// float32 or 2 float64 points), and each CTA stages its tile's planes,
// with the rows and 16 bytes beside the tile, through a ring of shared
// memory by per-thread asynchronous copies (cp.async), one plane after
// another along x (design at the kernel).  In bf16 it rounds two points at
// a time (add_rn2 / mul_rn2, common.cuh): add.rn.bf16x2 for each sum and
// one cvt.rn.bf16x2.f32 for two float32 products, where the first port
// rounded each op alone (F2F, 16 a clock an SM; 8 a point).  One bulk copy
// (cp.async.bulk) a row into a ring with mbarriers took 0.037 ms in bf16
// and lost to the register march in float32 and float64 on an H100; these
// per-thread copies take 0.029 ms in bf16 and 0.054 in float32
// (chip_smoke.py --stencil-only, PERF.md).
//
// stencil7_kernel, the register march (the first port; kernel 12 shares
// its tile, common.cuh): a CTA owns a (kStencilTY, kStencilTZ) = (8, 32)
// tile of the (y, z) plane, one warp per y row, and marches along x over a
// chunk of planes, keeping u[x-1], u[x], u[x+1] of its own point in
// registers; its y and z neighbours are the values that the neighbouring
// threads loaded one step earlier, read again through L1 (__ldg).  It takes
// any volume: rows that are not whole 16-byte pieces, offset views whose
// base is not aligned, small volumes (where it is the faster one) and
// float64 volumes (where it is the faster one at every size measured).
// bf16 volumes: mul_rn / add_rn on __nv_bfloat16 do each op in float32 and
// round the result to bf16 once, as torch does each bf16 op.  c and w stay
// float32 for float32 and bf16 volumes, as torch keeps a scalar factor of a
// bf16 tensor in float32, so neither bf16 kernel is the float32 kernel on
// the widened volume, which rounds only its result.

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

// ---- the staged kernel ------------------------------------------------------

// 16 bytes of a row: the V = 16 / sizeof(T) consecutive points of a thread.
union Row16 {
  uint4 q;
  float f[4];
  double d[2];
  unsigned p[4];  // bf16 pairs: point 2i in the lower half, point 2i + 1 in the upper
};

template <typename T>
struct Pts;  // a point's value as a neighbour scalar (shuffled and staged)
template <>
struct Pts<float> {
  using S = float;
  static __device__ __forceinline__ float first(const Row16& r) { return r.f[0]; }
  static __device__ __forceinline__ float last(const Row16& r) { return r.f[3]; }
  static __device__ __forceinline__ float at(const float* p) { return *p; }
};
template <>
struct Pts<double> {
  using S = double;
  static __device__ __forceinline__ double first(const Row16& r) { return r.d[0]; }
  static __device__ __forceinline__ double last(const Row16& r) { return r.d[1]; }
  static __device__ __forceinline__ double at(const double* p) { return *p; }
};
template <>
struct Pts<__nv_bfloat16> {
  using S = unsigned;  // the point's 16 bits, in the lower half
  static __device__ __forceinline__ unsigned first(const Row16& r) { return r.p[0] & 0xffffu; }
  static __device__ __forceinline__ unsigned last(const Row16& r) { return r.p[3] >> 16; }
  static __device__ __forceinline__ unsigned at(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
};

template <typename T>
__device__ __forceinline__ T el(const Row16& r, int i);
template <>
__device__ __forceinline__ float el<float>(const Row16& r, int i) { return r.f[i]; }
template <>
__device__ __forceinline__ double el<double>(const Row16& r, int i) { return r.d[i]; }

// y at a thread's V points from its rows of planes x - 1, x, x + 1 (m, c,
// p), of rows j - 1 and j + 1 (ym, yp) and the two points beside them in z
// (zl before the first, zr after the last): each point's eight ops in
// stencil7_kernel's order, each rounded once, as mul_rn / add_rn round them.
template <typename T>
__device__ __forceinline__ Row16 stencil_points(const Row16& m, const Row16& c, const Row16& p,
                                                const Row16& ym, const Row16& yp, T zl, T zr,
                                                T cc, T ww) {
  constexpr int V = 16 / sizeof(T);
  Row16 y;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const T zm = i > 0 ? el<T>(c, i - 1) : zl;
    const T zp = i + 1 < V ? el<T>(c, i + 1) : zr;
    const T nb = add_rn(add_rn(add_rn(el<T>(m, i), el<T>(p, i)),
                               add_rn(el<T>(ym, i), el<T>(yp, i))),
                        add_rn(zm, zp));
    const T v = add_rn(mul_rn(cc, el<T>(c, i)), mul_rn(ww, nb));
    if constexpr (sizeof(T) == 4) {
      y.f[i] = v;
    } else {
      y.d[i] = v;
    }
  }
  return y;
}

// bf16: the same ops two points at a time (add_rn2, mul_rn2): the z
// neighbours of points (2i, 2i + 1) are the pairs (2i - 1, 2i) and
// (2i + 1, 2i + 2), put together by byte permutes.
__device__ __forceinline__ Row16 stencil_points(const Row16& m, const Row16& c, const Row16& p,
                                                const Row16& ym, const Row16& yp, unsigned zl,
                                                unsigned zr, float cc, float ww) {
  Row16 y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned before = i > 0 ? c.p[i - 1] : zl << 16;
    const unsigned after = i < 3 ? c.p[i + 1] : zr;
    const unsigned zm = __byte_perm(c.p[i], before, 0x1076);
    const unsigned zp = __byte_perm(c.p[i], after, 0x5432);
    const unsigned nb = add_rn2(add_rn2(add_rn2(m.p[i], p.p[i]), add_rn2(ym.p[i], yp.p[i])),
                                add_rn2(zm, zp));
    y.p[i] = add_rn2(mul_rn2(cc, c.p[i]), mul_rn2(ww, nb));
  }
  return y;
}

// The staged kernel's tile: lpr lanes a row (a power of two, at most 32),
// each V points (16 bytes), so a tile row of tz = lpr V points; ty =
// kThreads / lpr rows.  A stage holds one plane's (ty + 2) rows of the tile
// (the rows before and after it: y neighbours) with a V-point halo each
// side (z neighbours): pitch tz + 2 V points, a whole number of 16 bytes.
struct StagedTile {
  int tz, ty, tiles_z, tiles_y, pitch, stage_bytes;
  __host__ __device__ StagedTile(int ny, int nz, int lpr, int esize) {
    const int V = 16 / esize;
    tz = lpr * V;
    ty = kThreads / lpr;
    tiles_z = (nz + tz - 1) / tz;
    tiles_y = (ny + ty - 1) / ty;
    pitch = tz + 2 * V;
    stage_bytes = (ty + 2) * pitch * esize;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A CTA takes one tile and a chunk [x0, x1) of xchunk planes.  Its planes
// x0 .. x1 (x1 only for the last step's x + 1) pass through a ring of S
// stages in shared memory: each thread copies its own 16 bytes of a plane
// (cp.async, bypassing L1), the first and last rows' threads also their
// pieces of the rows before and after the tile, the first and last lanes
// of a row the 16 bytes beside it in z; one commit group a plane, S - 2
// planes ahead of the one after the current.  A thread keeps its points
// of planes x - 1 and x in registers (x - 1 from device memory at the
// chunk's first step), reads those of x + 1 from the next stage, and the y
// and z neighbours from the current one; its lane neighbours' points come
// by shuffles.  A neighbour past the boundary is the value 0, never a read
// (nothing is copied there).  One barrier a step: after it the plane just
// waited for is visible and the stage read two steps before is free.
template <typename T, typename C, int S>
__global__ void __launch_bounds__(kThreads)
stencil7_staged_kernel(const T* __restrict__ u, T* __restrict__ y, int nx, int ny, int nz, C c,
                       C w, int lpr, int xchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  using P = typename Pts<T>::S;
  constexpr int V = 16 / sizeof(T);
  const StagedTile g(ny, nz, lpr, sizeof(T));
  T* ring = reinterpret_cast<T*>(smem);
  const int stage = g.stage_bytes / (int)sizeof(T);
  const int chunks = (nx + xchunk - 1) / xchunk;
  const int tile = blockIdx.x / chunks;
  const int x0 = (blockIdx.x % chunks) * xchunk, x1 = min(x0 + xchunk, nx);
  const int last = min(x1, nx - 1);  // the last plane staged
  const int r = threadIdx.x / lpr, l = threadIdx.x % lpr;
  const int j = (tile / g.tiles_z) * g.ty + r, k = (tile % g.tiles_z) * g.tz + l * V;
  const bool live = j < ny && k < nz;
  const int64_t plane = (int64_t)ny * nz;
  const int64_t col = (int64_t)j * nz + k;
  const int at = (r + 1) * g.pitch + V + l * V;  // this thread's first point in a stage
  auto stage_plane = [&](int x) {
    if (live && x <= last) {
      T* st = ring + ((x - x0) % S) * stage;
      const T* src = u + x * plane + col;
      cp_async16(st + at, src);
      if (r == 0 && j > 0) cp_async16(st + at - g.pitch, src - nz);
      if (r == g.ty - 1 && j + 1 < ny) cp_async16(st + at + g.pitch, src + nz);
      if (l == 0 && k > 0) cp_async16(st + at - V, src - V);
      if (l == lpr - 1 && k + V < nz) cp_async16(st + at + V, src + V);
    }
    cp_async_commit();
  };
  Row16 zero;
  zero.q = make_uint4(0u, 0u, 0u, 0u);
  for (int i = 0; i < S - 1; ++i) stage_plane(x0 + i);
  Row16 um = zero, uc = zero;
  if (live && x0 > 0) um.q = __ldg(reinterpret_cast<const uint4*>(u + (x0 - 1) * plane + col));
  for (int x = x0; x < x1; ++x) {
    cp_async_wait<S - 3>();  // planes up to x + 1 have landed
    __syncthreads();
    stage_plane(x + S - 1);  // into the stage of plane x - 1, read by now
    const T* st = ring + ((x - x0) % S) * stage;
    const T* next = ring + ((x + 1 - x0) % S) * stage;
    if (x == x0 && live) uc = *reinterpret_cast<const Row16*>(st + at);
    Row16 up = zero, ym = zero, yp = zero;
    if (live && x + 1 < nx) up = *reinterpret_cast<const Row16*>(next + at);
    if (live && j > 0) ym = *reinterpret_cast<const Row16*>(st + at - g.pitch);
    if (live && j + 1 < ny) yp = *reinterpret_cast<const Row16*>(st + at + g.pitch);
    // z neighbours: the lanes beside this one in its row, else the halo or 0
    P zl = __shfl_up_sync(0xffffffffu, Pts<T>::last(uc), 1, lpr);
    P zr = __shfl_down_sync(0xffffffffu, Pts<T>::first(uc), 1, lpr);
    if (l == 0) zl = live && k > 0 ? Pts<T>::at(st + at - 1) : P(0);
    if (l == lpr - 1 || k + V >= nz) zr = live && k + V < nz ? Pts<T>::at(st + at + V) : P(0);
    if (live) {
      const Row16 out = stencil_points(um, uc, up, ym, yp, zl, zr, c, w);
      *reinterpret_cast<uint4*>(y + x * plane + col) = out.q;
    }
    um = uc;
    uc = up;
  }
  cp_async_wait<0>();
}

template <typename T, typename C, int S>
cudaError_t launch_staged_s(const T* u, T* y, int nx, int ny, int nz, C c, C w, int lpr,
                            int xchunk, int grid, int smem, cudaStream_t s) {
  static int set_smem = 48 * 1024;  // what a launch may take without the attribute
  if (smem > set_smem) {
    cudaError_t e = cudaFuncSetAttribute(stencil7_staged_kernel<T, C, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    set_smem = smem;
  }
  stencil7_staged_kernel<T, C, S><<<grid, kThreads, smem, s>>>(u, y, nx, ny, nz, c, w, lpr,
                                                               xchunk);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_staged(const T* u, T* y, int nx, int ny, int nz, C c, C w, int lpr,
                          int xchunk, int stages, cudaStream_t s) {
  const StagedTile g(ny, nz, lpr, sizeof(T));
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) || xchunk < 1 ||
      nz % (16 / (int)sizeof(T)) || ((uintptr_t)u | (uintptr_t)y) % 16)
    return cudaErrorInvalidValue;
  const int64_t grid = (int64_t)g.tiles_z * g.tiles_y * ((nx + xchunk - 1) / xchunk);
  if (grid > INT32_MAX) return cudaErrorInvalidValue;
  const int smem = stages * g.stage_bytes;
  switch (stages) {
    case 3:
      return launch_staged_s<T, C, 3>(u, y, nx, ny, nz, c, w, lpr, xchunk, (int)grid, smem, s);
    case 4:
      return launch_staged_s<T, C, 4>(u, y, nx, ny, nz, c, w, lpr, xchunk, (int)grid, smem, s);
    case 6:
      return launch_staged_s<T, C, 6>(u, y, nx, ny, nz, c, w, lpr, xchunk, (int)grid, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
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

// The staged kernel: y = stencil(u) with lpr lanes a tile row (a power of
// two, at most 32), xchunk planes a CTA and a ring of 3, 4 or 6 stages
// (ops/cuda/stencil.staged_geometry); u and y 16-byte aligned, nz *
// sizeof(T) a multiple of 16 (ops/cuda/stencil.stencil_route).  Each
// returns a cudaError_t.
int cg_stencil7_staged_f32(const float* u, float* y, int nx, int ny, int nz, float c, float w,
                           int lpr, int xchunk, int stages, void* stream) {
  return launch_staged<float, float>(u, y, nx, ny, nz, c, w, lpr, xchunk, stages,
                                     static_cast<cudaStream_t>(stream));
}

int cg_stencil7_staged_f64(const double* u, double* y, int nx, int ny, int nz, double c,
                           double w, int lpr, int xchunk, int stages, void* stream) {
  return launch_staged<double, double>(u, y, nx, ny, nz, c, w, lpr, xchunk, stages,
                                       static_cast<cudaStream_t>(stream));
}

int cg_stencil7_staged_bf16(const __nv_bfloat16* u, __nv_bfloat16* y, int nx, int ny, int nz,
                            float c, float w, int lpr, int xchunk, int stages,
                            void* stream) {
  return launch_staged<__nv_bfloat16, float>(u, y, nx, ny, nz, c, w, lpr, xchunk, stages,
                                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
