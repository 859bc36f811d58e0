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
//
// dia_spmv_rows is the redesign of dia_spmv for operators of at most 32
// diagonals (same function, same bits).  On an operator that sits in L2
// (poisson3d_48: 7 diagonals, n = 110,592, 4 MB) the time of dia_spmv_kernel
// is chain, not bytes: every CTA first loads the offsets from
// global memory into shared memory and waits at a barrier, and a runtime
// loop unrolled by 4 puts the 7 diagonals' loads in two rounds.  Here the
// offsets are a kernel parameter (the host copies them from a cached host
// array, ops/cuda/dia_spmv.host_offsets), indexed by compile-time indices
// only (the kernel is compiled for 8, 16 and 32 of them): a runtime index
// into the parameter compiled to a chain of uniform loads.  Each thread
// owns 4 consecutive rows: one streaming float4 of each diagonal (n % 4 ==
// 0 and aligned diagonals; else 4 masked loads) and x as a float4 where
// its window is aligned and inside [0, ncols), else 4 loads; a chunk of up
// to 16 diagonals' loads is in flight before its first product.  128-thread
// CTAs: 216 of them on poisson3d_48, so every SM gets work.  chip_smoke.py
// times both kernels on poisson3d_48, a 27-point stencil, a ragged n and a
// misaligned x.  Above 32 diagonals one thread a row, with four times the warps
// to hide latency, was the faster of the two (a build with a 64-offset
// bucket lost to it at 41 and 64 diagonals), so dia_spmv keeps those
// operators (ops/cuda/dia_spmv.dia_route).
//
// sym_dia_spmv_tiled is the redesign of sym_dia_spmv (same function, same
// bits).  One thread per row reads 82 words a row on an operator with 21
// stored offsets k * 1024 (d_k[i], d_k[i-k], x[i+k], x[i-k]): ~690 MB a call
// on symdia-big for the ~193 MB that HBM must supply, and offsets 1024 rows
// apart give no reuse inside a CTA, so every word crosses L2 -> SM: that
// stream, not HBM, is what bounds it (0.126 ms against 0.058 for the HBM
// bytes; the tiled kernel, which moves about a third of those words over
// the same HBM bytes, takes 0.075).  The tiled kernel stages what a CTA's
// rows share:
//   tile   32 columns (a warp's width) x 64 planes spaced by the pitch g, 4
//          warps stacked along the planes, 16 rows a thread with their
//          accumulators in registers: thread (w, t) owns rows
//          (P0 + 16 w + s) * g + c0 + t.  Every offset below n is a whole
//          number of planes plus columns, k = (k / g) g + k % g, so its
//          shift in shared memory is (k / g) * 32 + k % g; g is the offsets'
//          gcd where that is a multiple of 32 (symdia-big: 1024, the shift
//          of k = j * 1024 is j planes in the same column), else 32
//          (contiguous rows, the shift k entries).
//   x      staged once, with hq halo planes on each side, zero outside
//          [0, n).
//   d_k    staged one diagonal at a time over the tile and the planes
//          before it that its mirror terms read: the forward term of row i
//          reads d_k[i], the mirror d_k[i - k], both from shared memory, so
//          a diagonal value crosses L2 -> SM once, plus (k / g) / 64 of halo,
//          and x (64 + 2 hq) / 64 times.
//   pipe   cp.async (16 bytes where aligned) into two diagonal buffers: the
//          next diagonal is in flight while this one is summed, without a
//          register to hold it; 34.8 KB of shared memory a CTA on
//          symdia-big, so six CTAs (24 warps) share an SM.
// A first design with 128-column tiles, 4-byte copies and two to three
// CTAs an SM kept too few loads in flight and ran at half the old kernel's
// speed; leaving x's reuse to L1 (one thread a row on 2-D tiles) gained
// under 10%.
// Each row still sums in stored-offset order, the forward term then for
// k > 0 the mirror, one __fmul_rn and one __fadd_rn each, with the plain
// version's zeros (d * 0 past the end; + 0 for i < k; an offset >= n gives
// d * 0 and + 0 on every row), so it is bit-equal to sym_dia_spmv and to
// ops/spmv.sym_dia_apply.  The host (ops/cuda/dia_spmv.sym_dia_tiling)
// picks g and hq and takes this kernel where it pays: a halo of at most
// the tile's 64 planes and a grid of at least one CTA per SM; sym_dia_spmv
// takes the rest (small operators, where one pass from L2 is quicker, and
// halos beyond shared memory).
//
// dia_spmv and dia_spmv_rows also take bfloat16 diagonals (the TPU kernels'
// other operand form, dia_spmv.py:61-67,107-124, float32 x, float32 y: the
// promoted dtype): the diagonal type is a template parameter, each value is
// widened to float32 as it is loaded (exact), and every product and sum is
// the float32 kernel's in its order, so a bf16 launch gives the bits of the
// float32 launch on diags.float().  dia_spmv_rows reads a thread's four
// rows of a diagonal as one 8-byte load where n % 4 == 0 and the diagonals
// are 8-byte aligned.  The diagonal stream, and with it the bound, halves
// (41 x 2,097,152 x 2 B + x and y on symdia-big: 0.0564 ms).  Their entry
// points are cg_dia_spmv_bf16 and cg_dia_spmv_rows_bf16, counted apart.
//
// sym_dia_spmv and sym_dia_spmv_tiled take bfloat16 diagonals the same way
// (sym_dia_spmv_pallas_blocked's bf16 form, dia_spmv.py:283,286): the
// one-thread-a-row kernel widens each value as it loads it; the tiled one
// stages a diagonal's bf16 values by cp.async, 16 bytes (8 values) a copy,
// into bf16 diagonal buffers (half the float32 ones) and widens each value
// as it reads it from shared memory, where n % 8 == 0 and the diagonals
// are 16-byte aligned (symdia-big); elsewhere it widens while it stages,
// by plain loads and shared stores into the float32 buffers (cp.async
// copies bytes and cannot widen; a first build that did this on every
// shape ran symdia-big at 0.2115 ms against the float32 kernel's 0.0748 on
// an H100: the loads no longer overlapped the sums).  Its route
// (ops/cuda/dia_spmv.sym_dia_tiling), tile and every sum are the float32
// kernel's, so a bf16 launch gives the bits of the float32 launch on
// diags.float().  The diagonal stream halves (21 x 2,097,152 x 2 B + x and
// y on symdia-big: 0.0313 ms).  Entry points cg_sym_dia_spmv_bf16 and
// cg_sym_dia_spmv_tiled_bf16.

#include <stdint.h>

#include <type_traits>

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

template <class E>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const E* __restrict__ diags, const int* __restrict__ offs,
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
    acc = __fadd_rn(acc, __fmul_rn(ld_stream(diags + (int64_t)d * n + i), xv));
  }
  y[i] = acc;
}

// dia_spmv_rows: the offsets by value, kDiaRows consecutive rows a thread.
constexpr int kDiaThreads = 128;
constexpr int kDiaRows = 4;
constexpr int kDiaChunk = 16;     // diagonals whose loads are in flight together
constexpr int kDiaMaxOffs = 32;   // ops/cuda/dia_spmv.MAX_PARAM_DIAGS

// The offsets as a kernel parameter (constant bank): NMAX of them, ndiag
// used.  The kernel indexes them with compile-time indices only: a runtime
// index into a parameter compiles to a chain of uniform loads, or to an
// indexed constant load whose latency each chunk then waits on.
template <int NMAX>
struct DiaOffsets {
  int off[NMAX];
};

// Rows i0 .. i0 + 3 of one diagonal (i0 < n), as float32: one streaming
// load of the four where n % 4 == 0 and the diagonals are aligned to it
// (VEC: a float4, or four bf16 in 8 bytes, each widened), else four loads,
// 0 past n (those rows are not stored).
__device__ __forceinline__ float4 diag_vec(const float* dg) {
  return __ldcs(reinterpret_cast<const float4*>(dg));
}
__device__ __forceinline__ float4 diag_vec(const __nv_bfloat16* dg) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(dg));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <bool VEC, class E>
__device__ __forceinline__ float4 diag_rows(const E* __restrict__ dg, int64_t i0, int64_t n) {
  if (VEC) return diag_vec(dg + i0);
  float4 v;
  v.x = ld_stream(dg + i0);
  v.y = i0 + 1 < n ? ld_stream(dg + i0 + 1) : 0.f;
  v.z = i0 + 2 < n ? ld_stream(dg + i0 + 2) : 0.f;
  v.w = i0 + 3 < n ? ld_stream(dg + i0 + 3) : 0.f;
  return v;
}

// x[c0 .. c0 + 3], 0 outside [0, ncols) (never a clamped index): one
// float4 where the window lies inside and is 16-byte aligned (xvec: x is),
// else four loads.
__device__ __forceinline__ float4 x_window(const float* __restrict__ x, int64_t c0,
                                           int64_t ncols, bool xvec) {
  if (xvec && (c0 & 3) == 0 && c0 >= 0 && c0 + 4 <= ncols) {
    return __ldg(reinterpret_cast<const float4*>(x + c0));
  }
  float4 v;
  v.x = c0 >= 0 && c0 < ncols ? __ldg(x + c0) : 0.f;
  v.y = c0 + 1 >= 0 && c0 + 1 < ncols ? __ldg(x + c0 + 1) : 0.f;
  v.z = c0 + 2 >= 0 && c0 + 2 < ncols ? __ldg(x + c0 + 2) : 0.f;
  v.w = c0 + 3 >= 0 && c0 + 3 < ncols ? __ldg(x + c0 + 3) : 0.f;
  return v;
}

__device__ __forceinline__ float term(float acc, float d, float xv) {
  return __fadd_rn(acc, __fmul_rn(d, xv));
}

template <bool VEC, int NMAX, class E>
__global__ void __launch_bounds__(kDiaThreads)
dia_rows_kernel(const E* __restrict__ diags, const DiaOffsets<NMAX> offs,
                const float* __restrict__ x, float* __restrict__ y, int64_t n, int64_t ncols,
                int ndiag, bool xvec) {
  constexpr int C = NMAX < kDiaChunk ? NMAX : kDiaChunk;
  const int64_t i0 = kDiaRows * ((int64_t)blockIdx.x * kDiaThreads + threadIdx.x);
  if (i0 >= n) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int d0 = 0; d0 < NMAX; d0 += C) {
    if (d0 >= ndiag) break;
    // a chunk's diagonal and x loads, all issued before its first product
    float4 dv[C], xv[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (d0 + j < ndiag) {
        dv[j] = diag_rows<VEC>(diags + (int64_t)(d0 + j) * n, i0, n);
        xv[j] = x_window(x, i0 + offs.off[d0 + j], ncols, xvec);
      }
    }
    // each row in stored-offset order, one rounding a product and a sum
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (d0 + j < ndiag) {
        acc.x = term(acc.x, dv[j].x, xv[j].x);
        acc.y = term(acc.y, dv[j].y, xv[j].y);
        acc.z = term(acc.z, dv[j].z, xv[j].z);
        acc.w = term(acc.w, dv[j].w, xv[j].w);
      }
    }
  }
  if (VEC) {
    *reinterpret_cast<float4*>(y + i0) = acc;
  } else {
    y[i0] = acc.x;
    if (i0 + 1 < n) y[i0 + 1] = acc.y;
    if (i0 + 2 < n) y[i0 + 2] = acc.z;
    if (i0 + 3 < n) y[i0 + 3] = acc.w;
  }
}

template <int NMAX, class E>
cudaError_t launch_dia_rows(const E* diags, const int* offs_host, const float* x, float* y,
                            int64_t n, int64_t ncols, int ndiag, cudaStream_t s) {
  DiaOffsets<NMAX> o{};
  for (int d = 0; d < ndiag; ++d) o.off[d] = offs_host[d];
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(diags) % (4 * sizeof(E))) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) % 16) == 0;
  const bool xvec = (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  const int64_t threads = (n + kDiaRows - 1) / kDiaRows;
  const unsigned grid = (unsigned)((threads + kDiaThreads - 1) / kDiaThreads);
  if (vec) {
    dia_rows_kernel<true, NMAX, E><<<grid, kDiaThreads, 0, s>>>(diags, o, x, y, n, ncols,
                                                                ndiag, xvec);
  } else {
    dia_rows_kernel<false, NMAX, E><<<grid, kDiaThreads, 0, s>>>(diags, o, x, y, n, ncols,
                                                                 ndiag, xvec);
  }
  return cudaGetLastError();
}

template <class E>
int dia_spmv(const E* diags, const int* offs, const float* x, float* y, int64_t n,
             int64_t ncols, int ndiag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  const int64_t grid = (n + kThreads - 1) / kThreads;
  dia_spmv_kernel<E><<<(unsigned)grid, kThreads, ndiag * sizeof(int), s>>>(
      diags, offs, x, y, n, ncols, ndiag);
  return cudaGetLastError();
}

template <class E>
int dia_spmv_rows(const E* diags, const int* offs_host, const float* x, float* y, int64_t n,
                  int64_t ncols, int ndiag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  if (ndiag < 0 || ndiag > kDiaMaxOffs) return cudaErrorInvalidValue;
  if (ndiag <= 8) return launch_dia_rows<8>(diags, offs_host, x, y, n, ncols, ndiag, s);
  if (ndiag <= 16) return launch_dia_rows<16>(diags, offs_host, x, y, n, ncols, ndiag, s);
  return launch_dia_rows<32>(diags, offs_host, x, y, n, ncols, ndiag, s);
}

template <class E>
__global__ void __launch_bounds__(kThreads)
sym_dia_spmv_kernel(const E* __restrict__ diags, const int* __restrict__ offs,
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
    const E* dk = diags + (int64_t)d * n;
    const float xv = (i + k < n) ? __ldg(x + i + k) : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(ld_ro(dk + i), xv));
    if (k > 0) {
      // the mirror: row i - k's stored value, applied to x[i - k]
      const float t = (i >= k) ? __fmul_rn(ld_ro(dk + i - k), __ldg(x + i - k)) : 0.f;
      acc = __fadd_rn(acc, t);
    }
  }
  y[i] = acc;
}

// The tiled kernel's CTA: kTileCols columns (a warp's width) x kTilePlanes
// planes, kTileWarps warps stacked along the planes, kTileRows planes a thread.
constexpr int kTileCols = 32;
constexpr int kTileWarps = 4;
constexpr int kTileRows = 16;
constexpr int kTilePlanes = kTileWarps * kTileRows;

// Planes [q0, q1) of x or of one diagonal, over the tile's columns, into
// shared memory: entry q * 32 + c holds row (plane0 + q) * g + c0 + c, zero
// outside [0, n).  Asynchronous copies (cp.async) that no register holds:
// 16 bytes each where the rows are 16-byte aligned (``vec``: n and the
// base pointers are), 4 bytes each otherwise.
template <int W>  // floats a copy: 4 (16 bytes) or 1
__device__ __forceinline__ void stage_chunks(float* dst, const float* __restrict__ src, int q0,
                                             int q1, int64_t plane0, int64_t g, int64_t c0,
                                             int64_t n) {
  constexpr int per = kTileCols / W;
  const int total = (q1 - q0) * per;
  for (int f = threadIdx.x; f < total; f += blockDim.x) {
    const int q = q0 + f / per, c = (f % per) * W;
    const int64_t row = (plane0 + q) * g + c0 + c;
    const bool in = row >= 0 && row < n;  // the whole chunk: rows are multiples of W
    __pipeline_memcpy_async(dst + q * kTileCols + c, src + (in ? row : 0), W * sizeof(float),
                            in ? 0 : W * sizeof(float));
  }
}

__device__ __forceinline__ void stage_planes(float* dst, const float* __restrict__ src, int q0,
                                             int q1, int64_t plane0, int64_t g, int64_t c0,
                                             int64_t n, bool vec) {
  if (vec) {
    stage_chunks<4>(dst, src, q0, q1, plane0, g, c0, n);
  } else {
    stage_chunks<1>(dst, src, q0, q1, plane0, g, c0, n);
  }
}

// The same planes of a bfloat16 diagonal, each value widened to float32 as
// it is loaded (exact) and stored to shared memory by the thread: cp.async
// copies bytes and cannot widen.  A thread's kStageBatch loads are issued
// before its first store, so they are in flight together.  Entry q * 32 +
// c is the one stage_chunks fills.
constexpr int kStageBatch = 8;

__device__ __forceinline__ void stage_planes(float* dst, const __nv_bfloat16* __restrict__ src,
                                             int q0, int q1, int64_t plane0, int64_t g,
                                             int64_t c0, int64_t n, bool) {
  const int total = (q1 - q0) * kTileCols;
  float* out = dst + q0 * kTileCols;
  for (int f0 = threadIdx.x; f0 < total; f0 += kStageBatch * blockDim.x) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int f = f0 + u * blockDim.x;
      const int64_t row = (plane0 + q0 + f / kTileCols) * g + c0 + f % kTileCols;
      v[u] = (f < total && row >= 0 && row < n) ? ld_stream(src + row) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int f = f0 + u * blockDim.x;
      if (f < total) out[f] = v[u];
    }
  }
}

// The same planes of a bfloat16 diagonal into a bfloat16 buffer, by
// cp.async of 16 bytes (8 values) each: n % 8 == 0 and the diagonals are
// 16-byte aligned, so a chunk's rows are all in [0, n) or none is.
__device__ __forceinline__ void stage_planes(__nv_bfloat16* dst,
                                             const __nv_bfloat16* __restrict__ src, int q0,
                                             int q1, int64_t plane0, int64_t g, int64_t c0,
                                             int64_t n, bool) {
  constexpr int W = 8, per = kTileCols / W;
  const int total = (q1 - q0) * per;
  for (int f = threadIdx.x; f < total; f += blockDim.x) {
    const int q = q0 + f / per, c = (f % per) * W;
    const int64_t row = (plane0 + q) * g + c0 + c;
    const bool in = row >= 0 && row < n;
    __pipeline_memcpy_async(dst + q * kTileCols + c, src + (in ? row : 0), 16, in ? 0 : 16);
  }
}

// A staged diagonal value as float32 (a bf16 one widened: exact).
__device__ __forceinline__ float staged(const float* p) { return *p; }
__device__ __forceinline__ float staged(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// E: the diagonals' type; S: the diagonal buffers' (float, or bf16 staged
// as it is stored)
template <class E, class S>
__global__ void __launch_bounds__(kTileCols * kTileWarps)
sym_dia_tiled_kernel(const E* __restrict__ diags, const int* __restrict__ offs,
                     const float* __restrict__ x, float* __restrict__ y, int64_t n,
                     int ndiag, int64_t g, int hq, bool vec) {
  constexpr int C = kTileCols, M = kTilePlanes;
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x % C, w = threadIdx.x / C;
  float* xs = sm;  // planes [-hq, M + hq)
  // two diagonal buffers of planes [-hq, M), filled and summed in turn
  S* const dbase = reinterpret_cast<S*>(sm + (M + 2 * hq) * C);
  auto dbuf = [&](int d) { return dbase + (d & 1) * (M + hq) * C; };
  const int64_t ctiles = g / C;
  const int64_t c0 = (blockIdx.x % ctiles) * C;
  const int64_t col = c0 + t;
  const int64_t P0 = (blockIdx.x / ctiles) * M;  // the tile's first plane
  const int64_t plane0 = P0 - hq;
  // an offset's shift in shared memory (k / g planes, k % g columns), and
  // the first plane its diagonal's mirror terms read
  auto shift = [&](int64_t k) -> int { return k >= n ? 0 : (int)((k / g) * C + k % g); };
  auto first = [&](int64_t k) -> int { return hq - (shift(k) + C - 1) / C; };
  stage_planes(xs, x, 0, M + 2 * hq, plane0, g, c0, n, vec);
  if (ndiag > 0) stage_planes(dbuf(0), diags, first(offs[0]), hq + M, plane0, g, c0, n, vec);
  __pipeline_commit();
  float acc[kTileRows];
#pragma unroll
  for (int s = 0; s < kTileRows; ++s) acc[s] = 0.f;
  for (int d = 0; d < ndiag; ++d) {
    // the next diagonal streams in while this one is summed
    if (d + 1 < ndiag) {
      stage_planes(dbuf(d + 1), diags + (int64_t)(d + 1) * n, first(offs[d + 1]), hq + M,
                   plane0, g, c0, n, vec);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const S* ds = dbuf(d);
    const int64_t k = offs[d];
    const bool far = k >= n;  // d * 0 forward, + 0 mirror, on every row
    const int sig = shift(k);
#pragma unroll
    for (int s = 0; s < kTileRows; ++s) {
      const int p = w * kTileRows + s;
      const int u = (hq + p) * C + t;
      const float xv = far ? 0.f : xs[u + sig];
      acc[s] = __fadd_rn(acc[s], __fmul_rn(staged(ds + u), xv));
      if (k > 0) {
        const int64_t row = (P0 + p) * g + col;
        const float tm =
            (!far && row >= k) ? __fmul_rn(staged(ds + u - sig), xs[u - sig]) : 0.f;
        acc[s] = __fadd_rn(acc[s], tm);
      }
    }
    __syncthreads();  // buffer d & 1 is refilled with diagonal d + 2 next
  }
#pragma unroll
  for (int s = 0; s < kTileRows; ++s) {
    const int64_t row = (P0 + w * kTileRows + s) * g + col;
    if (row < n) y[row] = acc[s];
  }
}

template <class E>
int sym_dia_spmv(const E* diags, const int* offs, const float* x, float* y, int64_t n,
                 int ndiag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  const int64_t grid = (n + kThreads - 1) / kThreads;
  sym_dia_spmv_kernel<E><<<(unsigned)grid, kThreads, ndiag * sizeof(int), s>>>(
      diags, offs, x, y, n, ndiag);
  return cudaGetLastError();
}

// The tiled kernel with diagonal buffers of S: x over the tile and both
// halos; two diagonal buffers over the tile and the halo before it.  x (and
// a float32 diagonal) is copied 16 bytes at a time where ``vec``.
template <class E, class S>
cudaError_t launch_tiled(const E* diags, const int* offs, const float* x, float* y, int64_t n,
                         int ndiag, int64_t pitch, int hq, bool vec, cudaStream_t s) {
  static bool attr_set = false;  // above 48 KB of shared memory needs the opt-in, once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sym_dia_tiled_kernel<E, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int64_t planes = (n + pitch - 1) / pitch;
  const int64_t grid = (pitch / kTileCols) * ((planes + kTilePlanes - 1) / kTilePlanes);
  const size_t smem = (size_t)(kTilePlanes + 2 * hq) * kTileCols * sizeof(float) +
                      (size_t)2 * (kTilePlanes + hq) * kTileCols * sizeof(S);
  sym_dia_tiled_kernel<E, S><<<(unsigned)grid, kTileCols * kTileWarps, smem, s>>>(
      diags, offs, x, y, n, ndiag, pitch, hq, vec);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

template <class E>
int sym_dia_spmv_tiled(const E* diags, const int* offs, const float* x, float* y, int64_t n,
                       int ndiag, int64_t pitch, int hq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  if (pitch <= 0 || pitch % kTileCols || hq < 0) return cudaErrorInvalidValue;
  if constexpr (std::is_same<E, float>::value) {
    const bool vec = n % 4 == 0 && aligned16(diags) && aligned16(x);
    return launch_tiled<float, float>(diags, offs, x, y, n, ndiag, pitch, hq, vec, s);
  } else {
    const bool vec = n % 4 == 0 && aligned16(x);
    if (n % 8 == 0 && aligned16(diags)) {
      return launch_tiled<E, E>(diags, offs, x, y, n, ndiag, pitch, hq, vec, s);
    }
    return launch_tiled<E, float>(diags, offs, x, y, n, ndiag, pitch, hq, vec, s);
  }
}

}  // namespace

extern "C" {

// y = DIA x.  offs: ndiag int32 offsets on the device.  Returns a cudaError_t.
int cg_dia_spmv(const float* diags, const int* offs, const float* x, float* y,
                int64_t n, int64_t ncols, int ndiag, void* stream) {
  return dia_spmv(diags, offs, x, y, n, ncols, ndiag, stream);
}

// The same on bfloat16 diagonals.
int cg_dia_spmv_bf16(const __nv_bfloat16* diags, const int* offs, const float* x, float* y,
                     int64_t n, int64_t ncols, int ndiag, void* stream) {
  return dia_spmv(diags, offs, x, y, n, ncols, ndiag, stream);
}

// y = DIA x by dia_rows_kernel.  offs_host: ndiag int32 offsets in host
// memory (at most kDiaMaxOffs), copied into the launch's parameters; the
// kernel is compiled for 8, 16 and 32 of them.  Returns a cudaError_t.
int cg_dia_spmv_rows(const float* diags, const int* offs_host, const float* x, float* y,
                     int64_t n, int64_t ncols, int ndiag, void* stream) {
  return dia_spmv_rows(diags, offs_host, x, y, n, ncols, ndiag, stream);
}

// The same on bfloat16 diagonals.
int cg_dia_spmv_rows_bf16(const __nv_bfloat16* diags, const int* offs_host, const float* x,
                          float* y, int64_t n, int64_t ncols, int ndiag, void* stream) {
  return dia_spmv_rows(diags, offs_host, x, y, n, ncols, ndiag, stream);
}

// y = SymDIA x over the stored offsets >= 0.  Returns a cudaError_t.
int cg_sym_dia_spmv(const float* diags, const int* offs, const float* x, float* y,
                    int64_t n, int ndiag, void* stream) {
  return sym_dia_spmv(diags, offs, x, y, n, ndiag, stream);
}

// The same on bfloat16 diagonals.
int cg_sym_dia_spmv_bf16(const __nv_bfloat16* diags, const int* offs, const float* x, float* y,
                         int64_t n, int ndiag, void* stream) {
  return sym_dia_spmv(diags, offs, x, y, n, ndiag, stream);
}

// y = SymDIA x over the stored offsets >= 0 by the tiled kernel: pitch g (a
// multiple of 32), hq halo planes, as ops/cuda/dia_spmv.sym_dia_tiling chose
// them.  Returns a cudaError_t.
int cg_sym_dia_spmv_tiled(const float* diags, const int* offs, const float* x, float* y,
                          int64_t n, int ndiag, int64_t pitch, int hq, void* stream) {
  return sym_dia_spmv_tiled(diags, offs, x, y, n, ndiag, pitch, hq, stream);
}

// The same on bfloat16 diagonals.
int cg_sym_dia_spmv_tiled_bf16(const __nv_bfloat16* diags, const int* offs, const float* x,
                               float* y, int64_t n, int ndiag, int64_t pitch, int hq,
                               void* stream) {
  return sym_dia_spmv_tiled(diags, offs, x, y, n, ndiag, pitch, hq, stream);
}

}  // extern "C"
