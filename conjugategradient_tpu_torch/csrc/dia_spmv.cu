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
// dia_spmv and dia_spmv_rows also take bfloat16 diagonals (the TPU kernels'
// other operand form, dia_spmv.py:61-67,107-124, float32 x, float32 y: the
// promoted dtype): each value is widened to float32 (exact: its bits
// shifted up 16), and every product and sum is the float32 kernel's in its
// order, so a bf16 launch gives the bits of the float32 launch on
// diags.float().  dia_spmv takes the type as a template parameter.
// dia_spmv_rows on bf16 (dia_rows_bf16_kernel) keeps the float32 one's
// geometry but not its loads: the first bf16 form widened each 8-byte load
// right after it, so every conversion waited on its load before the
// thread's next diagonal load was issued, and it ran slower than the
// float32 launch it widens to (0.0027-0.0031 ms against 0.0022 on
// poisson3d_48, H100).  Here the loads keep their raw bits (Win below) and
// are widened once all of a chunk's loads are in flight: 0.0020 ms, under
// the float32 launch's.  (Eight rows a thread, one 16-byte load a diagonal
// in 64-thread CTAs, measured 10% slower than four on the H100.)  The
// diagonal stream, and with it the bound, halves (41 x
// 2,097,152 x 2 B + x and y on symdia-big: 0.0564 ms).  Entry points
// cg_dia_spmv_bf16 and cg_dia_spmv_rows_bf16, counted apart.
//
// sym_dia_spmv_rows is kernel 10's counterpart of dia_spmv_rows, for
// operators of at most 32 stored offsets where the tiled kernel below does
// not pay (poisson3d_48: 4 stored).  sym_dia_spmv_kernel (one thread a row,
// the offsets staged in shared memory behind a barrier, a runtime loop
// unrolled by 2 with four dependent loads a term) stays for wider bands
// (dense_256's 256 stored).  Here the offsets are a kernel parameter
// indexed at compile time (8, 16 and 32 of them), a thread owns 4
// consecutive rows, and the four windows of every offset of a chunk
// (d_k[i..], x[i+k..], d_k[i-k..], x[i-k..]) are loaded before its first
// product, as raw bits.  The forward diagonal
// window is aligned; the mirror and x windows are aligned only where k is
// a multiple of the vector (4 entries), and are read one entry at a time
// elsewhere.
//
// sym_dia_spmv_tiled is the redesign of sym_dia_spmv for large operators
// (same function, same bits).  One thread per row reads 82 words a row on
// an operator with 21 stored offsets k * 1024 (d_k[i], d_k[i-k], x[i+k],
// x[i-k]): ~690 MB a call on symdia-big for the ~193 MB that HBM must
// supply, and offsets 1024 rows apart give no reuse inside a CTA, so every
// word crosses L2 -> SM.  The tiled kernel stages what a CTA's rows share:
//   tile   32 columns (a warp's width) x M planes (64 or 128) spaced by the
//          pitch g, 4 warps stacked along the planes, M / 4 rows a thread
//          with their accumulators in registers: a lane owns two adjacent
//          columns of one plane of each pair, so a warp reads two planes at
//          a time and every staged value is read in pairs (a 4-byte
//          __nv_bfloat162, or a float2), where the offset's shift is even.
//          Every offset below n is a whole number of planes plus columns,
//          k = (k / g) g + k % g, so its shift in shared memory is (k / g) *
//          32 + k % g; g is the offsets' gcd where that is a multiple of 32
//          (symdia-big: 1024, the shift of k = j * 1024 is j planes in the
//          same column), else 32 (contiguous rows, the shift k entries).
//          Each CTA computes every offset's shift once, in 32 bits, into
//          shared memory: the first design divided the 64-bit k by g twice
//          a diagonal in every thread, and spent as many instructions on
//          that as on its rows' terms.
//   x      staged once, with hq halo planes on each side, zero outside
//          [0, n).
//   d_k    staged one diagonal at a time over the tile and the planes
//          before it that its mirror terms read: the forward term of row i
//          reads d_k[i], the mirror d_k[i - k], both from shared memory, so
//          a diagonal value crosses L2 -> SM once, plus (k / g) / M of halo,
//          and x (M + 2 hq) / M times.  A tile whose first row is at least
//          k takes every mirror term without a test of its row.
//   ring   cp.async (16 bytes where aligned) into S stages of diagonal
//          buffers (S a launch argument, 2-8): S - 1 diagonals are in
//          flight while one is summed, and one __syncthreads a diagonal
//          both publishes the CTA's copies of the diagonal to be summed and
//          frees the stage of the one summed before, which the next copy
//          refills.  The design it replaces kept two buffers and two
//          barriers a diagonal.  The tile height and the ring depth of each
//          type's launch are the host's (ops/cuda/dia_spmv.TILE_GEOMETRY),
//          from the sweep chip_smoke.py --dia-only prints.
// Each row still sums in stored-offset order, the forward term then for
// k > 0 the mirror, one __fmul_rn and one __fadd_rn each, with the plain
// version's zeros (d * 0 past the end; + 0 for i < k; an offset >= n gives
// d * 0 and + 0 on every row): the mapping of threads to rows, not the
// staging, fixes the order, so it is bit-equal to sym_dia_spmv and to
// ops/spmv.sym_dia_apply.  The host (ops/cuda/dia_spmv.sym_dia_tiling)
// picks g and hq and takes this kernel where it pays: a halo of at most
// the tile's planes and a grid of at least one CTA per SM, both at the
// tile height the diagonals' type launches (sym_dia_route); the by-value
// and one-thread-a-row kernels take the rest.
//
// The symmetric kernels take bfloat16 diagonals the same way
// (sym_dia_spmv_pallas_blocked's bf16 form, dia_spmv.py:283,286): the
// by-value and one-thread-a-row kernels widen each value they load; the
// tiled one stages a diagonal's bf16 values by cp.async, 16 bytes (8
// values) a copy, into bf16 stages (half the float32 ones) and widens each
// pair as it reads it from shared memory, where n % 8 == 0 and the
// diagonals are 16-byte aligned (symdia-big); elsewhere it widens while it
// stages, by plain loads and shared stores into float32 stages (cp.async
// copies bytes and cannot widen).  Every sum is the float32 kernel's, so
// a bf16 launch gives the bits of the float32 launch on diags.float().  The diagonal stream halves (21 x 2,097,152 x 2 B + x
// and y on symdia-big: 0.0313 ms).  Entry points cg_sym_dia_spmv_bf16,
// cg_sym_dia_spmv_rows_bf16 and cg_sym_dia_spmv_tiled_bf16.

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

// Rows i0 .. i0 + 3 of one float32 diagonal (i0 < n): one streaming float4
// where n % 4 == 0 and the diagonals are aligned to it (VEC), else four
// loads, 0 past n (those rows are not stored).
template <bool VEC>
__device__ __forceinline__ float4 diag_rows(const float* __restrict__ dg, int64_t i0, int64_t n) {
  if (VEC) return __ldcs(reinterpret_cast<const float4*>(dg + i0));
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

template <bool VEC, int NMAX>
__global__ void __launch_bounds__(kDiaThreads)
dia_rows_kernel(const float* __restrict__ diags, const DiaOffsets<NMAX> offs,
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

// ---- windows of R consecutive entries, loaded with no wait on a value ------

// Win<E, R>: entries c0 .. c0 + R - 1 of a row p[0, len), 0 outside it
// (never a clamped index), loaded so that no instruction of the loading
// thread needs a loaded value: vector loads straight into the registers
// where the window starts on a vector and lies inside the row (``vec``:
// the row is aligned to the vector), else one predicated load an entry.
// A bf16 window keeps its raw bits and widens them (exact) in widen(),
// which the products call once every load of their chunk is in flight: a
// conversion right after its load would hold the thread's next loads back
// (the first bf16 form of dia_spmv_rows did that, and ran slower than the
// float32 launch).  CS: the streaming path (__ldcs), else read-only (__ldg).
template <class E, int R>
struct Win;

template <int R>
struct Win<float, R> {
  static_assert(R % 4 == 0, "float4 vectors");
  float f[R];
  // the vector path alone: c0 on a vector, the window inside the row
  template <bool CS>
  __device__ __forceinline__ void load_whole(const float* __restrict__ p, int64_t c0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4* v = reinterpret_cast<const float4*>(p + c0 + 4 * q);
      float4 u;
      if constexpr (CS) {
        u = __ldcs(v);
      } else {
        u = __ldg(v);
      }
      f[4 * q] = u.x;
      f[4 * q + 1] = u.y;
      f[4 * q + 2] = u.z;
      f[4 * q + 3] = u.w;
    }
  }
  template <bool CS>
  __device__ __forceinline__ void load(const float* __restrict__ p, int64_t c0, int64_t len,
                                       bool vec) {
    if (vec && (c0 & 3) == 0 && c0 >= 0 && c0 + R <= len) {
      load_whole<CS>(p, c0);
      return;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t c = c0 + j;
      f[j] = 0.f;
      if (c >= 0 && c < len) {
        if constexpr (CS) {
          f[j] = __ldcs(p + c);
        } else {
          f[j] = __ldg(p + c);
        }
      }
    }
  }
  __device__ __forceinline__ void widen(float (&v)[R]) const {
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = f[j];
  }
  __device__ __forceinline__ void widen_whole(float (&v)[R]) const { widen(v); }
};

template <int R>
struct Win<__nv_bfloat16, R> {
  static_assert(R == 4, "one 8-byte vector");
  unsigned w[R / 2];   // the vector: entry 2 q in the low half of w[q]
  unsigned short h[R];  // one load an entry
  bool vec;
  // the vector path alone: c0 on a vector, the window inside the row
  template <bool CS>
  __device__ __forceinline__ void load_whole(const __nv_bfloat16* __restrict__ p, int64_t c0) {
    const uint2* v = reinterpret_cast<const uint2*>(p + c0);
    uint2 u;
    if constexpr (CS) {
      u = __ldcs(v);
    } else {
      u = __ldg(v);
    }
    w[0] = u.x;
    w[1] = u.y;
  }
  template <bool CS>
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p, int64_t c0,
                                       int64_t len, bool aligned) {
    vec = aligned && (c0 & (R - 1)) == 0 && c0 >= 0 && c0 + R <= len;
    if (vec) {
      load_whole<CS>(p, c0);
      return;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t c = c0 + j;
      h[j] = 0;
      if (c >= 0 && c < len) {
        if constexpr (CS) {
          h[j] = __bfloat16_as_ushort(__ldcs(p + c));
        } else {
          h[j] = __bfloat16_as_ushort(__ldg(p + c));
        }
      }
    }
  }
  __device__ __forceinline__ void widen_whole(float (&v)[R]) const {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ void widen(float (&v)[R]) const {
    if (vec) {
      widen_whole(v);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = __uint_as_float((unsigned)h[j] << 16);
    }
  }
};

// R float32 values to y[i0 ..]: float4 stores where VEC (i0 + R <= n and y
// 16-byte aligned), else one store a row below n.
template <bool VEC, int R>
__device__ __forceinline__ void store_rows(float* __restrict__ y, int64_t i0, int64_t n,
                                           const float (&acc)[R]) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      *reinterpret_cast<float4*>(y + i0 + 4 * q) =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (i0 + j < n) y[i0 + j] = acc[j];
    }
  }
}

// dia_spmv_rows on bfloat16 diagonals: the float32 kernel's geometry
// (kDiaRows rows a thread, one 8-byte load of a diagonal, kDiaThreads
// threads a CTA), a chunk of kDiaChunk8 diagonals' loads in flight before
// its first product.
constexpr int kDiaChunk8 = 8;

template <bool VEC, int NMAX>
__global__ void __launch_bounds__(kDiaThreads)
dia_rows_bf16_kernel(const __nv_bfloat16* __restrict__ diags, const DiaOffsets<NMAX> offs,
                     const float* __restrict__ x, float* __restrict__ y, int64_t n,
                     int64_t ncols, int ndiag, bool dvec, bool xvec) {
  constexpr int R = kDiaRows, C = NMAX < kDiaChunk8 ? NMAX : kDiaChunk8;
  const int64_t i0 = R * ((int64_t)blockIdx.x * kDiaThreads + threadIdx.x);
  if (i0 >= n) return;
  float acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < NMAX; d0 += C) {
    if (d0 >= ndiag) break;
    Win<__nv_bfloat16, R> dw[C];
    Win<float, R> xw[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (d0 + j < ndiag) {
        if (VEC) {  // n % R == 0 and aligned diagonals: every window whole
          dw[j].template load_whole<true>(diags + (int64_t)(d0 + j) * n, i0);
        } else {
          dw[j].template load<true>(diags + (int64_t)(d0 + j) * n, i0, n, dvec);
        }
        xw[j].template load<false>(x, i0 + offs.off[d0 + j], ncols, xvec);
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (d0 + j < ndiag) {
        float dv[R];
        if (VEC) {
          dw[j].widen_whole(dv);
        } else {
          dw[j].widen(dv);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = term(acc[r], dv[r], xw[j].f[r]);
      }
    }
  }
  store_rows<VEC>(y, i0, n, acc);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

template <int NMAX>
DiaOffsets<NMAX> param_offsets(const int* offs_host, int ndiag) {
  DiaOffsets<NMAX> o{};
  for (int d = 0; d < ndiag; ++d) o.off[d] = offs_host[d];
  return o;
}

template <int NMAX>
cudaError_t launch_dia_rows(const float* diags, const int* offs_host, const float* x, float* y,
                            int64_t n, int64_t ncols, int ndiag, cudaStream_t s) {
  const DiaOffsets<NMAX> o = param_offsets<NMAX>(offs_host, ndiag);
  const bool vec = n % 4 == 0 && aligned16(diags) && aligned16(y);
  const bool xvec = aligned16(x);
  const int64_t threads = (n + kDiaRows - 1) / kDiaRows;
  const unsigned grid = (unsigned)((threads + kDiaThreads - 1) / kDiaThreads);
  if (vec) {
    dia_rows_kernel<true, NMAX><<<grid, kDiaThreads, 0, s>>>(diags, o, x, y, n, ncols, ndiag,
                                                             xvec);
  } else {
    dia_rows_kernel<false, NMAX><<<grid, kDiaThreads, 0, s>>>(diags, o, x, y, n, ncols, ndiag,
                                                              xvec);
  }
  return cudaGetLastError();
}

template <int NMAX>
cudaError_t launch_dia_rows(const __nv_bfloat16* diags, const int* offs_host, const float* x,
                            float* y, int64_t n, int64_t ncols, int ndiag, cudaStream_t s) {
  const DiaOffsets<NMAX> o = param_offsets<NMAX>(offs_host, ndiag);
  const bool dvec = n % kDiaRows == 0 && aligned16(diags);
  const bool vec = dvec && aligned16(y);
  const bool xvec = aligned16(x);
  const int64_t threads = (n + kDiaRows - 1) / kDiaRows;
  const unsigned grid = (unsigned)((threads + kDiaThreads - 1) / kDiaThreads);
  if (vec) {
    dia_rows_bf16_kernel<true, NMAX><<<grid, kDiaThreads, 0, s>>>(diags, o, x, y, n, ncols,
                                                                  ndiag, dvec, xvec);
  } else {
    dia_rows_bf16_kernel<false, NMAX><<<grid, kDiaThreads, 0, s>>>(diags, o, x, y, n, ncols,
                                                                   ndiag, dvec, xvec);
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

// sym_dia_spmv_rows: the stored offsets by value, kDiaRows consecutive rows
// a thread (one vector of a diagonal), kDiaThreads threads a CTA, the four
// windows of kSymChunk offsets' terms loaded before the chunk's first
// product.
constexpr int kSymChunk = 8;

template <bool VEC, int NMAX, class E>
__global__ void __launch_bounds__(kDiaThreads)
sym_dia_rows_kernel(const E* __restrict__ diags, const DiaOffsets<NMAX> offs,
                    const float* __restrict__ x, float* __restrict__ y, int64_t n, int ndiag,
                    bool dvec, bool xvec) {
  constexpr int R = kDiaRows, C = NMAX < kSymChunk ? NMAX : kSymChunk;
  const int64_t i0 = R * ((int64_t)blockIdx.x * kDiaThreads + threadIdx.x);
  if (i0 >= n) return;
  float acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < NMAX; d0 += C) {
    if (d0 >= ndiag) break;
    // d_k[i0..], x[i0+k..] and, for k > 0, d_k[i0-k..] and x[i0-k..]: an
    // offset >= n reads x past the end (zeros, no load) and no mirror row
    Win<E, R> df[C], dm[C];
    Win<float, R> xf[C], xm[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (d0 + j < ndiag) {
        const int64_t k = offs.off[d0 + j];
        const E* dk = diags + (int64_t)(d0 + j) * n;
        if (VEC) {  // n % R == 0 and aligned diagonals: the forward window whole
          df[j].template load_whole<false>(dk, i0);
        } else {
          df[j].template load<false>(dk, i0, n, dvec);
        }
        xf[j].template load<false>(x, i0 + k, n, xvec);
        if (k > 0) {
          dm[j].template load<false>(dk, i0 - k, n, dvec);
          xm[j].template load<false>(x, i0 - k, n, xvec);
        }
      }
    }
    // each row in stored-offset order: the forward term, then for k > 0
    // the mirror (+ 0 on rows i < k)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (d0 + j < ndiag) {
        const int64_t k = offs.off[d0 + j];
        float dv[R];
        if (VEC) {
          df[j].widen_whole(dv);
        } else {
          df[j].widen(dv);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = term(acc[r], dv[r], xf[j].f[r]);
        if (k > 0) {
          dm[j].widen(dv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r] = __fadd_rn(acc[r], i0 + r >= k ? __fmul_rn(dv[r], xm[j].f[r]) : 0.f);
          }
        }
      }
    }
  }
  store_rows<VEC>(y, i0, n, acc);
}

template <int NMAX, class E>
cudaError_t launch_sym_rows(const E* diags, const int* offs_host, const float* x, float* y,
                            int64_t n, int ndiag, cudaStream_t s) {
  const DiaOffsets<NMAX> o = param_offsets<NMAX>(offs_host, ndiag);
  const bool dvec = n % kDiaRows == 0 && aligned16(diags);
  const bool vec = dvec && aligned16(y);
  const bool xvec = aligned16(x);
  const int64_t threads = (n + kDiaRows - 1) / kDiaRows;
  const unsigned grid = (unsigned)((threads + kDiaThreads - 1) / kDiaThreads);
  if (vec) {
    sym_dia_rows_kernel<true, NMAX, E><<<grid, kDiaThreads, 0, s>>>(diags, o, x, y, n, ndiag,
                                                                    dvec, xvec);
  } else {
    sym_dia_rows_kernel<false, NMAX, E><<<grid, kDiaThreads, 0, s>>>(diags, o, x, y, n, ndiag,
                                                                     dvec, xvec);
  }
  return cudaGetLastError();
}

// The tiled kernel's CTA: kTileCols columns (a warp's width) x M planes,
// kTileWarps warps stacked along the planes, M / kTileWarps planes a warp.
constexpr int kTileCols = 32;
constexpr int kTileWarps = 4;
constexpr int kTileThreads = kTileCols * kTileWarps;
constexpr int kTileMaxStages = 8;
constexpr int kTileMaxSmem = 232448;  // an H100 CTA's dynamic shared memory

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

// A staged value, and a staged pair at an even entry, as float32 (bf16
// widened: exact).
__device__ __forceinline__ float staged(const float* p) { return *p; }
__device__ __forceinline__ float staged(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float2 staged2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 staged2(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Wait until at most `pending` of this thread's newest commit groups are
// still in flight (cp.async.wait_group takes an immediate).
__device__ __forceinline__ void wait_groups(int pending) {
  switch (pending) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    case 3: __pipeline_wait_prior(3); break;
    case 4: __pipeline_wait_prior(4); break;
    case 5: __pipeline_wait_prior(5); break;
    default: __pipeline_wait_prior(6); break;
  }
}

// One diagonal's terms on a thread's rows.  xu and du: the thread's first
// entry of x and of the diagonal's stage (its step s reads 2 s C further
// on); sig: the offset's shift.  P: sig is even and every staged value is
// read in pairs, else one at a time; MIR: k > 0 (the mirror term); MASK:
// some row of the tile lies below k, so each mirror term tests its row
// (row0: the thread's first row; step s adds 2 s g).
template <bool P, bool MIR, bool MASK, int M, class S>
__device__ __forceinline__ void tile_terms(float (&acc)[M / kTileWarps], const float* xu,
                                           const S* du, int sig, int64_t row0, int64_t g,
                                           int64_t k) {
  constexpr int C = kTileCols, RP = M / kTileWarps;
  const float* xp = xu + sig;
  const float* xm = xu - sig;
  const S* dm = du - sig;
#pragma unroll
  for (int s = 0; s < RP / 2; ++s) {
    const int o = 2 * s * C;
    float2 dv, xv;
    if (P) {
      dv = staged2(du + o);
      xv = *reinterpret_cast<const float2*>(xp + o);
    } else {
      dv = make_float2(staged(du + o), staged(du + o + 1));
      xv = make_float2(xp[o], xp[o + 1]);
    }
    acc[2 * s] = term(acc[2 * s], dv.x, xv.x);
    acc[2 * s + 1] = term(acc[2 * s + 1], dv.y, xv.y);
    if (MIR) {
      float2 dmv, xmv;
      if (P) {
        dmv = staged2(dm + o);
        xmv = *reinterpret_cast<const float2*>(xm + o);
      } else {
        dmv = make_float2(staged(dm + o), staged(dm + o + 1));
        xmv = make_float2(xm[o], xm[o + 1]);
      }
      float t0 = __fmul_rn(dmv.x, xmv.x), t1 = __fmul_rn(dmv.y, xmv.y);
      if (MASK) {
        const int64_t row = row0 + 2 * s * g;
        t0 = row >= k ? t0 : 0.f;
        t1 = row + 1 >= k ? t1 : 0.f;
      }
      acc[2 * s] = __fadd_rn(acc[2 * s], t0);
      acc[2 * s + 1] = __fadd_rn(acc[2 * s + 1], t1);
    }
  }
}

// An offset >= n: d * 0 forward and + 0 mirror on every row.
template <int M, class S>
__device__ __forceinline__ void tile_far(float (&acc)[M / kTileWarps], const S* du) {
  constexpr int C = kTileCols, RP = M / kTileWarps;
#pragma unroll
  for (int s = 0; s < RP / 2; ++s) {
    const float2 dv = staged2(du + 2 * s * C);
    acc[2 * s] = __fadd_rn(term(acc[2 * s], dv.x, 0.f), 0.f);
    acc[2 * s + 1] = __fadd_rn(term(acc[2 * s + 1], dv.y, 0.f), 0.f);
  }
}

// E: the diagonals' type; S: the stages' (float, or bf16 staged as it is
// stored); M: planes a tile.  Lane l of warp w owns columns cc, cc + 1 (cc
// = 2 (l % 16)) of the planes w M / 4 + 2 s + l / 16: its accumulators
// acc[2 s], acc[2 s + 1].  Shared memory: x over planes [-hq, M + hq),
// `stages` diagonal stages of planes [-hq, M), then each offset and its
// shift, computed once a CTA (32-bit: offsets and the pitch are int32).
template <class E, class S, int M>
__global__ void __launch_bounds__(kTileThreads)
sym_dia_tiled_kernel(const E* __restrict__ diags, const int* __restrict__ offs,
                     const float* __restrict__ x, float* __restrict__ y, int64_t n,
                     int ndiag, int64_t g, int hq, int stages, bool vec) {
  constexpr int C = kTileCols, RP = M / kTileWarps;
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int cc = 2 * (lane % 16), p0 = w * RP + lane / 16;  // the thread's first plane
  float* xs = sm;
  S* const dbase = reinterpret_cast<S*>(sm + (M + 2 * hq) * C);
  const int span = (M + hq) * C;
  int* const s_off = reinterpret_cast<int*>(dbase + stages * span);
  int* const s_sig = s_off + ndiag;
  const int64_t ctiles = g / C;
  const int64_t c0 = (blockIdx.x % ctiles) * C;
  const int64_t P0 = (blockIdx.x / ctiles) * M;  // the tile's first plane
  const int64_t plane0 = P0 - hq;
  // each offset and its shift in shared memory (k / g planes, k % g columns;
  // 0 for an offset >= n, which moves nothing)
  const int g32 = (int)g;
  for (int d = threadIdx.x; d < ndiag; d += blockDim.x) {
    const int k = __ldg(offs + d);
    s_off[d] = k;
    s_sig[d] = k >= n ? 0 : (k / g32) * C + k % g32;
  }
  __syncthreads();
  // diagonal d into its stage, from the first plane its mirror terms read,
  // as one commit group (an empty one past the last)
  auto fill = [&](int d) {
    if (d < ndiag) {
      stage_planes(dbase + (d % stages) * span, diags + (int64_t)d * n,
                   hq - (s_sig[d] + C - 1) / C, hq + M, plane0, g, c0, n, vec);
    }
    __pipeline_commit();
  };
  stage_planes(xs, x, 0, M + 2 * hq, plane0, g, c0, n, vec);  // with diagonal 0's group
  for (int d = 0; d + 1 < stages; ++d) fill(d);
  float acc[RP];
#pragma unroll
  for (int s = 0; s < RP; ++s) acc[s] = 0.f;
  const int u0 = (hq + p0) * C + cc;
  const float* xu = xs + u0;
  const int64_t row0 = (P0 + p0) * g + c0 + cc;
  const int64_t first_row = P0 * g + c0;  // the tile's first row
  for (int d = 0; d < ndiag; ++d) {
    wait_groups(stages - 2);  // this thread's copies of diagonal d have landed
    __syncthreads();          // everyone's have, and diagonal d - 1's stage is free
    fill(d + stages - 1);
    const S* du = dbase + (d % stages) * span + u0;
    const int64_t k = s_off[d];
    const int sig = s_sig[d];
    if (k >= n) {
      tile_far<M>(acc, du);
    } else if (k == 0) {
      tile_terms<true, false, false, M>(acc, xu, du, 0, row0, g, k);
    } else if (first_row < k) {
      if (sig & 1) {
        tile_terms<false, true, true, M>(acc, xu, du, sig, row0, g, k);
      } else {
        tile_terms<true, true, true, M>(acc, xu, du, sig, row0, g, k);
      }
    } else if (sig & 1) {
      tile_terms<false, true, false, M>(acc, xu, du, sig, row0, g, k);
    } else {
      tile_terms<true, true, false, M>(acc, xu, du, sig, row0, g, k);
    }
  }
  __pipeline_wait_prior(0);  // no copy left in flight into a CTA that ends
#pragma unroll
  for (int s = 0; s < RP / 2; ++s) {
    const int64_t row = row0 + 2 * s * g;
    if (row + 1 < n) {
      *reinterpret_cast<float2*>(y + row) = make_float2(acc[2 * s], acc[2 * s + 1]);
    } else if (row < n) {
      y[row] = acc[2 * s];
    }
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

template <class E>
int sym_dia_spmv_rows(const E* diags, const int* offs_host, const float* x, float* y, int64_t n,
                      int ndiag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  if (ndiag < 0 || ndiag > kDiaMaxOffs) return cudaErrorInvalidValue;
  if (ndiag <= 8) return launch_sym_rows<8, E>(diags, offs_host, x, y, n, ndiag, s);
  if (ndiag <= 16) return launch_sym_rows<16, E>(diags, offs_host, x, y, n, ndiag, s);
  return launch_sym_rows<32, E>(diags, offs_host, x, y, n, ndiag, s);
}

// The tiled kernel with stages of S: x over the tile and both halos, then
// `stages` diagonal stages over the tile and the halo before it.  x (and a
// float32 diagonal) is copied 16 bytes at a time where ``vec``.
template <class E, class S, int M>
cudaError_t launch_tiled(const E* diags, const int* offs, const float* x, float* y, int64_t n,
                         int ndiag, int64_t pitch, int hq, int stages, bool vec,
                         cudaStream_t s) {
  static bool attr_set = false;  // above 48 KB of shared memory needs the opt-in, once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sym_dia_tiled_kernel<E, S, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const size_t smem = (size_t)(M + 2 * hq) * kTileCols * sizeof(float) +
                      (size_t)stages * (M + hq) * kTileCols * sizeof(S) +
                      (size_t)2 * ndiag * sizeof(int);
  if (smem > (size_t)kTileMaxSmem) return cudaErrorInvalidValue;
  const int64_t planes = (n + pitch - 1) / pitch;
  const int64_t grid = (pitch / kTileCols) * ((planes + M - 1) / M);
  sym_dia_tiled_kernel<E, S, M><<<(unsigned)grid, kTileThreads, smem, s>>>(
      diags, offs, x, y, n, ndiag, pitch, hq, stages, vec);
  return cudaGetLastError();
}

template <class E, class S>
cudaError_t launch_tiled_planes(const E* diags, const int* offs, const float* x, float* y,
                                int64_t n, int ndiag, int64_t pitch, int hq, int planes,
                                int stages, bool vec, cudaStream_t s) {
  if (planes == 64) {
    return launch_tiled<E, S, 64>(diags, offs, x, y, n, ndiag, pitch, hq, stages, vec, s);
  }
  if (planes == 128) {
    return launch_tiled<E, S, 128>(diags, offs, x, y, n, ndiag, pitch, hq, stages, vec, s);
  }
  return cudaErrorInvalidValue;
}

template <class E>
int sym_dia_spmv_tiled(const E* diags, const int* offs, const float* x, float* y, int64_t n,
                       int ndiag, int64_t pitch, int hq, int planes, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  if (pitch <= 0 || pitch % kTileCols || pitch > INT32_MAX || hq < 0 || stages < 2 ||
      stages > kTileMaxStages) {
    return cudaErrorInvalidValue;
  }
  if constexpr (std::is_same<E, float>::value) {
    const bool vec = n % 4 == 0 && aligned16(diags) && aligned16(x);
    return launch_tiled_planes<float, float>(diags, offs, x, y, n, ndiag, pitch, hq, planes,
                                             stages, vec, s);
  } else {
    const bool vec = n % 4 == 0 && aligned16(x);
    if (n % 8 == 0 && aligned16(diags)) {
      return launch_tiled_planes<E, E>(diags, offs, x, y, n, ndiag, pitch, hq, planes, stages,
                                       vec, s);
    }
    return launch_tiled_planes<E, float>(diags, offs, x, y, n, ndiag, pitch, hq, planes, stages,
                                         vec, s);
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

// The same on bfloat16 diagonals, by dia_rows_bf16_kernel.
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

// y = SymDIA x by sym_dia_rows_kernel.  offs_host: the ndiag stored offsets
// (at most kDiaMaxOffs) in host memory, copied into the launch's
// parameters.  Returns a cudaError_t.
int cg_sym_dia_spmv_rows(const float* diags, const int* offs_host, const float* x, float* y,
                         int64_t n, int ndiag, void* stream) {
  return sym_dia_spmv_rows(diags, offs_host, x, y, n, ndiag, stream);
}

// The same on bfloat16 diagonals.
int cg_sym_dia_spmv_rows_bf16(const __nv_bfloat16* diags, const int* offs_host, const float* x,
                              float* y, int64_t n, int ndiag, void* stream) {
  return sym_dia_spmv_rows(diags, offs_host, x, y, n, ndiag, stream);
}

// y = SymDIA x over the stored offsets >= 0 by the tiled kernel: pitch g (a
// multiple of 32), hq halo planes, tiles of `planes` planes (64 or 128) and
// `stages` diagonal stages (2-8), as ops/cuda/dia_spmv.sym_dia_tiling chose
// them.  Returns a cudaError_t.
int cg_sym_dia_spmv_tiled(const float* diags, const int* offs, const float* x, float* y,
                          int64_t n, int ndiag, int64_t pitch, int hq, int planes, int stages,
                          void* stream) {
  return sym_dia_spmv_tiled(diags, offs, x, y, n, ndiag, pitch, hq, planes, stages, stream);
}

// The same on bfloat16 diagonals.
int cg_sym_dia_spmv_tiled_bf16(const __nv_bfloat16* diags, const int* offs, const float* x,
                               float* y, int64_t n, int ndiag, int64_t pitch, int hq, int planes,
                               int stages, void* stream) {
  return sym_dia_spmv_tiled(diags, offs, x, y, n, ndiag, pitch, hq, planes, stages, stream);
}

}  // extern "C"
