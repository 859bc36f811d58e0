// Fused CG-iteration kernels for Hopper (sm_90a), bound through ctypes.
//
// Counterpart of conjugategradient_tpu/ops/pallas/fused_cg.py.  One CG
// iteration is two passes over device memory:
//
//   K1  p = z + beta*p_old (z = d*r or r);  q = A p;  pap = p.q
//       (A as symmetric tiles D + U + U^T, or as full blocked-ELL tiles)
//   K2  x += alpha*p;  r -= alpha*q;  rnorm = r.r  (PCG: rho = sum d*r*r)
//
// The row-sharded loop (parallel/loops.py) runs each shard's iteration as
// the per-shard SpMV + window dot (spmv_dot_kernel, the TPU's
// bell_spmv_dot) and K2 in its partials-only mode, with the partials
// summed over the shards between them.
//
// Every kernel launches on the caller's stream, allocates nothing, and the
// C entry points return cudaGetLastError() so the Python wrapper can raise.
// All tile products are FP32 FMA on the CUDA cores: no tensor cores, no
// TF32 (the same rule as the TPU kernels' VPU-over-MXU choice).
//
// What the TPU design relied on and Hopper lacks, and what replaces it:
//
// * The g == 0 prologue that formed p_new once in VMEM: here every CTA
//   RECOMPUTES z[c] + beta*p_old[c] for each block-row it gathers
//   (dir_row below), and only the CTA that owns a row stores it to p_new.
//   A gathered row costs 2-3 reads of 4*bn bytes against a 4*bn*bn tile, so
//   the recompute is < 2% extra traffic and needs no extra launch.  The
//   products use explicit __fmul_rn/__fadd_rn so every recompute of a row
//   is bit-identical to the stored one (and to torch's z + beta * p).
// * Dots accumulated into one SMEM scalar across a sequential grid: here
//   each CTA writes a partial, and the last CTA to arrive (integer atomic
//   ticket) sums all partials in index order.  No float atomics, so every
//   run gives the same bits.  That last CTA also does the solver's scalar
//   step (alpha; or beta, done, k, hist[k]) so alpha/beta/rho never leave
//   the device and no extra launch is needed.
// * The mirror U^T p[row], which lands in q[c] for c > row:
//   - banded (ku == 1, c == row + 1): a one-tile halo.  The CTA for strip
//     [base, base+R) also applies the mirror tile of row base-1 (re-read:
//     1/R of the upper-tile bytes) and carries each row's mirror into the
//     next row in shared memory; q is then a plain store.
//   - general: stage A writes each slot's mirror product to a per-slot
//     buffer tparts (nrb*ku, bn); stage B sums, for each block-row c, the
//     slots that target it in the pack-time order of mirror_src
//     (increasing source row).  tparts is 1/bn of the tile bytes.
//   - padding slots (zero tiles pointing at their own row) are skipped,
//     so their tiles are never read.
// * No-op steps after convergence: every kernel reads ctl[LIVE] first and
//   returns at once when it is 0; the host checks ctl only every K steps.
//
// What bounds it on the H100: K1 streams the stored tiles once (268 MB per
// iteration at n = 262,144 block-tridiagonal, bn = 128), so it is a
// memory-bandwidth kernel; the vectors (1 MB each there) stay in the 50 MB
// L2.  Tiles are read with streaming loads (__ldcs) so they do not evict the
// vectors.  K2 streams 6 (CG) or 7 (PCG) vectors.  Speed work (TMA rings,
// more rows in flight, CUDA graphs for the launch sequence) is later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

// p[i] = z[i] + beta * p_old[i], z = d * r (Jacobi) or r; no FMA contraction
__device__ __forceinline__ float dir_elem(const float* r, const float* pold,
                                          const float* d, float beta,
                                          int64_t i) {
  const float z = d ? __fmul_rn(d[i], r[i]) : r[i];
  return __fadd_rn(z, __fmul_rn(beta, pold[i]));
}

template <int BN>
__device__ void dir_row(float* xs, int row, const float* r, const float* pold,
                        const float* d, float beta, float* pnew) {
  for (int t = threadIdx.x; t < BN; t += kThreads) {
    const int64_t i = (int64_t)row * BN + t;
    const float v = dir_elem(r, pold, d, beta, i);
    xs[t] = v;
    if (pnew) pnew[i] = v;
  }
}

// ---- K1, banded landing ---------------------------------------------------
// Replaces conjugategradient_tpu/ops/pallas/fused_cg.py:sym_fused_dir_spmv_dot
// with mirror="banded" (_sym_dir_spmv_kernel :269-297).  Bound: the tile
// stream, 4 * bn^2 * (1 + 1 + 1/R) bytes per block-row (diag, upper tile,
// and the halo re-read of the previous row's upper tile); at n = 262,144,
// bn = 128, R = 8 that is 285 MB per call.  Design: one CTA per strip of R
// block-rows, rows in order, the mirror carried in shared memory; each tile
// is read once with streaming loads and used for both B p[c] and B^T p[row].

template <int BN>
__global__ void __launch_bounds__(kThreads)
sym_dir_banded_kernel(const float* __restrict__ diag, const float* __restrict__ off,
                      const int* __restrict__ off_cols, const float* r,
                      const float* pold, const float* d, const float* beta_p,
                      float* pnew, float* q, float* pap_out, float* partials,
                      unsigned* counter, float* scal, const int* ctl, int nrb,
                      int R) {
  if (ctl[C_LIVE] == 0) return;
  __shared__ float xr[BN], xc[BN], qacc[BN], carry[BN];
  __shared__ float red2[kWarps][BN];
  __shared__ float red[kWarps];
  const float beta = *beta_p;
  const int base = blockIdx.x * R;
  const int end = min(base + R, nrb);
  const int64_t TT = (int64_t)BN * BN;

  for (int t = threadIdx.x; t < BN; t += kThreads) carry[t] = 0.f;
  if (base > 0 && off_cols[base - 1] == base) {
    // halo: the mirror of row base-1 lands on row base
    dir_row<BN>(xr, base - 1, r, pold, d, beta, nullptr);
    __syncthreads();
    float tacc[BN / 32] = {};
    tile_apply<BN, false, true>(off + (int64_t)(base - 1) * TT, nullptr, xr,
                                nullptr, tacc);
    mirror_reduce<BN>(tacc, red2, carry);
  }
  float pap_acc = 0.f;
  for (int row = base; row < end; ++row) {
    __syncthreads();
    dir_row<BN>(xr, row, r, pold, d, beta, pnew);
    const int c = off_cols[row];
    const bool real = c != row;  // the last row's slot is inert padding
    if (real) dir_row<BN>(xc, c, r, pold, d, beta, nullptr);
    for (int t = threadIdx.x; t < BN; t += kThreads) qacc[t] = 0.f;
    __syncthreads();
    float tacc[BN / 32] = {};
    tile_apply<BN, true, false>(diag + (int64_t)row * TT, xr, nullptr, qacc, tacc);
    if (real) tile_apply<BN, true, true>(off + (int64_t)row * TT, xc, xr, qacc, tacc);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) red2[w][lane + 32 * j] = tacc[j];
    __syncthreads();
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      const float qv = qacc[t] + carry[t];
      q[(int64_t)row * BN + t] = qv;
      pap_acc += xr[t] * qv;
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += red2[i][t];
      carry[t] = s;  // this row's mirror, for row + 1
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

// ---- K1 on full storage ---------------------------------------------------
// Replaces conjugategradient_tpu/ops/pallas/fused_cg.py:fused_dir_spmv_dot
// (:111, _dir_spmv_kernel :68-107): p_new = z + beta p_old, q = A p_new,
// pap = p_new . q on full blocked-ELL tiles (nrb, kmax, bn, bn), no mirror.
// Bound: the tile stream, 4 * bn^2 * kmax bytes per block-row (402.7 MB per
// call at n = 262,144 block-tridiagonal, bn = 128).  Design: one CTA per
// strip of R block-rows; for each slot the CTA forms the gathered row of
// p_new in shared memory (dir_row, bit-identical to the owner's stored
// row) and streams the tile once.  Every slot is read, padding included:
// padding tiles are zero and point at column block 0, so they cannot be told
// from real tiles without reading them (the TPU kernel reads them too).

template <int BN>
__global__ void __launch_bounds__(kThreads)
full_dir_kernel(const float* __restrict__ blocks, const int* __restrict__ cols,
                const float* r, const float* pold, const float* d,
                const float* beta_p, float* pnew, float* q, float* pap_out,
                float* partials, unsigned* counter, float* scal, const int* ctl,
                int nrb, int kmax, int R) {
  if (ctl[C_LIVE] == 0) return;
  __shared__ float xr[BN], xc[BN], qacc[BN];
  __shared__ float red[kWarps];
  const float beta = *beta_p;
  const int base = blockIdx.x * R;
  const int end = min(base + R, nrb);
  const int64_t TT = (int64_t)BN * BN;
  float unused[BN / 32];
  float pap_acc = 0.f;
  for (int row = base; row < end; ++row) {
    __syncthreads();  // the previous row's readers of xr and qacc are done
    dir_row<BN>(xr, row, r, pold, d, beta, pnew);
    for (int t = threadIdx.x; t < BN; t += kThreads) qacc[t] = 0.f;
    for (int k = 0; k < kmax; ++k) {
      const int64_t slot = (int64_t)row * kmax + k;
      __syncthreads();  // every warp is done reading xc
      dir_row<BN>(xc, cols[slot], r, pold, d, beta, nullptr);
      __syncthreads();
      tile_apply<BN, true, false>(blocks + slot * TT, xc, nullptr, qacc, unused);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      const float qv = qacc[t];
      q[(int64_t)row * BN + t] = qv;
      pap_acc += xr[t] * qv;
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

// ---- K1 on full storage, packed nonzeros ----------------------------------
// Replaces the same fused_dir_spmv_dot (:111) where the tiles are sparse:
// the same p_new, q, pap (and alpha in the last CTA), from the operator's
// packed view (types/bell.py PackedBell: SELL-32, values and int32 global
// columns column-major within each 32-row chunk) instead of the tile
// stream.  Bound: the view's values and columns (8 bytes a stored entry)
// and row lengths, r and p_old (and d) read once, p_new and q written
// once: 7.85 MB per call on poisson3d_48 (8.29 MB with d) against the
// dense kernel's 283.1 MB of tiles.  Design: one lane per row, a warp per
// chunk, so the view's loads are coalesced.  The lane of row i forms
// p_new_i with dir_elem and stores it; each gathered p_new_j is recomputed
// with dir_elem from r, p_old and d (three reads from L2 in place of one
// tile slot), bit-identical to the stored value.  A row sums in k order
// with one rounding per product and per sum, as the plain version does, so
// q matches it bit for bit; pap goes through per-CTA partials that the last
// CTA sums in index order (no float atomics).

__global__ void __launch_bounds__(kThreads)
full_dir_packed_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                       const int* __restrict__ row_len,
                       const long long* __restrict__ chunk_off,
                       const float* __restrict__ r, const float* __restrict__ pold,
                       const float* __restrict__ d, const float* beta_p,
                       float* __restrict__ pnew, float* __restrict__ q,
                       float* pap_out, float* partials, unsigned* counter,
                       float* scal, const int* ctl, int64_t rows) {
  if (ctl[C_LIVE] == 0) return;
  __shared__ float red[kWarps];
  const float beta = *beta_p;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float pap_acc = 0.f;
  if (i < rows) {
    const float pi = dir_elem(r, pold, d, beta, i);
    pnew[i] = pi;
    const float acc = packed_row(vals, cols, row_len, chunk_off, i,
                                 [&](int c) { return dir_elem(r, pold, d, beta, c); });
    q[i] = acc;
    pap_acc = pi * acc;
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

// ---- per-shard SpMV + dot of the row-sharded loop ------------------------
// Replaces conjugategradient_tpu/ops/pallas/fused_cg.py:bell_spmv_dot
// (:467, _spmv_dot_kernel :437-464): q = A_loc x on one shard's full
// blocked-ELL tiles (nrb, kmax, bn, bn) with GLOBAL column blocks, x the
// all-gathered operand (ncb, bn); pap = x[row0 + i] . q[i], the window of
// the same operand at this shard's first row row0 = row_offset / bn.  No
// direction update (it ran before the gather) and no scalar step: pap is
// this shard's partial, which the loop sums over the shards.
// Bound: the shard's tile stream, 4 * bn^2 * kmax bytes per block-row, plus
// x and q (101.97 MB per launch at n = 262,144 block-tridiagonal split in
// 4, bn = 128).  Design: kernel 4's strip (one CTA per R block-rows, every
// slot read with streaming loads, padding included) without the recompute:
// the gathered rows are read straight from x, which sits in L2; the window
// is read from x as the TPU kernel reads it.  ctl (may be NULL) makes a
// step after the end a no-op, as in every kernel of a solve.

template <int BN>
__global__ void __launch_bounds__(kThreads)
spmv_dot_kernel(const float* __restrict__ blocks, const int* __restrict__ cols,
                const float* x, int64_t row0, float* q, float* pap_out,
                float* partials, unsigned* counter, const int* ctl, int nrb,
                int kmax, int R) {
  if (ctl && ctl[C_LIVE] == 0) return;
  __shared__ float qacc[BN];
  __shared__ float red[kWarps];
  const int base = blockIdx.x * R;
  const int end = min(base + R, nrb);
  const int64_t TT = (int64_t)BN * BN;
  float unused[BN / 32];
  float pap_acc = 0.f;
  for (int row = base; row < end; ++row) {
    __syncthreads();  // the previous row's readers of qacc are done
    for (int t = threadIdx.x; t < BN; t += kThreads) qacc[t] = 0.f;
    __syncthreads();
    for (int k = 0; k < kmax; ++k) {
      const int64_t slot = (int64_t)row * kmax + k;
      tile_apply<BN, true, false>(blocks + slot * TT, x + (int64_t)cols[slot] * BN,
                                  nullptr, qacc, unused);
    }
    __syncthreads();
    const float* xw = x + (row0 + row) * BN;
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      const float qv = qacc[t];
      q[(int64_t)row * BN + t] = qv;
      pap_acc += xw[t] * qv;
    }
  }
  const float s = block_sum(pap_acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
  if (arrive_last(counter)) {
    const float pap = sum_partials(partials, gridDim.x, red);
    if (threadIdx.x == 0) {
      pap_out[0] = pap;
      *counter = 0u;
    }
  }
}

// ---- K1, general landing: stage A (tile products) -------------------------
// Replaces sym_fused_dir_spmv_dot with mirror="scatter"/"split"
// (_sym_dir_spmv_kernel :253-268, :299-325): both land the same way here.
// Bound: the stored tiles, 4 * bn^2 * (1 + real upper slots) bytes per
// block-row (170 MB per call on poisson3d_48 at bn = 128); padding slots are
// skipped unread.  Design: one CTA per block-row; the forward products
// accumulate in shared memory, each slot's mirror product goes to tparts.

template <int BN>
__global__ void __launch_bounds__(kThreads)
sym_dir_products_kernel(const float* __restrict__ diag, const float* __restrict__ off,
                        const int* __restrict__ off_cols, const float* r,
                        const float* pold, const float* d, const float* beta_p,
                        float* pnew, float* q, float* tparts, const int* ctl,
                        int nrb, int ku) {
  if (ctl[C_LIVE] == 0) return;
  __shared__ float xr[BN], xc[BN], qacc[BN];
  __shared__ float red2[kWarps][BN];
  const float beta = *beta_p;
  const int row = blockIdx.x;
  const int64_t TT = (int64_t)BN * BN;

  dir_row<BN>(xr, row, r, pold, d, beta, pnew);
  for (int t = threadIdx.x; t < BN; t += kThreads) qacc[t] = 0.f;
  __syncthreads();
  float dummy[BN / 32] = {};
  tile_apply<BN, true, false>(diag + (int64_t)row * TT, xr, nullptr, qacc, dummy);
  for (int k = 0; k < ku; ++k) {
    const int64_t slot = (int64_t)row * ku + k;
    const int c = off_cols[slot];
    if (c == row) continue;  // padding slot: zero tile, never landed
    __syncthreads();  // every warp is done reading xc and red2
    dir_row<BN>(xc, c, r, pold, d, beta, nullptr);
    __syncthreads();
    float tacc[BN / 32] = {};
    tile_apply<BN, true, true>(off + slot * TT, xc, xr, qacc, tacc);
    mirror_reduce<BN>(tacc, red2, tparts + slot * BN);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < BN; t += kThreads) q[(int64_t)row * BN + t] = qacc[t];
}

// ---- K1, general landing: stage B (mirrors into q, pap) -------------------
// Second launch of the same wrapper call.  Bound: q, p_new and tparts,
// 4 * bn * (2 + incoming mirrors) bytes per block-row (about 2 MB on
// poisson3d_48), so it is launch-latency-bound.  Design: block-row c adds
// its incoming mirrors in mirror_src order, then the last CTA forms pap
// and alpha.

template <int BN>
__global__ void __launch_bounds__(kThreads)
sym_dir_land_kernel(float* q, const float* tparts, const int* __restrict__ mirror_src,
                    const float* pnew, float* pap_out, float* partials,
                    unsigned* counter, float* scal, const int* ctl, int nrb,
                    int kin, int R) {
  if (ctl[C_LIVE] == 0) return;
  __shared__ float red[kWarps];
  const int base = blockIdx.x * R;
  const int end = min(base + R, nrb);
  float pap_acc = 0.f;
  for (int row = base; row < end; ++row) {
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      const int64_t i = (int64_t)row * BN + t;
      float v = q[i];
      for (int j = 0; j < kin; ++j) {
        const int s = mirror_src[(int64_t)row * kin + j];
        if (s < 0) break;
        v += tparts[(int64_t)s * BN + t];
      }
      q[i] = v;
      pap_acc += pnew[i] * v;
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

// ---- K2: x += alpha p, r -= alpha q, rnorm (and PCG rho) ------------------
// Replaces fused_update_dot (fused_cg.py:608, _update_kernel :519) and,
// with d != NULL, fused_update_dot_pcg (:555, _update_kernel_pcg :534).
// Bound: 6 (CG) or 7 (PCG) vector streams of 4 n bytes, 6.3 MB at
// n = 262,144 (L2-resident there), so a few microseconds of device time.
// Design: float4 grid-stride pass with at most 1024 CTAs, then the last
// n % 4 elements one by one (a stencil volume such as 5 x 6 x 7 has such a
// tail; when n % 4 == 0 the tail loop adds nothing, so blocked-ELL lengths
// give the bits they gave before it existed), per-CTA partials, and the
// last CTA does the solver's scalar step.  On the stencil path this kernel
// also closes fused_update_dot_3d (ops/pallas/fused_stencil.py:150), the
// same function on an (nx, ny, nz) volume, through its flat view.
// x/xo and r/ro may alias (in-place update): each element is read and
// written by the same thread.  scal == NULL is the partials-only mode of
// the row-sharded loop (parallel/loops.py): the last CTA writes this
// shard's sums and stops, since the scalar step needs every shard's sum
// (it runs after the psum); ctl[C_LIVE] still makes a step after the end a
// no-op.

__global__ void __launch_bounds__(kThreads)
update_kernel(const float* alpha_p, const float* x, const float* p,
              const float* r, const float* q, const float* d, float* xo,
              float* ro, float* rnorm_out, float* rho_out, float* partials,
              unsigned* counter, float* scal, int* ctl, float* hist,
              int hist_len, int64_t n) {
  if (ctl[C_LIVE] == 0) return;
  const int64_t n4 = n / 4;
  __shared__ float red[kWarps];
  const float a = *alpha_p;
  float s1 = 0.f, s2 = 0.f;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* r4 = reinterpret_cast<const float4*>(r);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* d4 = reinterpret_cast<const float4*>(d);
  float4* xo4 = reinterpret_cast<float4*>(xo);
  float4* ro4 = reinterpret_cast<float4*>(ro);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * kThreads) {
    const float4 xv = x4[i], pv = p4[i], rv = r4[i], qv = q4[i];
    float4 xn, rn;
    xn.x = __fadd_rn(xv.x, __fmul_rn(a, pv.x));
    xn.y = __fadd_rn(xv.y, __fmul_rn(a, pv.y));
    xn.z = __fadd_rn(xv.z, __fmul_rn(a, pv.z));
    xn.w = __fadd_rn(xv.w, __fmul_rn(a, pv.w));
    rn.x = __fsub_rn(rv.x, __fmul_rn(a, qv.x));
    rn.y = __fsub_rn(rv.y, __fmul_rn(a, qv.y));
    rn.z = __fsub_rn(rv.z, __fmul_rn(a, qv.z));
    rn.w = __fsub_rn(rv.w, __fmul_rn(a, qv.w));
    xo4[i] = xn;
    ro4[i] = rn;
    const float e0 = rn.x * rn.x, e1 = rn.y * rn.y, e2 = rn.z * rn.z,
                e3 = rn.w * rn.w;
    s1 += e0; s1 += e1; s1 += e2; s1 += e3;
    if (d) {
      const float4 dv = d4[i];
      s2 = fmaf(dv.x, e0, s2); s2 = fmaf(dv.y, e1, s2);
      s2 = fmaf(dv.z, e2, s2); s2 = fmaf(dv.w, e3, s2);
    }
  }
  // the scalar tail: at most 3 elements, one per thread of CTA 0
  const int64_t t = 4 * n4 + (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t < n) {
    const float xn = __fadd_rn(x[t], __fmul_rn(a, p[t]));
    const float rn = __fsub_rn(r[t], __fmul_rn(a, q[t]));
    xo[t] = xn;
    ro[t] = rn;
    const float e = rn * rn;
    s1 += e;
    if (d) s2 = fmaf(d[t], e, s2);
  }
  const float b1 = block_sum(s1, red);
  const float b2 = d ? block_sum(s2, red) : 0.f;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = b1;
    partials[gridDim.x + blockIdx.x] = b2;
  }
  if (arrive_last(counter)) {
    const float rn = sum_partials(partials, gridDim.x, red);
    const float rz = d ? sum_partials(partials + gridDim.x, gridDim.x, red) : rn;
    if (threadIdx.x == 0) {
      if (scal) {
        // the solver's scalar step (solver/fused.py): termination tests the
        // PRE-update ||r||^2, beta = rho_next / rho with the rho == 0 guard
        const float rn_pre = scal[S_RNORM], rho = scal[S_RHO];
        const int done = isnan(rn_pre) || sqrtf(rn_pre) <= scal[S_TOL];
        const int k = ctl[C_K] + 1;
        ctl[C_K] = k;
        ctl[C_DONE] = done;
        ctl[C_LIVE] = !done && k < ctl[C_MAXITER];
        if (k < hist_len) hist[k] = rn;
        scal[S_BETA] = rho == 0.f ? 0.f : rz / rho;
        scal[S_RHO] = rz;
        scal[S_RNORM] = rn;
      }
      rnorm_out[0] = rn;
      if (rho_out) rho_out[0] = rz;
      *counter = 0u;
    }
  }
}

template <int BN>
cudaError_t launch_banded(const float* diag, const float* off, const int* off_cols,
                          const float* r, const float* pold, const float* d,
                          const float* beta, float* pnew, float* q, float* pap,
                          float* partials, unsigned* counter, float* scal,
                          const int* ctl, int nrb, int R, cudaStream_t s) {
  const int grid = (nrb + R - 1) / R;
  sym_dir_banded_kernel<BN><<<grid, kThreads, 0, s>>>(
      diag, off, off_cols, r, pold, d, beta, pnew, q, pap, partials, counter,
      scal, ctl, nrb, R);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_general(const float* diag, const float* off, const int* off_cols,
                           const int* mirror_src, const float* r, const float* pold,
                           const float* d, const float* beta, float* pnew, float* q,
                           float* pap, float* tparts, float* partials,
                           unsigned* counter, float* scal, const int* ctl, int nrb,
                           int ku, int kin, int R, cudaStream_t s) {
  sym_dir_products_kernel<BN><<<nrb, kThreads, 0, s>>>(
      diag, off, off_cols, r, pold, d, beta, pnew, q, tparts, ctl, nrb, ku);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int grid = (nrb + R - 1) / R;
  sym_dir_land_kernel<BN><<<grid, kThreads, 0, s>>>(
      q, tparts, mirror_src, pnew, pap, partials, counter, scal, ctl, nrb, kin, R);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_full(const float* blocks, const int* cols, const float* r,
                        const float* pold, const float* d, const float* beta,
                        float* pnew, float* q, float* pap, float* partials,
                        unsigned* counter, float* scal, const int* ctl, int nrb,
                        int kmax, int R, cudaStream_t s) {
  const int grid = (nrb + R - 1) / R;
  full_dir_kernel<BN><<<grid, kThreads, 0, s>>>(
      blocks, cols, r, pold, d, beta, pnew, q, pap, partials, counter, scal,
      ctl, nrb, kmax, R);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_spmv_dot(const float* blocks, const int* cols, const float* x,
                            int64_t row0, float* q, float* pap, float* partials,
                            unsigned* counter, const int* ctl, int nrb, int kmax,
                            int R, cudaStream_t s) {
  const int grid = (nrb + R - 1) / R;
  spmv_dot_kernel<BN><<<grid, kThreads, 0, s>>>(blocks, cols, x, row0, q, pap,
                                                partials, counter, ctl, nrb, kmax, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-shard SpMV + window dot (row0 = row_offset / bn).  Returns a
// cudaError_t.
int cg_bell_spmv_dot(const float* blocks, const int* cols, const float* x,
                     int64_t row0, float* q, float* pap, float* partials,
                     unsigned* counter, const int* ctl, int nrb, int kmax, int bn,
                     int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return launch_spmv_dot<32>(blocks, cols, x, row0, q, pap, partials, counter, ctl, nrb, kmax, R, s);
    case 64: return launch_spmv_dot<64>(blocks, cols, x, row0, q, pap, partials, counter, ctl, nrb, kmax, R, s);
    case 128: return launch_spmv_dot<128>(blocks, cols, x, row0, q, pap, partials, counter, ctl, nrb, kmax, R, s);
    case 256: return launch_spmv_dot<256>(blocks, cols, x, row0, q, pap, partials, counter, ctl, nrb, kmax, R, s);
    default: return cudaErrorInvalidValue;
  }
}

// K1 on the packed nonzeros of full blocked-ELL storage; rows = nrb * bn.
// Returns a cudaError_t.
int cg_full_dir_packed(const float* vals, const int* cols, const int* row_len,
                       const long long* chunk_off, const float* r, const float* pold,
                       const float* d, const float* beta, float* pnew, float* q,
                       float* pap, float* partials, unsigned* counter, float* scal,
                       const int* ctl, int64_t rows, void* stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const int64_t grid = (rows + kThreads - 1) / kThreads;
  full_dir_packed_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, cols, row_len, chunk_off, r, pold, d, beta, pnew, q, pap, partials,
      counter, scal, ctl, rows);
  return cudaGetLastError();
}

// K1 on full blocked-ELL storage.  Returns a cudaError_t.
int cg_full_dir(const float* blocks, const int* cols, const float* r,
                const float* pold, const float* d, const float* beta,
                float* pnew, float* q, float* pap, float* partials,
                unsigned* counter, float* scal, const int* ctl, int nrb,
                int kmax, int bn, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return launch_full<32>(blocks, cols, r, pold, d, beta, pnew, q, pap, partials, counter, scal, ctl, nrb, kmax, R, s);
    case 64: return launch_full<64>(blocks, cols, r, pold, d, beta, pnew, q, pap, partials, counter, scal, ctl, nrb, kmax, R, s);
    case 128: return launch_full<128>(blocks, cols, r, pold, d, beta, pnew, q, pap, partials, counter, scal, ctl, nrb, kmax, R, s);
    case 256: return launch_full<256>(blocks, cols, r, pold, d, beta, pnew, q, pap, partials, counter, scal, ctl, nrb, kmax, R, s);
    default: return cudaErrorInvalidValue;
  }
}

// K1 with the banded landing.  Returns a cudaError_t.
int cg_sym_dir_banded(const float* diag, const float* off, const int* off_cols,
                      const float* r, const float* pold, const float* d,
                      const float* beta, float* pnew, float* q, float* pap,
                      float* partials, unsigned* counter, float* scal,
                      const int* ctl, int nrb, int bn, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return launch_banded<32>(diag, off, off_cols, r, pold, d, beta, pnew, q, pap, partials, counter, scal, ctl, nrb, R, s);
    case 64: return launch_banded<64>(diag, off, off_cols, r, pold, d, beta, pnew, q, pap, partials, counter, scal, ctl, nrb, R, s);
    case 128: return launch_banded<128>(diag, off, off_cols, r, pold, d, beta, pnew, q, pap, partials, counter, scal, ctl, nrb, R, s);
    case 256: return launch_banded<256>(diag, off, off_cols, r, pold, d, beta, pnew, q, pap, partials, counter, scal, ctl, nrb, R, s);
    default: return cudaErrorInvalidValue;
  }
}

// K1 with the general (scatter/split) landing: stage A then stage B.
int cg_sym_dir_general(const float* diag, const float* off, const int* off_cols,
                       const int* mirror_src, const float* r, const float* pold,
                       const float* d, const float* beta, float* pnew, float* q,
                       float* pap, float* tparts, float* partials,
                       unsigned* counter, float* scal, const int* ctl, int nrb,
                       int ku, int kin, int bn, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return launch_general<32>(diag, off, off_cols, mirror_src, r, pold, d, beta, pnew, q, pap, tparts, partials, counter, scal, ctl, nrb, ku, kin, R, s);
    case 64: return launch_general<64>(diag, off, off_cols, mirror_src, r, pold, d, beta, pnew, q, pap, tparts, partials, counter, scal, ctl, nrb, ku, kin, R, s);
    case 128: return launch_general<128>(diag, off, off_cols, mirror_src, r, pold, d, beta, pnew, q, pap, tparts, partials, counter, scal, ctl, nrb, ku, kin, R, s);
    case 256: return launch_general<256>(diag, off, off_cols, mirror_src, r, pold, d, beta, pnew, q, pap, tparts, partials, counter, scal, ctl, nrb, ku, kin, R, s);
    default: return cudaErrorInvalidValue;
  }
}

// K2 (d == NULL: plain CG; else Jacobi PCG; scal == NULL: partials only).
// n is any length; every vector is 16-byte aligned (checked by the
// wrapper).
int cg_update(const float* alpha, const float* x, const float* p, const float* r,
              const float* q, const float* d, float* xo, float* ro,
              float* rnorm, float* rho, float* partials, unsigned* counter,
              float* scal, int* ctl, float* hist, int hist_len, int64_t n,
              int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  update_kernel<<<grid, kThreads, 0, s>>>(alpha, x, p, r, q, d, xo, ro, rnorm,
                                          rho, partials, counter, scal, ctl,
                                          hist, hist_len, n);
  return cudaGetLastError();
}

}  // extern "C"
