// Fused MINRES-iteration kernels for Hopper (sm_90a), bound through ctypes.
//
// Counterpart of conjugategradient_tpu/ops/pallas/fused_minres.py.  One
// MINRES iteration is two passes over device memory:
//
//   K1  the PREVIOUS iteration's solution update, on the owner's rows:
//         w = (v_prev - eps*w_2 - delta*w_1) * (1/gamma);  x += phi * w
//       v = (d*r2) * (1/beta)  (d: Jacobi inverse diagonal, or absent);
//       q = A v - sigma*v;  vq = v.q;  vr1 = v.r1
//       (A as full blocked-ELL tiles, or as symmetric tiles D + U + U^T)
//   K2  r2' = q - c1*r1 - ia*r2;  bsq = r2'.(d*r2')
//
// The row-sharded loop (parallel/loops.py) runs each shard's iteration as
// minres_shard_kernel (the TPU's minres_shard_spmv_dot: the pending update
// and the SpMV on the all-gathered v) and K2 in its partials-only mode,
// with the partials summed over the shards after each.
//
// Launch rules, tile products (tile.cuh) and the fixed-order two-stage dots
// are those of fused_cg.cu.  What the TPU kernels relied on and Hopper
// lacks, and what replaces it:
//
// * The g == 0 prologue did the pending w/x update over the whole vectors
//   and formed v once in VMEM.  Here the CTA that OWNS a block-row does the
//   update and stores v for that row (own_row); every CTA RECOMPUTES a
//   gathered row v[c] from r2 and d (lanczos_row), bit-identical to the
//   owner's stored row: __fmul_rn, and the reciprocal 1/beta as a factor,
//   as the plain version's two multiplies.  Gathers read r2 and d only,
//   which K1 never writes, so v may overwrite v_prev, x is updated in
//   place, and w may overwrite w_2: each of those elements is read and
//   written by one thread of the owner.
// * Two dots per pass: two partials per CTA, summed in index order by the
//   last CTA to arrive.  No float atomics: every run gives the same bits.
// * The shift: q = A v - sigma*v, two roundings, applied where a row's q is
//   final (at the row's store; with the general mirror landing, in the
//   second launch), and v.q uses the shifted q.
// * The scalar recurrence between and after the kernels stays on the
//   device: K1's last CTA forms c1, alpha and alpha/beta (finish_dir); K2's
//   last CTA takes beta' = sqrt(bsq), does the Givens rotation and writes
//   the next pending-update scalars, hist[k], k, done, the sticky NaN flag
//   and live (finish_update).  Products and sums there are __fmul_rn /
//   __fadd_rn, division and sqrtf round correctly (no fast-math), so the
//   plain version's torch 0-d float32 ops give the same bits.
// * Every kernel writes nothing when ctl[C_LIVE] is 0 (K2 issues its
//   first loads beside that read, then returns).
//
// What bounds them on the H100: K1 streams the stored tiles once (402.7 MB
// full, 268.4 MB symmetric at n = 262,144 block-tridiagonal, bn = 128) and
// ten or eleven vectors (1 MB each there, L2-resident): memory bandwidth.
// K2 streams four or five vectors.  Where the tiles are sparse
// (ops/spmv.bell_packed_route), K1 has a packed form on either storage
// (minres_dir_packed_kernel below) that reads the operator's nonzeros
// instead, with the same outputs and tail.
//
// bfloat16 tiles (the TPU kernels' other operand form, fused_minres.py:92,
// 245,249,269,272,505: bf16 tiles, float32 vectors): every kernel that reads
// the operator (K1 on full storage, dense and packed; on symmetric storage,
// banded and general landings; the row-sharded K1) takes the tile type as a
// template parameter.  Each element is widened to float32 as it is loaded
// (exact) and every product and sum is the float32 kernel's, in its order,
// so a bf16 launch gives the bits of the float32 launch on tiles.float().
// The tile stream, and the bound, halve (201.3 MB a call at n = 262,144
// full, 134.2 MB symmetric; 6 bytes a nonzero packed).  K2 and the general
// landing's second launch read vectors only and need no other form.  The
// bf16 forms have their own entry points (minres_*_bf16) and launch
// counters.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

// MinresWork.scal (ops/cuda/fused_minres.py keeps the same indices): the
// (1, 8) row K1 reads, then the recurrence's state
enum { SU_INV_BETA = 0, SU_SHIFT = 1, SU_OLDEPS = 2, SU_DELTA = 3, SU_IGAMMA = 4,
       SU_PHI = 5 };
enum { M_BETA = 8, M_OLDB = 9, M_DBAR = 10, M_EPSLN = 11, M_PHIBAR = 12, M_CS = 13,
       M_SN = 14, M_TOL = 15, M_C1 = 16, M_IA = 17, M_ALFA = 18 };
constexpr int C_NAN = 4;  // after fused_cg's four control words

// K1's vector operands.  v/vprev, w/wm2 and xo/x may alias (see above).
struct DirArgs {
  const float *r2, *r1, *vprev, *wm1, *wm2, *x, *d, *su;
  float *v, *q, *w, *xo, *vq, *vr1, *partials;
  unsigned* counter;
  float* scal;
  const int* ctl;
};

// v = (d * r2) * (1/beta), or r2 * (1/beta), on loaded values
__device__ __forceinline__ float lanczos_val(float r2, float d, bool has_d, float inv_beta) {
  return __fmul_rn(has_d ? __fmul_rn(d, r2) : r2, inv_beta);
}

__device__ __forceinline__ float lanczos_elem(const float* r2, const float* d,
                                              float inv_beta, int64_t i) {
  return lanczos_val(r2[i], d ? d[i] : 0.f, d != nullptr, inv_beta);
}

// xs[t] = v[row, t], recomputed from r2 and d
template <int BN>
__device__ void lanczos_row(float* xs, int row, const DirArgs& a, float inv_beta) {
  for (int t = threadIdx.x; t < BN; t += kThreads)
    xs[t] = lanczos_elem(a.r2, a.d, inv_beta, (int64_t)row * BN + t);
}

// An owned element's operands, loaded before any of its aliases is
// written (v_prev, w-2 and x may be v, w and x'); the banded kernel loads
// them one row ahead.
struct OwnLoad {
  float vprev = 0.f, wm2 = 0.f, wm1 = 0.f, x = 0.f, r2 = 0.f, d = 0.f;
  __device__ __forceinline__ void load_at(int64_t i, const DirArgs& a) {
    vprev = a.vprev[i];
    wm2 = a.wm2[i];
    wm1 = a.wm1[i];
    x = a.x[i];
    r2 = a.r2[i];
    if (a.d) d = a.d[i];
  }
  // the pending w/x update of element i, then v[i] stored and returned
  __device__ __forceinline__ float own(int64_t i, const DirArgs& a, const float* su) const {
    const float w = __fmul_rn(
        __fsub_rn(__fsub_rn(vprev, __fmul_rn(su[SU_OLDEPS], wm2)), __fmul_rn(su[SU_DELTA], wm1)),
        su[SU_IGAMMA]);
    a.w[i] = w;
    a.xo[i] = __fadd_rn(x, __fmul_rn(su[SU_PHI], w));
    const float v = lanczos_val(r2, d, a.d != nullptr, su[SU_INV_BETA]);
    a.v[i] = v;
    return v;
  }
};

// The owner's element i: the pending w/x update, then v[i] stored and
// returned.
__device__ __forceinline__ float own_elem(int64_t i, const DirArgs& a, const float* su) {
  OwnLoad l;
  l.load_at(i, a);
  return l.own(i, a, su);
}

// The owner's row: own_elem over the row, v into xs.
template <int BN>
__device__ void own_row(float* xs, int row, const DirArgs& a, const float* su) {
  for (int t = threadIdx.x; t < BN; t += kThreads) xs[t] = own_elem((int64_t)row * BN + t, a, su);
}

// K1's last CTA, thread 0: the dots, then c1 = beta/beta_old (0 on the
// first step: no v_{k-1} term), alpha = vq - c1*vr1, and alpha/beta for K2
__device__ void finish_dir(float vq, float vr1, const DirArgs& a) {
  a.vq[0] = vq;
  a.vr1[0] = vr1;
  float* scal = a.scal;
  const float beta = scal[M_BETA], oldb = scal[M_OLDB];
  const float c1 = oldb == 0.f ? 0.f : beta / oldb;
  const float alfa = __fsub_rn(vq, __fmul_rn(c1, vr1));
  scal[M_C1] = c1;
  scal[M_ALFA] = alfa;
  scal[M_IA] = alfa / beta;
}

// Both dots' partials of one of n strips (index i): vq at i, vr1 at n + i.
__device__ void store_dir_partials(float vq_acc, float vr1_acc, const DirArgs& a, float* red,
                                   int i, int n) {
  const float s1 = block_sum(vq_acc, red);
  const float s2 = block_sum(vr1_acc, red);
  if (threadIdx.x == 0) {
    a.partials[i] = s1;
    a.partials[n + i] = s2;
  }
}

// The last CTA to arrive sums n strips' partials in index order.
__device__ void finish_dir_partials(const DirArgs& a, float* red, int n) {
  if (arrive_last(a.counter)) {
    const float vq = sum_partials(a.partials, n, red);
    const float vr1 = sum_partials(a.partials + n, n, red);
    if (threadIdx.x == 0) {
      finish_dir(vq, vr1, a);
      *a.counter = 0u;
    }
  }
}

// Both dots of a K1 pass: per-CTA partials, summed by the last CTA.
__device__ void reduce_dir(float vq_acc, float vr1_acc, const DirArgs& a, float* red) {
  store_dir_partials(vq_acc, vr1_acc, a, red, blockIdx.x, gridDim.x);
  finish_dir_partials(a, red, gridDim.x);
}

// q = A v - sigma v from a row's product: two roundings
__device__ __forceinline__ float shifted(float av, float shift, float v) {
  return __fsub_rn(av, __fmul_rn(shift, v));
}

// A row's final q: shift, store, and both dot terms (xs holds the row's v).
template <int BN>
__device__ __forceinline__ void store_q(int row, int t, float qv, const float* xs,
                                        float shift, const DirArgs& a, float& vq_acc,
                                        float& vr1_acc) {
  const int64_t i = (int64_t)row * BN + t;
  qv = shifted(qv, shift, xs[t]);
  a.q[i] = qv;
  vq_acc += xs[t] * qv;
  vr1_acc += xs[t] * a.r1[i];
}

// ---- K1 on full storage ---------------------------------------------------
// Replaces conjugategradient_tpu/ops/pallas/fused_minres.py:minres_dir_spmv_dot
// (:113, _minres_spmv_kernel :54-109).  Bound: the tile stream, 4 * bn^2 *
// kmax bytes per block-row, and 10 (11 with d) vectors.  Design: one CTA per
// strip of R block-rows, as fused_cg.cu's full_dir_kernel; every slot is
// read (padding tiles are zero and point at column block 0).

template <int BN, class E>
__global__ void __launch_bounds__(kThreads)
minres_full_kernel(const E* __restrict__ blocks, const int* __restrict__ cols,
                   DirArgs a, int nrb, int kmax, int R) {
  if (a.ctl[C_LIVE] == 0) return;
  __shared__ float xr[BN], xc[BN], qacc[BN];
  __shared__ float red[kWarps];
  __shared__ float su[8];
  if (threadIdx.x < 8) su[threadIdx.x] = a.su[threadIdx.x];
  __syncthreads();
  const int base = blockIdx.x * R;
  const int end = min(base + R, nrb);
  const int64_t TT = (int64_t)BN * BN;
  float unused[BN / 32];
  float vq_acc = 0.f, vr1_acc = 0.f;
  for (int row = base; row < end; ++row) {
    __syncthreads();  // the previous row's readers of xr and qacc are done
    own_row<BN>(xr, row, a, su);
    for (int t = threadIdx.x; t < BN; t += kThreads) qacc[t] = 0.f;
    for (int k = 0; k < kmax; ++k) {
      const int64_t slot = (int64_t)row * kmax + k;
      __syncthreads();  // every warp is done reading xc
      lanczos_row<BN>(xc, cols[slot], a, su[SU_INV_BETA]);
      __syncthreads();
      tile_apply<BN, true, false>(blocks + slot * TT, xc, nullptr, qacc, unused);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < BN; t += kThreads)
      store_q<BN>(row, t, qacc[t], xr, su[SU_SHIFT], a, vq_acc, vr1_acc);
  }
  reduce_dir(vq_acc, vr1_acc, a, red);
}

// ---- K1, symmetric storage, banded landing --------------------------------
// Replaces sym_minres_dir_spmv_dot (:298) with mirror="banded"
// (_sym_minres_spmv_kernel :260-282).  Bound: the stored tiles (diag and
// upper tile, 4 * bn^2 * 2 bytes per block-row in float32, half in bf16)
// and 10 (11) vectors.  Design: fused_cg.cu's sym_dir_banded_kernel
// (persistent CTAs over spans of R-row strips, the tile stream staged
// through TileRing, a row's operands loaded during the previous row's
// tiles, one partial of each dot per strip at the strip's index) with the
// MINRES operand and row epilogue: a row's q is final at its store, carry
// included.

template <int BN, class E>
__global__ void __launch_bounds__(kThreads, 2)
minres_banded_kernel(const E* __restrict__ diag, const E* __restrict__ off,
                     const int* __restrict__ off_cols, DirArgs a, int nrb, int R,
                     int stages) {
  if (a.ctl[C_LIVE] == 0) return;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  __shared__ float xr[BN], xc[BN], qacc[BN], carry[BN];
  __shared__ float red2[kWarps][BN];
  __shared__ float red[kWarps];
  __shared__ float su[8];
  const int nstrips = (nrb + R - 1) / R;
  int s0, s1;
  span_of(nstrips, s0, s1);
  const int row0 = s0 * R, row1 = min(s1 * R, nrb);
  const bool halo = row0 > 0 && off_cols[row0 - 1] == row0;
  TileRing<BN, E> ring(ring_smem, stages,
                       BandedStream<BN, E>(diag, off, off_cols, row0, row1, halo));
  if (threadIdx.x < 8) su[threadIdx.x] = a.su[threadIdx.x];

  for (int t = threadIdx.x; t < BN; t += kThreads) carry[t] = 0.f;
  __syncthreads();  // su, carry and the ring's barriers
  if (halo) {
    // the mirror of row row0-1 lands on row row0
    lanczos_row<BN>(xr, row0 - 1, a, su[SU_INV_BETA]);
    __syncthreads();
    float tacc[BN / 32] = {};
    ring.template apply_tile<false, true>(nullptr, xr, nullptr, tacc);
    mirror_reduce<BN>(tacc, red2, carry);
  }
  // a row's own operands and its gathered row's, loaded one row ahead so
  // that their round trips overlap the previous row's tile stream (no
  // other CTA writes this span's rows, and gathers read r2 and d only)
  OwnLoad own, gat;
  const auto load_own = [&](int row) {
    if (threadIdx.x < BN) own.load_at((int64_t)row * BN + threadIdx.x, a);
  };
  const auto load_gathered = [&](int row) {  // r2 and d only
    if (threadIdx.x < BN) {
      const int64_t i = (int64_t)row * BN + threadIdx.x;
      gat.r2 = a.r2[i];
      if (a.d) gat.d = a.d[i];
    }
  };
  int c = off_cols[row0];
  load_own(row0);
  if (c != row0) load_gathered(c);
  float vq_acc = 0.f, vr1_acc = 0.f;
  for (int row = row0; row < row1; ++row) {
    __syncthreads();
    const bool real = c != row;  // the last row's slot is inert padding
    if (threadIdx.x < BN) {
      xr[threadIdx.x] = own.own((int64_t)row * BN + threadIdx.x, a, su);
      if (real) xc[threadIdx.x] = lanczos_val(gat.r2, gat.d, a.d != nullptr, su[SU_INV_BETA]);
      qacc[threadIdx.x] = 0.f;
    }
    const bool more = row + 1 < row1;
    const int cn = more ? off_cols[row + 1] : 0;
    if (more) load_own(row + 1);
    __syncthreads();
    float tacc[BN / 32] = {};
    ring.template apply_tile<true, false>(xr, nullptr, qacc, tacc);
    if (more && cn != row + 1) load_gathered(cn);
    if (real) ring.template apply_tile<true, true>(xc, xr, qacc, tacc);
    c = cn;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) red2[w][lane + 32 * j] = tacc[j];
    __syncthreads();
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      store_q<BN>(row, t, __fadd_rn(qacc[t], carry[t]), xr, su[SU_SHIFT], a, vq_acc,
                  vr1_acc);
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += red2[i][t];
      carry[t] = s;  // this row's mirror, for row + 1
    }
    if (row + 1 == row1 || (row + 1) % R == 0) {  // the strip's last row
      store_dir_partials(vq_acc, vr1_acc, a, red, row / R, nstrips);
      vq_acc = vr1_acc = 0.f;
    }
  }
  finish_dir_partials(a, red, nstrips);
}

// ---- K1, symmetric storage, general landing: stage A (tile products) -------
// Replaces sym_minres_dir_spmv_dot with mirror="scatter"
// (_sym_minres_spmv_kernel :240-259).  Bound: the stored tiles, padding
// slots skipped unread.  Design: fused_cg.cu's sym_dir_products_kernel; q
// leaves this stage unshifted and without its incoming mirrors.

template <int BN, class E>
__global__ void __launch_bounds__(kThreads)
minres_products_kernel(const E* __restrict__ diag, const E* __restrict__ off,
                       const int* __restrict__ off_cols, DirArgs a, float* tparts,
                       int nrb, int ku) {
  if (a.ctl[C_LIVE] == 0) return;
  __shared__ float xr[BN], xc[BN], qacc[BN];
  __shared__ float red2[kWarps][BN];
  __shared__ float su[8];
  if (threadIdx.x < 8) su[threadIdx.x] = a.su[threadIdx.x];
  __syncthreads();
  const int row = blockIdx.x;
  const int64_t TT = (int64_t)BN * BN;

  own_row<BN>(xr, row, a, su);
  for (int t = threadIdx.x; t < BN; t += kThreads) qacc[t] = 0.f;
  __syncthreads();
  float dummy[BN / 32] = {};
  tile_apply<BN, true, false>(diag + (int64_t)row * TT, xr, nullptr, qacc, dummy);
  for (int k = 0; k < ku; ++k) {
    const int64_t slot = (int64_t)row * ku + k;
    const int c = off_cols[slot];
    if (c == row) continue;  // padding slot: zero tile, never landed
    __syncthreads();  // every warp is done reading xc and red2
    lanczos_row<BN>(xc, c, a, su[SU_INV_BETA]);
    __syncthreads();
    float tacc[BN / 32] = {};
    tile_apply<BN, true, true>(off + slot * TT, xc, xr, qacc, tacc);
    mirror_reduce<BN>(tacc, red2, tparts + slot * BN);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < BN; t += kThreads) a.q[(int64_t)row * BN + t] = qacc[t];
}

// ---- K1, general landing: stage B (mirrors, shift, dots) -------------------
// Second launch of the same wrapper call.  Block-row c adds its incoming
// mirrors in mirror_src order; its q is final only now, so the shift, both
// dots and the scalar step are here.  v is read as stage A stored it.

template <int BN>
__global__ void __launch_bounds__(kThreads)
minres_land_kernel(const float* tparts, const int* __restrict__ mirror_src, DirArgs a,
                   int nrb, int kin, int R) {
  if (a.ctl[C_LIVE] == 0) return;
  __shared__ float red[kWarps];
  const float shift = a.su[SU_SHIFT];
  const int base = blockIdx.x * R;
  const int end = min(base + R, nrb);
  float vq_acc = 0.f, vr1_acc = 0.f;
  for (int row = base; row < end; ++row) {
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      const int64_t i = (int64_t)row * BN + t;
      float qv = a.q[i];
      for (int j = 0; j < kin; ++j) {
        const int s = mirror_src[(int64_t)row * kin + j];
        if (s < 0) break;
        qv += tparts[(int64_t)s * BN + t];
      }
      const float v = a.v[i];
      qv = shifted(qv, shift, v);
      a.q[i] = qv;
      vq_acc += v * qv;
      vr1_acc += v * a.r1[i];
    }
  }
  reduce_dir(vq_acc, vr1_acc, a, red);
}

// ---- K1 on the packed nonzeros, full or symmetric storage ------------------
// Replaces the same minres_dir_spmv_dot (:113) and sym_minres_dir_spmv_dot
// (:298) where the tiles are sparse: the same v, q, w, x' and dots (and c1,
// alpha, alpha/beta in the last CTA), from the operator's packed view
// (types/bell.py PackedBell) instead of the tile stream.  Full storage's
// view holds its tiles' nonzeros; symmetric storage's holds D + U + U^T, each
// stored upper nonzero in its own row and in its mirror row, so no mirror
// lands anywhere: one launch, no scratch, a fixed order per row.  Bound: the
// view's values and columns (8 bytes a stored entry) and row lengths, and
// ten vectors (eleven with d), each read or written once: 10.5 MB per call
// on poisson3d_48 (760,320 nonzeros) against the dense kernels' 283.1 MB
// (full) and 169.9 MB (symmetric) of tiles.  Symmetric storage stores
// 612,288 of those nonzeros, so its view reads the off-diagonal ones twice:
// at best 0.89 of the bound on what that storage needs.  Design: fused_cg.cu's
// full_dir_packed_kernel: one lane per row and a warp per 32-row chunk
// (packed_row, tile.cuh).  The lane of row i does own_elem (the pending w/x
// update and v[i]); each gathered v[c] is recomputed with lanczos_elem from
// r2 and d, bit-identical to the owner's store, so gathers read only r2 and
// d, which no lane writes.  A row sums in k order with one rounding per
// product and per sum, as the plain version does, so q matches it bit for
// bit; the dots go through per-CTA partials that the last CTA sums in index
// order and the dense kernels' tail (reduce_dir, finish_dir).  Padding rows
// (no entries, r2 = 0, d = 1) give v = q = 0.

template <class E>
__global__ void __launch_bounds__(kThreads)
minres_dir_packed_kernel(const E* __restrict__ vals, const int* __restrict__ cols,
                         const int* __restrict__ row_len,
                         const long long* __restrict__ chunk_off, DirArgs a, int64_t rows) {
  if (a.ctl[C_LIVE] == 0) return;
  __shared__ float red[kWarps];
  __shared__ float su[8];
  if (threadIdx.x < 8) su[threadIdx.x] = a.su[threadIdx.x];
  __syncthreads();
  const float inv_beta = su[SU_INV_BETA];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float vq_acc = 0.f, vr1_acc = 0.f;
  if (i < rows) {
    const float v = own_elem(i, a, su);
    const float av = packed_row(vals, cols, row_len, chunk_off, i,
                                [&](int c) { return lanczos_elem(a.r2, a.d, inv_beta, c); });
    const float qv = shifted(av, su[SU_SHIFT], v);
    a.q[i] = qv;
    vq_acc = v * qv;
    vr1_acc = v * a.r1[i];
  }
  reduce_dir(vq_acc, vr1_acc, a, red);
}

// ---- K1 of the row-sharded loop -------------------------------------------
// Replaces conjugategradient_tpu/ops/pallas/fused_minres.py:
// minres_shard_spmv_dot (:528, _minres_shard_kernel :470-525): on one
// shard, the pending solution update of the local rows,
//   w = (v_prev - eps*w_2 - delta*w_1) * (1/gamma);  x' = x + phi*w,
// then q = A_loc v - sigma*v_win with v the all-gathered, already normalised
// Lanczos vector (ncb, bn) and v_win its window at this shard's first row
// row0 = row_offset / bn, and the partials v_win.q and v_win.r1 (dots[0],
// dots[1]).  No 1/beta (v was normalised before the gather) and no scalar
// step: the loop sums the partials over the shards and steps after that.
// Bound: the shard's tile stream and eight local vectors (r1, v_prev, w_1,
// w_2, x in; q, w, x' out) and v (103.81 MB per launch at n = 262,144
// block-tridiagonal split in 4, bn = 128; 52.43 MB split in 8).  Design:
// fused_cg.cu's spmv_dot_kernel (redesigned for the H100 with it: persistent
// CTAs over spans of R-row strips, the span's tiles staged through TileRing's
// slot stream, the products through apply_tile, q's row buffer alternating
// between two) with the MINRES row work.  The TPU kernel formed w and x'
// whole in a g == 0 prologue; a CUDA grid has none, so each CTA updates the
// w and x' rows of its own span (the local vectors have q's rows: square
// tiles), and a row's operands (v's window row, r1, v_prev, w_1, w_2, x)
// are loaded during the previous row's tiles.  __fmul_rn / __fsub_rn /
// __fadd_rn in the plain version's order make w, x' and the shift
// bit-equal to its torch ops; both dots keep the first port's per-thread
// sums and one partial of each per strip, at the strip's index, reduced
// side by side (block_sum2, sum_partials2: each in block_sum's and
// sum_partials's order) and published by thread 0 (publish_last).  w may be
// written over w_2 and x' over x (each element is read and written by one
// thread); nothing else may alias (the wrapper checks): other CTAs read v.
// ctl (may be NULL) makes a step after the end a no-op: nothing is written.

struct ShardArgs {
  const float *vfull, *r1, *vprev, *wm1, *wm2, *x, *su;
  float *q, *w, *xo, *dots, *partials;
  unsigned* counter;
  const int* ctl;
};

// A row's entry t of everything kernel 17 reads beside the tiles, loaded
// one row ahead.
struct ShardLoad {
  float vw = 0.f, r1 = 0.f, vprev = 0.f, wm1 = 0.f, wm2 = 0.f, x = 0.f;
  __device__ __forceinline__ void load(const ShardArgs& a, int64_t row0, int row, int bn,
                                       int t) {
    const int64_t i = (int64_t)row * bn + t;
    vw = a.vfull[(row0 + row) * bn + t];
    r1 = a.r1[i];
    vprev = a.vprev[i];
    wm1 = a.wm1[i];
    wm2 = a.wm2[i];
    x = a.x[i];
  }
};

template <int BN, class E>
__global__ void __launch_bounds__(kThreads, 2)
minres_shard_kernel(const E* __restrict__ blocks, const int* __restrict__ cols,
                    ShardArgs a, int64_t row0, int nrb, int kmax, int R, int stages) {
  // the live flag's round trip overlaps the ring's first copies (as in
  // fused_cg.cu's spmv_dot_kernel)
  const int live = a.ctl ? ld_now(a.ctl + C_LIVE) : 1;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  __shared__ float qacc[2][BN];
  __shared__ float red[2][kWarps];
  __shared__ float su[8];
  const int nstrips = (nrb + R - 1) / R;
  int s0, s1;
  span_of(nstrips, s0, s1);
  const int rowa = s0 * R, rowb = min(s1 * R, nrb);
  TileRing<BN, E, SlotStream<BN, E>> ring(ring_smem, stages,
                                         SlotStream<BN, E>(blocks, kmax, rowa, rowb));
  if (live == 0) {
    ring.drain();
    return;
  }
  const int t = threadIdx.x;
  if (t < 8) su[t] = a.su[t];
  ShardLoad next;
  if (t < BN) {
    qacc[0][t] = 0.f;
    next.load(a, row0, rowa, BN, t);
  }
  __syncthreads();  // su, qacc[0] and the ring's barriers
  float unused[BN / 32];
  float vq_acc = 0.f, vr1_acc = 0.f;
  for (int row = rowa; row < rowb; ++row) {
    float* qa = qacc[(row - rowa) & 1];
    const ShardLoad cur = next;
    if (t < BN) {
      const int64_t i = (int64_t)row * BN + t;
      const float w = __fmul_rn(
          __fsub_rn(__fsub_rn(cur.vprev, __fmul_rn(su[SU_OLDEPS], cur.wm2)),
                    __fmul_rn(su[SU_DELTA], cur.wm1)),
          su[SU_IGAMMA]);
      a.w[i] = w;
      a.xo[i] = __fadd_rn(cur.x, __fmul_rn(su[SU_PHI], w));
      // the other buffer, which this thread read last in the previous row,
      // is the next row's; this row's barrier orders both
      qacc[(row - rowa + 1) & 1][t] = 0.f;
      if (row + 1 < rowb) next.load(a, row0, row + 1, BN, t);
    }
    for (int k = 0; k < kmax; ++k) {
      const int64_t slot = (int64_t)row * kmax + k;
      ring.template apply_tile<true, false>(a.vfull + (int64_t)cols[slot] * BN, nullptr, qa,
                                            unused);
    }
    __syncthreads();  // the row's q is complete
    if (t < BN) {
      const int64_t i = (int64_t)row * BN + t;
      const float qv = __fsub_rn(qa[t], __fmul_rn(su[SU_SHIFT], cur.vw));
      a.q[i] = qv;
      vq_acc += cur.vw * qv;
      vr1_acc += cur.vw * cur.r1;
    }
    if (row + 1 == rowb || (row + 1) % R == 0) {  // the strip's last row
      const float2 s = block_sum2(vq_acc, vr1_acc, red);
      if (t == 0) {
        a.partials[row / R] = s.x;
        a.partials[nstrips + row / R] = s.y;
      }
      vq_acc = vr1_acc = 0.f;
    }
  }
  if (publish_last(a.counter)) {
    const float2 d = sum_partials2(a.partials, a.partials + nstrips, nstrips, red);
    if (t == 0) {
      a.dots[0] = d.x;
      a.dots[1] = d.y;
      *a.counter = 0u;
    }
  }
}

// ---- K2: r2' = q - c1 r1 - ia r2, bsq = r2'.(d r2') ------------------------
// Replaces minres_update_dot (fused_minres.py:425, _minres_update_kernel
// :398).  Bound: 4 (5 with d) vector streams of 4 n bytes, L2-resident at
// n = 262,144: about 1.3 microseconds, less than the chain of dependent
// round trips from launch to the scalar step.  Design: float4 grid-stride
// pass with at most 1024 CTAs (n % 4 == 0, which blocked-ELL lengths
// satisfy; the wrapper checks), per-CTA partials, and the last CTA does the
// solver's scalar step.  The chain is cut as in fused_cg.cu's K2: ctl[C_LIVE],
// c1, ia, the first float4s and (thread 0) every input of the scalar step are
// loaded at once, before the not-live return, and only thread 0 publishes
// (publish_last); the reduction tree and so every bit stay.  r2o may be any
// of the inputs: each element is read and written by one thread.
// scal == NULL is the partials-only mode of the row-sharded loop
// (parallel/loops.py): the last CTA writes this shard's bsq and stops; the
// scalar step runs after the sum over the shards.  ctl[C_LIVE] still makes
// a step after the end a no-op: nothing is written, the counter is not
// touched.

__device__ __forceinline__ float update_elem(float q, float r1, float r2, float c1,
                                             float ia) {
  return __fsub_rn(__fsub_rn(q, __fmul_rn(c1, r1)), __fmul_rn(ia, r2));
}

// One float4 of K2: r2', and r2'.(d r2') accumulated.
__device__ __forceinline__ void minres_update4(float c1, float ia, float4 qv, float4 av,
                                               float4 bv, float4 dv, bool has_d,
                                               float4& y, float& s) {
  y.x = update_elem(qv.x, av.x, bv.x, c1, ia);
  y.y = update_elem(qv.y, av.y, bv.y, c1, ia);
  y.z = update_elem(qv.z, av.z, bv.z, c1, ia);
  y.w = update_elem(qv.w, av.w, bv.w, c1, ia);
  if (has_d) {
    s = fmaf(__fmul_rn(dv.x, y.x), y.x, s); s = fmaf(__fmul_rn(dv.y, y.y), y.y, s);
    s = fmaf(__fmul_rn(dv.z, y.z), y.z, s); s = fmaf(__fmul_rn(dv.w, y.w), y.w, s);
  } else {
    s = fmaf(y.x, y.x, s); s = fmaf(y.y, y.y, s);
    s = fmaf(y.z, y.z, s); s = fmaf(y.w, y.w, s);
  }
}

// What K2's scalar step reads, loaded by thread 0 at the kernel's start
struct UpdateIn {
  float beta, dbar0, oldeps, phibar0, cs0, sn0, tol, alfa;
  int k, nan, maxiter;
};

__device__ UpdateIn load_update_in(const float* scal, const int* ctl) {
  UpdateIn in;
  in.beta = ld_now(scal + M_BETA); in.dbar0 = ld_now(scal + M_DBAR);
  in.oldeps = ld_now(scal + M_EPSLN); in.phibar0 = ld_now(scal + M_PHIBAR);
  in.cs0 = ld_now(scal + M_CS); in.sn0 = ld_now(scal + M_SN);
  in.tol = ld_now(scal + M_TOL); in.alfa = ld_now(scal + M_ALFA);
  in.k = ld_now(ctl + C_K); in.nan = ld_now(ctl + C_NAN); in.maxiter = ld_now(ctl + C_MAXITER);
  return in;
}

// K2's last CTA, thread 0 (solver/fused_minres.py's step after kernel 2)
__device__ void finish_update(float bsq, const UpdateIn& in, float* scal, int* ctl,
                              float* hist, int hist_len) {
  const float cs0 = in.cs0, sn0 = in.sn0, dbar0 = in.dbar0, alfa = in.alfa;
  const float beta_new = sqrtf(bsq);  // NaN iff M is not SPD
  const float delta = __fadd_rn(__fmul_rn(cs0, dbar0), __fmul_rn(sn0, alfa));
  const float gbar = __fsub_rn(__fmul_rn(sn0, dbar0), __fmul_rn(cs0, alfa));
  const float epsln_new = __fmul_rn(sn0, beta_new);
  const float dbar_new = __fmul_rn(-cs0, beta_new);
  float gamma = sqrtf(__fadd_rn(__fmul_rn(gbar, gbar), __fmul_rn(beta_new, beta_new)));
  if (!isnan(gamma)) gamma = fmaxf(gamma, 1.17549435e-38f);  // FLT_MIN; a NaN stays
  const float cs_new = gbar / gamma;
  const float sn_new = beta_new / gamma;
  const float phi = __fmul_rn(cs_new, in.phibar0);
  const float phibar_new = __fmul_rn(sn_new, in.phibar0);
  const int k = in.k + 1;
  ctl[C_K] = k;
  if (k < hist_len) hist[k] = phibar_new;
  const int is_nan = isnan(phibar_new) || isnan(beta_new);
  const int done = is_nan || phibar_new <= in.tol || beta_new == 0.f;
  ctl[C_NAN] = in.nan | is_nan;
  ctl[C_DONE] = done;
  ctl[C_LIVE] = !done && k < in.maxiter;
  scal[SU_OLDEPS] = in.oldeps;
  scal[SU_DELTA] = delta;
  scal[SU_IGAMMA] = 1.0f / gamma;
  scal[SU_PHI] = phi;
  scal[SU_INV_BETA] = 1.0f / beta_new;
  scal[M_OLDB] = in.beta;
  scal[M_BETA] = beta_new;
  scal[M_DBAR] = dbar_new;
  scal[M_EPSLN] = epsln_new;
  scal[M_PHIBAR] = phibar_new;
  scal[M_CS] = cs_new;
  scal[M_SN] = sn_new;
}

__global__ void __launch_bounds__(kThreads)
minres_update_kernel(const float* c1_p, const float* ia_p, const float* q,
                     const float* r1, const float* r2, const float* d, float* r2o,
                     float* bsq_out, float* partials, unsigned* counter, float* scal,
                     int* ctl, float* hist, int hist_len, int64_t n) {
  const int64_t n4 = n / 4, stride = (int64_t)gridDim.x * kThreads;
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* r14 = reinterpret_cast<const float4*>(r1);
  const float4* r24 = reinterpret_cast<const float4*>(r2);
  const float4* d4 = reinterpret_cast<const float4*>(d);
  float4* o4 = reinterpret_cast<float4*>(r2o);
  // every independent load at once; nothing is written before the live test
  const int live = ld_now(ctl + C_LIVE);
  const float c1 = ld_now(c1_p), ia = ld_now(ia_p);
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float4 qv, av, bv, dv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n4) {
    qv = ld_now(q4 + i); av = ld_now(r14 + i); bv = ld_now(r24 + i);
    if (d) dv = ld_now(d4 + i);
  }
  UpdateIn in{};
  if (scal && threadIdx.x == 0) in = load_update_in(scal, ctl);
  if (live == 0) return;
  float s = 0.f;
  float4 y;
  if (i < n4) {
    minres_update4(c1, ia, qv, av, bv, dv, d != nullptr, y, s);
    o4[i] = y;
    i += stride;
  }
  for (; i < n4; i += stride) {
    minres_update4(c1, ia, q4[i], r14[i], r24[i], d ? d4[i] : dv, d != nullptr, y, s);
    o4[i] = y;
  }
  __shared__ float red[kWarps];
  const float b = block_sum(s, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = b;
  if (!publish_last(counter)) return;
  const float bsq = sum_partials(partials, gridDim.x, red);
  if (threadIdx.x == 0) {
    bsq_out[0] = bsq;
    if (scal) finish_update(bsq, in, scal, ctl, hist, hist_len);
    *counter = 0u;
  }
}

template <int BN, class E>
cudaError_t launch_full(const E* blocks, const int* cols, const DirArgs& a, int nrb, int kmax,
                        int R, cudaStream_t s) {
  minres_full_kernel<BN, E><<<(nrb + R - 1) / R, kThreads, 0, s>>>(blocks, cols, a, nrb,
                                                                   kmax, R);
  return cudaGetLastError();
}

// ring stages of the banded K1 (0: ring_default_stages), set by
// minres_sym_dir_banded_stages for the ring-depth sweep of chip_smoke.py
int g_banded_stages = 0;

template <int BN, class E>
cudaError_t launch_banded(const E* diag, const E* off, const int* off_cols, const DirArgs& a,
                          int nrb, int R, cudaStream_t s) {
  static int cache[3] = {0, 0, 0};
  const int stages = g_banded_stages > 0 ? g_banded_stages : ring_default_stages<BN, E>();
  const int smem = ring_smem_bytes<BN, E>(stages);
  int grid = 0;
  cudaError_t e = ring_grid(minres_banded_kernel<BN, E>, smem, (nrb + R - 1) / R, cache,
                            grid);
  if (e != cudaSuccess) return e;
  minres_banded_kernel<BN, E><<<grid, kThreads, smem, s>>>(diag, off, off_cols, a, nrb, R,
                                                           stages);
  return cudaGetLastError();
}

template <int BN, class E>
cudaError_t launch_general(const E* diag, const E* off, const int* off_cols,
                           const int* mirror_src, const DirArgs& a, float* tparts,
                           int nrb, int ku, int kin, int R, cudaStream_t s) {
  minres_products_kernel<BN, E><<<nrb, kThreads, 0, s>>>(diag, off, off_cols, a, tparts,
                                                         nrb, ku);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  minres_land_kernel<BN><<<(nrb + R - 1) / R, kThreads, 0, s>>>(tparts, mirror_src, a,
                                                                nrb, kin, R);
  return cudaGetLastError();
}

// ring stages of the row-sharded K1 (0: ring_default_stages), set by
// minres_shard_dir_stages for the ring-depth sweep of chip_smoke.py
int g_shard_stages = 0;

template <int BN, class E>
cudaError_t launch_shard(const E* blocks, const int* cols, const ShardArgs& a,
                         int64_t row0, int nrb, int kmax, int R, cudaStream_t s) {
  static int cache[3] = {0, 0, 0};
  const int stages = g_shard_stages > 0 ? g_shard_stages : ring_default_stages<BN, E>();
  const int smem = ring_smem_bytes<BN, E>(stages);
  int grid = 0;
  cudaError_t e = ring_grid(minres_shard_kernel<BN, E>, smem, (nrb + R - 1) / R, cache, grid);
  if (e != cudaSuccess) return e;
  minres_shard_kernel<BN, E><<<grid, kThreads, smem, s>>>(blocks, cols, a, row0, nrb, kmax, R,
                                                          stages);
  return cudaGetLastError();
}

#define BN_SWITCH(call)                \
  switch (bn) {                        \
    case 32: return call(32);          \
    case 64: return call(64);          \
    case 128: return call(128);        \
    case 256: return call(256);        \
    default: return cudaErrorInvalidValue; \
  }

// The entry points' bodies, one per operator form; E is float or
// __nv_bfloat16.
template <class E>
int full_dir(const E* blocks, const int* cols, const DirArgs& a, int nrb, int kmax, int bn,
             int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(B) launch_full<B>(blocks, cols, a, nrb, kmax, R, s)
  BN_SWITCH(CALL)
#undef CALL
}

template <class E>
int sym_dir_banded(const E* diag, const E* off, const int* off_cols, const DirArgs& a, int nrb,
                   int bn, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(B) launch_banded<B>(diag, off, off_cols, a, nrb, R, s)
  BN_SWITCH(CALL)
#undef CALL
}

template <class E>
int sym_dir_general(const E* diag, const E* off, const int* off_cols, const int* mirror_src,
                    const DirArgs& a, float* tparts, int nrb, int ku, int kin, int bn, int R,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(B) launch_general<B>(diag, off, off_cols, mirror_src, a, tparts, nrb, ku, kin, R, s)
  BN_SWITCH(CALL)
#undef CALL
}

template <class E>
int dir_packed(const E* vals, const int* cols, const int* row_len, const long long* chunk_off,
               const DirArgs& a, int64_t rows, void* stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const int64_t grid = (rows + kThreads - 1) / kThreads;
  minres_dir_packed_kernel<E><<<(unsigned)grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(vals, cols, row_len,
                                                                     chunk_off, a, rows);
  return cudaGetLastError();
}

template <class E>
int shard_dir(const E* blocks, const int* cols, const ShardArgs& a, int64_t row0, int nrb,
              int kmax, int bn, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(B) launch_shard<B>(blocks, cols, a, row0, nrb, kmax, R, s)
  BN_SWITCH(CALL)
#undef CALL
}

}  // namespace

// the 18 vector, scalar and scratch pointers every K1 entry point takes, in
// DirArgs order
#define DIR_PARAMS                                                               \
  const float *r2, const float *r1, const float *vprev, const float *wm1,       \
      const float *wm2, const float *x, const float *d, const float *su,        \
      float *v, float *q, float *w, float *xo, float *vq, float *vr1,           \
      float *partials, unsigned *counter, float *scal, const int *ctl
#define DIR_ARGS \
  DirArgs { r2, r1, vprev, wm1, wm2, x, d, su, v, q, w, xo, vq, vr1, partials, counter, scal, ctl }
// the row-sharded K1's vectors, scratch and control, in ShardArgs order
#define SHARD_PARAMS                                                                 \
  const float *vfull, const float *r1, const float *vprev, const float *wm1,        \
      const float *wm2, const float *x, const float *su, float *q, float *w,        \
      float *xo, float *dots, float *partials, unsigned *counter, const int *ctl
#define SHARD_ARGS \
  ShardArgs { vfull, r1, vprev, wm1, wm2, x, su, q, w, xo, dots, partials, counter, ctl }

extern "C" {

// K1 on full blocked-ELL storage.  Returns a cudaError_t.
int minres_full_dir(const float* blocks, const int* cols, DIR_PARAMS, int nrb, int kmax,
                    int bn, int R, void* stream) {
  return full_dir(blocks, cols, DIR_ARGS, nrb, kmax, bn, R, stream);
}

// The same on bfloat16 tiles.
int minres_full_dir_bf16(const __nv_bfloat16* blocks, const int* cols, DIR_PARAMS, int nrb,
                         int kmax, int bn, int R, void* stream) {
  return full_dir(blocks, cols, DIR_ARGS, nrb, kmax, bn, R, stream);
}

// K1 on symmetric storage with the banded landing.
int minres_sym_dir_banded(const float* diag, const float* off, const int* off_cols,
                          DIR_PARAMS, int nrb, int bn, int R, void* stream) {
  return sym_dir_banded(diag, off, off_cols, DIR_ARGS, nrb, bn, R, stream);
}

// The same on bfloat16 tiles.
int minres_sym_dir_banded_bf16(const __nv_bfloat16* diag, const __nv_bfloat16* off,
                               const int* off_cols, DIR_PARAMS, int nrb, int bn, int R,
                               void* stream) {
  return sym_dir_banded(diag, off, off_cols, DIR_ARGS, nrb, bn, R, stream);
}

// Ring stages of the banded K1 from the next launch on (3 at least; 0 or
// less: the default, 96 KB of chunks).  Returns the previous setting.
int minres_sym_dir_banded_stages(int stages) {
  const int old = g_banded_stages;
  g_banded_stages = stages > 0 ? (stages < 3 ? 3 : stages) : 0;
  return old;
}

// K1 on symmetric storage with the general landing: stage A then stage B.
int minres_sym_dir_general(const float* diag, const float* off, const int* off_cols,
                           const int* mirror_src, DIR_PARAMS, float* tparts, int nrb,
                           int ku, int kin, int bn, int R, void* stream) {
  return sym_dir_general(diag, off, off_cols, mirror_src, DIR_ARGS, tparts, nrb, ku, kin, bn,
                         R, stream);
}

// The same on bfloat16 tiles.
int minres_sym_dir_general_bf16(const __nv_bfloat16* diag, const __nv_bfloat16* off,
                                const int* off_cols, const int* mirror_src, DIR_PARAMS,
                                float* tparts, int nrb, int ku, int kin, int bn, int R,
                                void* stream) {
  return sym_dir_general(diag, off, off_cols, mirror_src, DIR_ARGS, tparts, nrb, ku, kin, bn,
                         R, stream);
}

// K1 on the packed nonzeros of either storage; rows = nrb * bn.  Returns a
// cudaError_t.
int minres_dir_packed(const float* vals, const int* cols, const int* row_len,
                      const long long* chunk_off, DIR_PARAMS, int64_t rows, void* stream) {
  return dir_packed(vals, cols, row_len, chunk_off, DIR_ARGS, rows, stream);
}

// The same from bfloat16 values.
int minres_dir_packed_bf16(const __nv_bfloat16* vals, const int* cols, const int* row_len,
                           const long long* chunk_off, DIR_PARAMS, int64_t rows,
                           void* stream) {
  return dir_packed(vals, cols, row_len, chunk_off, DIR_ARGS, rows, stream);
}

// K1 of the row-sharded loop (row0 = row_offset / bn).  Returns a
// cudaError_t.
int minres_shard_dir(const float* blocks, const int* cols, SHARD_PARAMS, int64_t row0,
                     int nrb, int kmax, int bn, int R, void* stream) {
  return shard_dir(blocks, cols, SHARD_ARGS, row0, nrb, kmax, bn, R, stream);
}

// The same on bfloat16 tiles.
int minres_shard_dir_bf16(const __nv_bfloat16* blocks, const int* cols, SHARD_PARAMS,
                          int64_t row0, int nrb, int kmax, int bn, int R, void* stream) {
  return shard_dir(blocks, cols, SHARD_ARGS, row0, nrb, kmax, bn, R, stream);
}

// Ring stages of the row-sharded K1 from the next launch on (3 at least;
// 0 or less: the default, 96 KB of chunks).  Returns the previous setting.
int minres_shard_dir_stages(int stages) {
  const int old = g_shard_stages;
  g_shard_stages = stages > 0 ? (stages < 3 ? 3 : stages) : 0;
  return old;
}

// K2 (d == NULL: no preconditioner; scal == NULL: partials only).  n % 4
// == 0; every vector is 16-byte aligned (checked by the wrapper).
int minres_update(const float* c1, const float* ia, const float* q, const float* r1,
                  const float* r2, const float* d, float* r2o, float* bsq,
                  float* partials, unsigned* counter, float* scal, int* ctl,
                  float* hist, int hist_len, int64_t n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  minres_update_kernel<<<grid, kThreads, 0, s>>>(c1, ia, q, r1, r2, d, r2o, bsq,
                                                 partials, counter, scal, ctl, hist,
                                                 hist_len, n);
  return cudaGetLastError();
}

}  // extern "C"
