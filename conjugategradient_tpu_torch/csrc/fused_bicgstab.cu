// Fused BiCGStab-iteration kernels for Hopper (sm_90a), bound through ctypes.
//
// Counterpart of conjugategradient_tpu/ops/pallas/fused_bicgstab.py.  One
// BiCGStab iteration is three passes over device memory:
//
//   K1  p' = r + beta (p - omega v);  p^ = d p' (Jacobi) or p';
//       v' = A p^;  rv = rhat . v'
//   K2  s = r - alpha v';  s^ = d s or s;  x_h = x + alpha p^;
//       t = A s^;  ss = s . s,  ts = t . s,  tt = t . t
//   K3  x' = x_h + omega s^;  r' = s - omega t;  rn = r' . r';  rho' = rhat . r'
//
// (A as full blocked-ELL tiles; the domain is nonsymmetric, so there is no
// symmetric storage here.)  Launch rules, tile products (tile.cuh) and the
// fixed-order two-stage dots are those of fused_cg.cu.  What the TPU kernels
// relied on and Hopper lacks, and what replaces it:
//
// * The g == 0 prologue formed p^ (K1) or s^ (K2) whole in VMEM once.  Here
//   the CTA that OWNS a block-row computes and stores that row's p' and p^
//   (K1) or s, s^ and x_h (K2), and every CTA RECOMPUTES each gathered row
//   p^[c] from r, p, v and d (K1) or s^[c] from r, v' and d (K2), with
//   __fmul_rn / __fsub_rn / __fadd_rn: bit-identical to the stored row and
//   to the plain version's torch ops.  A gathered row costs 3-4 reads of
//   4*bn bytes against a 4*bn*bn tile.
// * So the gathered vectors must not change during a pass: K1 never writes
//   r, p, v or d (p' and v' go into the other buffer of a double-buffered
//   pair), K2 never writes r, v' or d.  x_h goes into the other x buffer,
//   which keeps the previous x for the solver's breakdown select.  K3 is
//   elementwise and may write over any of its inputs.
// * Dots summed into one SMEM scalar across a sequential grid: here each
//   CTA writes its partials (one in K1, three in K2, two in K3), and the
//   last CTA to arrive (integer ticket) sums them in index order.  No float
//   atomics: every run gives the same bits.
// * The scalar steps between the kernels stay on the device, in the last
//   CTA of each kernel (finish_dir, finish_s, finish_update below, the same
//   steps as ops/cuda/fused_bicgstab.py's torch versions): alpha and its
//   clamp; the half-step test, omega and its clamp; the breakdown taxonomy,
//   k, hist[k], done, the sticky breakdown flag, live and the next beta.
//   Division and sqrtf round correctly (no fast-math) and products are
//   __fmul_rn.  isfinite is tested on the unclamped values, BEFORE any
//   clamp (fmaxf would drop a NaN where jnp.maximum keeps it).
// * Every kernel returns at once when ctl[C_LIVE] is 0.
//
// What bounds them on the H100: K1 and K2 stream the stored tiles once
// (402.7 MB at n = 262,144 block-tridiagonal, bn = 128; 671.1 MB for the
// 512 x 512 convection-diffusion operator) and 7-9 vectors (1 MB each there,
// L2-resident): memory bandwidth.  K3 streams 7 vectors.  Where the tiles
// are sparse (ops/spmv.bell_packed_route), K1 and K2 have packed forms that
// read the operator's nonzeros instead (bicg_dir_packed_kernel,
// bicg_s_packed_kernel below), with the same outputs and tails.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

// BicgstabWork.scal and .ctl (ops/cuda/fused_bicgstab.py keeps the same
// indices)
enum { B_RHO = 0, B_RHO_NEXT = 1, B_ALPHA = 2, B_OMEGA = 3, B_BETA = 4, B_BETA_C = 5,
       B_ALPHA_C = 6, B_OMEGA_C = 7, B_RNORM = 8, B_RNORM_PREV = 9, B_TOL = 10 };
constexpr int C_BROKE = 4, C_HALF = 5;  // after fused_cg's four control words

__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.f; }

// beta of the coming step, (rho_k / rho_{k-1}) (alpha / omega), and its clamp
__device__ void set_beta(float* scal, float rho_next) {
  const float beta = __fmul_rn(rho_next / scal[B_RHO], scal[B_ALPHA] / scal[B_OMEGA]);
  scal[B_BETA] = beta;
  scal[B_BETA_C] = finite_or_zero(beta);
}

// ---- K1 -------------------------------------------------------------------
// Replaces conjugategradient_tpu/ops/pallas/fused_bicgstab.py:bicgstab_dir_spmv_dot
// (:84, _dir_spmv_kernel :44-80).  Bound: the tile stream, 4 * bn^2 * kmax
// bytes per block-row, and 7 (8 with d) vectors.  Design: fused_cg.cu's
// full_dir_kernel: one CTA per strip of R block-rows, every slot read
// (padding tiles are zero and point at column block 0), tiles with
// streaming loads.

struct DirArgs {
  const float *r, *p, *v, *rhat, *d, *beta, *omega;
  float *pnew, *phat, *vout, *rv, *partials;
  unsigned* counter;
  float* scal;
  const int* ctl;
};

// p'[i] = r + beta (p - omega v): the plain version's four roundings
__device__ __forceinline__ float dir_elem(const DirArgs& a, float beta, float omega,
                                          int64_t i) {
  return __fadd_rn(a.r[i], __fmul_rn(beta, __fsub_rn(a.p[i], __fmul_rn(omega, a.v[i]))));
}

// p^[i] = d p'[i] or p'[i]: a gathered entry, bit-identical to the stored one
__device__ __forceinline__ float phat_elem(const DirArgs& a, float beta, float omega,
                                           int64_t i) {
  const float pn = dir_elem(a, beta, omega, i);
  return a.d ? __fmul_rn(a.d[i], pn) : pn;
}

// The owner's elementwise part of K1 for row i: p' and p^ stored
__device__ __forceinline__ void dir_own(const DirArgs& a, float beta, float omega, int64_t i) {
  const float pn = dir_elem(a, beta, omega, i);
  a.pnew[i] = pn;
  a.phat[i] = a.d ? __fmul_rn(a.d[i], pn) : pn;
}

// The end of K1 (tile or packed): this CTA's rv partial, and in the last
// CTA the sum of all partials in index order and the solver's step after
// K1: alpha = rho_k / rv and its clamp.
__device__ void finish_dir(float rv_acc, const DirArgs& a, float* red) {
  const float s = block_sum(rv_acc, red);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = s;
  if (arrive_last(a.counter)) {
    const float rv = sum_partials(a.partials, gridDim.x, red);
    if (threadIdx.x == 0) {
      a.rv[0] = rv;
      const float alpha = a.scal[B_RHO_NEXT] / rv;
      a.scal[B_ALPHA] = alpha;
      a.scal[B_ALPHA_C] = finite_or_zero(alpha);
      *a.counter = 0u;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
bicg_dir_kernel(const float* __restrict__ blocks, const int* __restrict__ cols, DirArgs a,
                int nrb, int kmax, int R) {
  if (a.ctl[C_LIVE] == 0) return;
  __shared__ float xc[BN], qacc[BN];
  __shared__ float red[kWarps];
  const float beta = *a.beta, omega = *a.omega;
  const int base = blockIdx.x * R;
  const int end = min(base + R, nrb);
  const int64_t TT = (int64_t)BN * BN;
  float unused[BN / 32];
  float rv_acc = 0.f;
  for (int row = base; row < end; ++row) {
    __syncthreads();  // the previous row's readers of qacc are done
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      dir_own(a, beta, omega, (int64_t)row * BN + t);
      qacc[t] = 0.f;
    }
    for (int k = 0; k < kmax; ++k) {
      const int64_t slot = (int64_t)row * kmax + k;
      __syncthreads();  // every warp is done reading xc
      const int64_t c0 = (int64_t)cols[slot] * BN;
      for (int t = threadIdx.x; t < BN; t += kThreads) xc[t] = phat_elem(a, beta, omega, c0 + t);
      __syncthreads();
      tile_apply<BN, true, false>(blocks + slot * TT, xc, nullptr, qacc, unused);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      const int64_t i = (int64_t)row * BN + t;
      a.vout[i] = qacc[t];
      rv_acc += a.rhat[i] * qacc[t];
    }
  }
  finish_dir(rv_acc, a, red);
}

// ---- K2 -------------------------------------------------------------------
// Replaces bicgstab_s_spmv_dot (fused_bicgstab.py:200, _s_spmv_kernel
// :155-196).  Bound: the tile stream and 8 (9 with d) vectors.  Design: K1's,
// with three dots; the owner keeps its row of s in shared memory for t . s.

struct SArgs {
  const float *r, *vnew, *x, *phat, *d, *alpha;
  float *s, *shat, *xh, *t, *ss, *ts, *tt, *partials;
  unsigned* counter;
  float* scal;
  int* ctl;
};

// s[i] = r - alpha v'[i]: the plain version's two roundings
__device__ __forceinline__ float s_elem(const SArgs& a, float alpha, int64_t i) {
  return __fsub_rn(a.r[i], __fmul_rn(alpha, a.vnew[i]));
}

// s^[i] = d s[i] or s[i]: a gathered entry, bit-identical to the stored one
__device__ __forceinline__ float shat_elem(const SArgs& a, float alpha, int64_t i) {
  const float s = s_elem(a, alpha, i);
  return a.d ? __fmul_rn(a.d[i], s) : s;
}

// The owner's elementwise part of K2 for row i: s, s^ and x_h stored; s returned
__device__ __forceinline__ float s_own(const SArgs& a, float alpha, int64_t i) {
  const float s = s_elem(a, alpha, i);
  a.s[i] = s;
  a.shat[i] = a.d ? __fmul_rn(a.d[i], s) : s;
  a.xh[i] = __fadd_rn(a.x[i], __fmul_rn(alpha, a.phat[i]));
  return s;
}

// The end of K2 (tile or packed): this CTA's three partials, and in the
// last CTA their sums in index order and the solver's step after K2: the
// half-step exit, omega and its clamp (0 on the half-step exit: K3 then
// returns x_h and s).
__device__ void finish_s(float ss_acc, float ts_acc, float tt_acc, const SArgs& a,
                         float* red) {
  const float b1 = block_sum(ss_acc, red);
  const float b2 = block_sum(ts_acc, red);
  const float b3 = block_sum(tt_acc, red);
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = b1;
    a.partials[gridDim.x + blockIdx.x] = b2;
    a.partials[2 * gridDim.x + blockIdx.x] = b3;
  }
  if (arrive_last(a.counter)) {
    const float ss = sum_partials(a.partials, gridDim.x, red);
    const float ts = sum_partials(a.partials + gridDim.x, gridDim.x, red);
    const float tt = sum_partials(a.partials + 2 * gridDim.x, gridDim.x, red);
    if (threadIdx.x == 0) {
      a.ss[0] = ss;
      a.ts[0] = ts;
      a.tt[0] = tt;
      const int half = sqrtf(ss) <= a.scal[B_TOL];
      const float omega = ts / tt;
      a.ctl[C_HALF] = half;
      a.scal[B_OMEGA] = omega;
      a.scal[B_OMEGA_C] = (isfinite(omega) && !half) ? omega : 0.f;
      *a.counter = 0u;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
bicg_s_kernel(const float* __restrict__ blocks, const int* __restrict__ cols, SArgs a,
              int nrb, int kmax, int R) {
  if (a.ctl[C_LIVE] == 0) return;
  __shared__ float xr[BN], xc[BN], qacc[BN];
  __shared__ float red[kWarps];
  const float alpha = *a.alpha;
  const int base = blockIdx.x * R;
  const int end = min(base + R, nrb);
  const int64_t TT = (int64_t)BN * BN;
  float unused[BN / 32];
  float ss_acc = 0.f, ts_acc = 0.f, tt_acc = 0.f;
  for (int row = base; row < end; ++row) {
    __syncthreads();  // the previous row's readers of xr and qacc are done
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      const float s = s_own(a, alpha, (int64_t)row * BN + t);
      xr[t] = s;
      ss_acc += s * s;
      qacc[t] = 0.f;
    }
    for (int k = 0; k < kmax; ++k) {
      const int64_t slot = (int64_t)row * kmax + k;
      __syncthreads();  // every warp is done reading xc
      const int64_t c0 = (int64_t)cols[slot] * BN;
      for (int t = threadIdx.x; t < BN; t += kThreads) xc[t] = shat_elem(a, alpha, c0 + t);
      __syncthreads();
      tile_apply<BN, true, false>(blocks + slot * TT, xc, nullptr, qacc, unused);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < BN; t += kThreads) {
      const float tv = qacc[t];
      a.t[(int64_t)row * BN + t] = tv;
      ts_acc += tv * xr[t];
      tt_acc += tv * tv;
    }
  }
  finish_s(ss_acc, ts_acc, tt_acc, a, red);
}

// ---- K1 and K2 on the packed nonzeros --------------------------------------
// Replace the same bicgstab_dir_spmv_dot (:84) and bicgstab_s_spmv_dot
// (:200) where the tiles are sparse: the same outputs and last-CTA steps,
// from the operator's packed view (types/bell.py PackedBell) instead of the
// tile stream.  Bound: the view's values and columns (8 bytes a stored
// entry) and row lengths, and the vectors, each read or written once: 7
// (K1; 8 with d) or 8 (K2; 9 with d).  On the 512 x 512 convection-
// diffusion operator that is 10.5 MB of values and columns and ~8 MB of
// vectors against the dense kernels' 671.1 MB of tiles (0.8% full).
// Design: fused_cg.cu's full_dir_packed_kernel: one lane per row and a warp
// per 32-row chunk (packed_row, tile.cuh).  The lane of row i stores its
// p' and p^ (K1) or s, s^ and x_h (K2); each gathered p^[c] is recomputed
// with phat_elem from r, p, v and d (K1), each s^[c] with shat_elem from r,
// v' and d (K2): four or three L2 reads in place of one, bit-identical to
// the stored value.  A row sums in k order with one rounding per product
// and per sum, as the plain version does, so v' and t match it bit for
// bit; the dots go through per-CTA partials that the last CTA sums in
// index order (finish_dir, finish_s: the dense kernels' own tails).

__global__ void __launch_bounds__(kThreads)
bicg_dir_packed_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                       const int* __restrict__ row_len,
                       const long long* __restrict__ chunk_off, DirArgs a, int64_t rows) {
  if (a.ctl[C_LIVE] == 0) return;
  __shared__ float red[kWarps];
  const float beta = *a.beta, omega = *a.omega;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float rv_acc = 0.f;
  if (i < rows) {
    dir_own(a, beta, omega, i);
    const float vi = packed_row(vals, cols, row_len, chunk_off, i,
                                [&](int c) { return phat_elem(a, beta, omega, c); });
    a.vout[i] = vi;
    rv_acc = a.rhat[i] * vi;
  }
  finish_dir(rv_acc, a, red);
}

__global__ void __launch_bounds__(kThreads)
bicg_s_packed_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                     const int* __restrict__ row_len,
                     const long long* __restrict__ chunk_off, SArgs a, int64_t rows) {
  if (a.ctl[C_LIVE] == 0) return;
  __shared__ float red[kWarps];
  const float alpha = *a.alpha;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float ss_acc = 0.f, ts_acc = 0.f, tt_acc = 0.f;
  if (i < rows) {
    const float s = s_own(a, alpha, i);
    const float ti = packed_row(vals, cols, row_len, chunk_off, i,
                                [&](int c) { return shat_elem(a, alpha, c); });
    a.t[i] = ti;
    ss_acc = s * s;
    ts_acc = ti * s;
    tt_acc = ti * ti;
  }
  finish_s(ss_acc, ts_acc, tt_acc, a, red);
}

// ---- K3 -------------------------------------------------------------------
// Replaces bicgstab_update_dot (fused_bicgstab.py:293, _update_kernel :274).
// Bound: 7 vector streams of 4 n bytes (x_h, s^, s, t, rhat in; x', r' out),
// L2-resident at n = 262,144.  Design: fused_cg.cu's update_kernel: float4
// grid-stride pass with at most 1024 CTAs, then the last n % 4 elements one
// by one, two partials per CTA, and the last CTA does the solver's step.
// Each element is read and written by one thread, so an output may lie on
// any input.

// K3's last CTA, thread 0 (solver/fused_bicgstab.py's step after K3)
__device__ void finish_update(float rn, float rho_pref, float* scal, int* ctl, float* hist,
                              int hist_len) {
  const float rnorm = sqrtf(rn);
  const float beta = scal[B_BETA], alpha = scal[B_ALPHA], omega = scal[B_OMEGA];
  const float rho_new = scal[B_RHO_NEXT], tol = scal[B_TOL];
  const int half = ctl[C_HALF];
  const int finite = isfinite(beta) && isfinite(alpha) && isfinite(omega) && isfinite(rnorm);
  const int converged = half || (finite && rnorm <= tol);
  const int broke = (!finite && !half) ||
                    (finite && (omega == 0.f || rho_new == 0.f) && !converged);
  const int k = ctl[C_K] + 1;
  ctl[C_K] = k;
  if (k < hist_len) hist[k] = rnorm;
  const int done = ctl[C_DONE] || converged || broke;
  ctl[C_DONE] = done;
  ctl[C_BROKE] = ctl[C_BROKE] | broke;
  ctl[C_LIVE] = !done && k < ctl[C_MAXITER];
  scal[B_RNORM_PREV] = scal[B_RNORM];
  scal[B_RNORM] = rnorm;
  scal[B_RHO] = rho_new;
  scal[B_RHO_NEXT] = rho_pref;
  set_beta(scal, rho_pref);
}

__device__ __forceinline__ void update_elem(float xh, float sh, float s, float t, float rh,
                                            float w, float& xo, float& ro, float& rn,
                                            float& rho) {
  xo = __fadd_rn(xh, __fmul_rn(w, sh));
  ro = __fsub_rn(s, __fmul_rn(w, t));
  rn = fmaf(ro, ro, rn);
  rho = fmaf(rh, ro, rho);
}

__global__ void __launch_bounds__(kThreads)
bicg_update_kernel(const float* omega_p, const float* xh, const float* shat, const float* s,
                   const float* t, const float* rhat, float* xo, float* ro, float* rn_out,
                   float* rho_out, float* partials, unsigned* counter, float* scal, int* ctl,
                   float* hist, int hist_len, int64_t n) {
  if (ctl[C_LIVE] == 0) return;
  __shared__ float red[kWarps];
  const float w = *omega_p;
  const int64_t n4 = n / 4;
  const float4* xh4 = reinterpret_cast<const float4*>(xh);
  const float4* sh4 = reinterpret_cast<const float4*>(shat);
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float4* t4 = reinterpret_cast<const float4*>(t);
  const float4* rh4 = reinterpret_cast<const float4*>(rhat);
  float4* xo4 = reinterpret_cast<float4*>(xo);
  float4* ro4 = reinterpret_cast<float4*>(ro);
  float rn = 0.f, rho = 0.f;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * kThreads) {
    const float4 a = xh4[i], b = sh4[i], c = s4[i], e = t4[i], f = rh4[i];
    float4 x, r;
    update_elem(a.x, b.x, c.x, e.x, f.x, w, x.x, r.x, rn, rho);
    update_elem(a.y, b.y, c.y, e.y, f.y, w, x.y, r.y, rn, rho);
    update_elem(a.z, b.z, c.z, e.z, f.z, w, x.z, r.z, rn, rho);
    update_elem(a.w, b.w, c.w, e.w, f.w, w, x.w, r.w, rn, rho);
    xo4[i] = x;
    ro4[i] = r;
  }
  // the scalar tail: at most 3 elements, one per thread of CTA 0
  const int64_t i = 4 * n4 + (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    float x, r;
    update_elem(xh[i], shat[i], s[i], t[i], rhat[i], w, x, r, rn, rho);
    xo[i] = x;
    ro[i] = r;
  }
  const float b1 = block_sum(rn, red);
  const float b2 = block_sum(rho, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = b1;
    partials[gridDim.x + blockIdx.x] = b2;
  }
  if (arrive_last(counter)) {
    const float rn_all = sum_partials(partials, gridDim.x, red);
    const float rho_all = sum_partials(partials + gridDim.x, gridDim.x, red);
    if (threadIdx.x == 0) {
      rn_out[0] = rn_all;
      rho_out[0] = rho_all;
      finish_update(rn_all, rho_all, scal, ctl, hist, hist_len);
      *counter = 0u;
    }
  }
}

template <int BN>
cudaError_t launch_dir(const float* blocks, const int* cols, const DirArgs& a, int nrb,
                       int kmax, int R, cudaStream_t s) {
  bicg_dir_kernel<BN><<<(nrb + R - 1) / R, kThreads, 0, s>>>(blocks, cols, a, nrb, kmax, R);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_s(const float* blocks, const int* cols, const SArgs& a, int nrb, int kmax,
                     int R, cudaStream_t s) {
  bicg_s_kernel<BN><<<(nrb + R - 1) / R, kThreads, 0, s>>>(blocks, cols, a, nrb, kmax, R);
  return cudaGetLastError();
}

}  // namespace

#define BN_SWITCH(call)                    \
  switch (bn) {                            \
    case 32: return call(32);              \
    case 64: return call(64);              \
    case 128: return call(128);            \
    case 256: return call(256);            \
    default: return cudaErrorInvalidValue; \
  }

extern "C" {

// K1 (d == NULL: no preconditioner).  Returns a cudaError_t.
int bicgstab_dir(const float* blocks, const int* cols, const float* r, const float* p,
                 const float* v, const float* rhat, const float* d, const float* beta,
                 const float* omega, float* pnew, float* phat, float* vout, float* rv,
                 float* partials, unsigned* counter, float* scal, const int* ctl, int nrb,
                 int kmax, int bn, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DirArgs a{r, p, v, rhat, d, beta, omega, pnew, phat, vout, rv, partials, counter,
                  scal, ctl};
#define CALL(B) launch_dir<B>(blocks, cols, a, nrb, kmax, R, s)
  BN_SWITCH(CALL)
#undef CALL
}

// K2 (d == NULL: no preconditioner).  Returns a cudaError_t.
int bicgstab_s(const float* blocks, const int* cols, const float* r, const float* vnew,
               const float* x, const float* phat, const float* d, const float* alpha,
               float* sv, float* shat, float* xh, float* t, float* ss, float* ts, float* tt,
               float* partials, unsigned* counter, float* scal, int* ctl, int nrb, int kmax,
               int bn, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SArgs a{r, vnew, x, phat, d, alpha, sv, shat, xh, t, ss, ts, tt, partials, counter,
                scal, ctl};
#define CALL(B) launch_s<B>(blocks, cols, a, nrb, kmax, R, s)
  BN_SWITCH(CALL)
#undef CALL
}

// K1 on the packed nonzeros (d == NULL: no preconditioner); rows = nrb * bn.
// Returns a cudaError_t.
int bicgstab_dir_packed(const float* vals, const int* cols, const int* row_len,
                        const long long* chunk_off, const float* r, const float* p,
                        const float* v, const float* rhat, const float* d, const float* beta,
                        const float* omega, float* pnew, float* phat, float* vout, float* rv,
                        float* partials, unsigned* counter, float* scal, const int* ctl,
                        int64_t rows, void* stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const DirArgs a{r, p, v, rhat, d, beta, omega, pnew, phat, vout, rv, partials, counter,
                  scal, ctl};
  const int64_t grid = (rows + kThreads - 1) / kThreads;
  bicg_dir_packed_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, cols, row_len, chunk_off, a, rows);
  return cudaGetLastError();
}

// K2 on the packed nonzeros (d == NULL: no preconditioner); rows = nrb * bn.
// Returns a cudaError_t.
int bicgstab_s_packed(const float* vals, const int* cols, const int* row_len,
                      const long long* chunk_off, const float* r, const float* vnew,
                      const float* x, const float* phat, const float* d, const float* alpha,
                      float* sv, float* shat, float* xh, float* t, float* ss, float* ts,
                      float* tt, float* partials, unsigned* counter, float* scal, int* ctl,
                      int64_t rows, void* stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const SArgs a{r, vnew, x, phat, d, alpha, sv, shat, xh, t, ss, ts, tt, partials, counter,
                scal, ctl};
  const int64_t grid = (rows + kThreads - 1) / kThreads;
  bicg_s_packed_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, cols, row_len, chunk_off, a, rows);
  return cudaGetLastError();
}

// K3.  n is any length; every vector is 16-byte aligned (checked by the
// wrapper).
int bicgstab_update(const float* omega, const float* xh, const float* shat, const float* sv,
                    const float* t, const float* rhat, float* xo, float* ro, float* rn,
                    float* rho, float* partials, unsigned* counter, float* scal, int* ctl,
                    float* hist, int hist_len, int64_t n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bicg_update_kernel<<<grid, kThreads, 0, s>>>(omega, xh, shat, sv, t, rhat, xo, ro, rn, rho,
                                               partials, counter, scal, ctl, hist, hist_len,
                                               n);
  return cudaGetLastError();
}

}  // extern "C"
