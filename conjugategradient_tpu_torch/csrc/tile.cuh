// Tile products shared by the fused blocked-ELL kernels (fused_cg.cu,
// fused_minres.cu, fused_bicgstab.cu): one (BN, BN) tile applied forward,
// mirrored, or both; and one row of the packed view of sparse tiles
// (bell_spmv.cu, fused_cg.cu, fused_bicgstab.cu).  Both take float32 or
// bfloat16 tile values E, each widened to float32 as it is loaded
// (common.cuh ld_stream / ld_ro); every product and sum is float32 in the
// same order for either E.  Last, TileRing: a tile stream staged through
// shared memory by bulk asynchronous copies, with the same products: the
// banded landings' (fused_cg.cu K1, fused_minres.cu K1; BandedStream) and
// the row-sharded kernels' slot stream (fused_cg.cu K6, fused_minres.cu
// K17; SlotStream).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

// One (BN, BN) row-major tile T.  Warp w takes rows m = w, w + kWarps, ...;
// lane l takes columns l + 32 j.  FWD: qacc[m] += sum_n T[m, n] xc[n]
// (written by lane 0 of the owning warp only, so tiles of one row chain
// without a barrier).  MIR: tacc[j] += sum_m T[m, l + 32 j] xr[m] over this
// warp's rows; the caller reduces tacc across warps.
template <int BN, bool FWD, bool MIR, class E = float>
__device__ __forceinline__ void tile_apply(const E* T, const float* xc,
                                           const float* xr, float* qacc,
                                           float (&tacc)[BN / 32]) {
  constexpr int NJ = BN / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float xcv[NJ];
  if (FWD) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) xcv[j] = xc[lane + 32 * j];
  }
#pragma unroll 4
  for (int m = w; m < BN; m += kWarps) {
    float v[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) v[j] = ld_stream(T + (int64_t)m * BN + lane + 32 * j);
    if (FWD) {
      float f = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) f = fmaf(v[j], xcv[j], f);
      f = warp_sum(f);
      if (lane == 0) qacc[m] += f;
    }
    if (MIR) {
      const float xm = xr[m];
#pragma unroll
      for (int j = 0; j < NJ; ++j) tacc[j] = fmaf(v[j], xm, tacc[j]);
    }
  }
}

// Cross-warp sum of the mirror partials into dst[t] (t < BN), warp order.
template <int BN>
__device__ __forceinline__ void mirror_reduce(const float (&tacc)[BN / 32],
                                              float (*red2)[BN], float* dst) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) red2[w][lane + 32 * j] = tacc[j];
  __syncthreads();
  for (int t = threadIdx.x; t < BN; t += kThreads) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += red2[i][t];
    dst[t] = s;
  }
}

// Row i of A y from the packed view (types/bell.py PackedBell: SELL-32,
// values and int32 global columns column-major within each 32-row chunk),
// y[c] = gather(c): the row's nonzeros in k order, one rounding per product
// and per sum (ops/cuda/bell_spmv.packed_apply's), four nonzeros' loads in
// flight.  Lane i % 32 of a warp takes row i, so a warp's loads of one k
// are one coalesced run.
template <class E, class Gather>
__device__ __forceinline__ float packed_row(const E* __restrict__ vals,
                                            const int* __restrict__ cols,
                                            const int* __restrict__ row_len,
                                            const long long* __restrict__ chunk_off,
                                            int64_t i, Gather gather) {
  const int len = __ldg(row_len + i);
  const int64_t base = __ldg(chunk_off + (i >> 5)) + (i & 31);
  const E* v = vals + base;
  const int* c = cols + base;
  float acc = 0.f;
  int k = 0;
  for (; k + 4 <= len; k += 4) {
    float vv[4], yy[4];
    int cc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      vv[u] = ld_ro(v + 32 * (k + u));
      cc[u] = __ldg(c + 32 * (k + u));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) yy[u] = gather(cc[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = add_rn(acc, mul_rn(vv[u], yy[u]));
  }
  for (; k < len; ++k) acc = add_rn(acc, mul_rn(ld_ro(v + 32 * k), gather(__ldg(c + 32 * k))));
  return acc;
}

// ---- the staged tile streams ------------------------------------------------
// A CTA of a banded kernel streams, in order, an optional halo tile (the
// upper tile of the row before its span: mirror only), then for each row of
// its span the diagonal tile (forward) and, unless the row's slot is
// padding, its upper tile (forward and mirror) (BandedStream).  A CTA of a
// row-sharded kernel streams each row's kmax tiles of full storage in slot
// order, padding slots included (SlotStream).  TileRing cuts each tile
// into chunks of kRows contiguous tile rows (16 KB, or the whole tile when
// it is smaller: bn = 256 in float32 is 256 KB, above what a CTA may hold)
// and keeps a ring of S chunk stages in dynamic shared memory full: thread
// 0 issues one cp.async.bulk (the 1-D form of TMA: one contiguous,
// 16-byte-aligned block, no tensor map) per chunk, with an L2 evict-first
// hint so the tile stream does not push the vectors out of L2, and each
// copy completes on its stage's "full" mbarrier.  The compute threads wait
// on it, read the chunk from shared memory in tile_apply's mapping (warp w
// takes the chunk's rows m = w, w + kWarps, ... in order, lane l the
// columns l + 32 j), widen a bf16 element as they read it, and each warp
// releases the stage on its "empty" mbarrier.  A warp sums the forward
// products of all its rows of a chunk at once (row_sums: warp_sum's
// butterfly tree for each row, with fewer shuffles).  Thread 0 refills a stage once
// all warps have released it, from inside its own compute loop: before it
// consumes chunk c it issues up to chunk c + S - 2, which waits only for the
// release of chunk c - 2.  So S - 2 chunks stay in flight ahead of the one
// being read, across the row barriers, rows and strips of the span, and a
// row's __syncthreads no longer drains the load pipe.  Every FMA, every
// addition of warp_sum's tree and every qacc / tacc update is
// tile_apply's, in its order, so the products carry tile_apply's bits.

template <int BN, class E>
struct TileChunk {
  static constexpr int kRowBytes = BN * (int)sizeof(E);
  static constexpr int kFit = (16 * 1024) / kRowBytes;
  static constexpr int kRows = kFit < BN ? kFit : BN;  // tile rows a chunk
  static constexpr int kBytes = kRows * kRowBytes;
  static constexpr int kPerTile = BN / kRows;
  static_assert(kRows % kWarps == 0 && BN % kRows == 0 && kBytes % 16 == 0, "chunk shape");
};

// default ring: 96 KB of chunks a CTA, so two CTAs of the largest tile
// width fit on an SM (2 x (96 + 13) KB of its 228 KB)
constexpr int kRingBytes = 96 * 1024;

// The ring's dynamic shared memory: 2 S mbarriers, then S chunk stages.
__host__ __device__ constexpr int ring_bar_bytes(int stages) {
  return (2 * stages * 8 + 127) / 128 * 128;
}
template <int BN, class E>
__host__ __device__ constexpr int ring_smem_bytes(int stages) {
  return ring_bar_bytes(stages) + stages * TileChunk<BN, E>::kBytes;
}
template <int BN, class E>
__host__ __device__ constexpr int ring_default_stages() {
  return kRingBytes / TileChunk<BN, E>::kBytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the phase of parity `parity`.  A wait that
// has not completed in 10 s (the global timer, read every 4096 polls)
// traps: a fault in the ring ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t polls = 1; !done; ++polls) {
    if ((polls & 4095u) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 10000000000ull) {
        __trap();
      }
    }
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

template <class E>
__device__ __forceinline__ float widen(E v);
template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// warp_sum of RW values at once (RW a power of two, at most 32): f[k] is
// lane l's partial of row k.  Each butterfly step of warp_sum (offsets 16,
// 8, 4, 2, 1, in order) adds, on lane l, lane l^o's partial of the same
// row to lane l's; here the first log2(RW) steps halve the rows a lane
// carries (the lane with bit o set keeps the upper half of its rows and
// sends the lower half to lane l^o, which keeps the lower half: both add
// their own partial to the partner's, which IEEE addition gives in either
// order), and the rest are warp_sum's own steps on the one row left.  So
// every row's sum is warp_sum's tree, bit for bit, with RW - 1 + 5 -
// log2(RW) shuffles in place of 5 RW.  Returns the row that f[0] now holds
// (the same on every lane of a group of 32 / RW lanes; bits of the lane).
template <int RW>
__device__ __forceinline__ int row_sums(float (&f)[RW]) {
  const int lane = threadIdx.x & 31;
  int row = 0;
  int n = RW;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (n > 1) {
      const int half = n / 2;
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < RW / 2; ++i) {
        if (i < half) {
          const float keep = up ? f[i + half] : f[i];
          const float send = up ? f[i] : f[i + half];
          f[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (up) row += half;
      n = half;
    } else {
      f[0] += __shfl_xor_sync(0xffffffffu, f[0], o);
    }
  }
  return row;
}

// The banded landings' stream (see above): the source of each chunk in
// turn, or null at the span's end.
template <int BN, class E>
struct BandedStream {
  using C = TileChunk<BN, E>;
  const E *diag, *off;
  const int* off_cols;
  int prow, pend, part, pci;  // part: 0 halo, 1 diagonal, 2 upper

  __device__ BandedStream(const E* diag_, const E* off_, const int* off_cols_, int row0,
                          int row1, bool halo)
      : diag(diag_),
        off(off_),
        off_cols(off_cols_),
        prow(halo ? row0 - 1 : row0),
        pend(row1),
        part(halo ? 0 : 1),
        pci(0) {}

  __device__ const E* next() {
    constexpr int64_t TT = (int64_t)BN * BN;
    if (part == 1 && prow >= pend) return nullptr;
    const E* tile = part == 1 ? diag + prow * TT : off + prow * TT;
    const E* src = tile + (int64_t)pci * C::kRows * BN;
    if (++pci == C::kPerTile) {
      pci = 0;
      if (part == 0) {
        part = 1;
        ++prow;
      } else if (part == 1 && off_cols[prow] != prow) {
        part = 2;
      } else {
        part = 1;
        ++prow;
      }
    }
    return src;
  }
};

// The row-sharded kernels' stream: full storage (nrb, kmax, BN, BN) keeps
// the kmax tiles of a block-row, and the rows of a span, contiguous, so the
// span [row0, row1) is one run of (row1 - row0) kmax tiles, cut in chunks.
template <int BN, class E>
struct SlotStream {
  using C = TileChunk<BN, E>;
  const E* src;
  int64_t left;  // chunks still to issue

  __device__ SlotStream(const E* blocks, int kmax, int row0, int row1)
      : src(blocks + (int64_t)row0 * kmax * BN * BN),
        left((int64_t)(row1 - row0) * kmax * C::kPerTile) {}

  __device__ const E* next() {
    if (left == 0) return nullptr;
    --left;
    const E* s = src;
    src += C::kRows * BN;
    return s;
  }
};

template <int BN, class E, class Stream = BandedStream<BN, E>>
struct TileRing {
  using C = TileChunk<BN, E>;
  static constexpr int NJ = BN / 32;
  static constexpr int RW = C::kRows / kWarps;  // a warp's rows in a chunk
  unsigned char* buf;
  uint64_t *full, *empty;
  int S;
  int stage = 0;        // the next chunk to read: its stage and phase
  unsigned phase = 0;
  Stream src;           // thread 0: the producer's place in the span's stream
  unsigned issued = 0, consumed = 0;
  uint64_t policy = 0;

  // Thread 0 initialises the barriers and issues the first S chunks; the
  // caller's next __syncthreads publishes the barriers to the other threads.
  __device__ TileRing(unsigned char* smem, int stages, const Stream& stream)
      : buf(smem + ring_bar_bytes(stages)),
        full(reinterpret_cast<uint64_t*>(smem)),
        empty(reinterpret_cast<uint64_t*>(smem) + stages),
        S(stages),
        src(stream) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < S; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
      produce(S);
    }
  }

  // Thread 0: wait for the chunks issued so far (before any is read), so
  // that a CTA which leaves early (a step after the end) leaves no copy in
  // flight into its shared memory.
  __device__ void drain() {
    if (threadIdx.x == 0) {
      for (unsigned i = 0; i < issued; ++i) mbar_wait(full + i, 0);
    }
  }

  // Thread 0: issue chunks until `upto` have been issued or the span ends.
  __device__ void produce(unsigned upto) {
    while (issued < upto) {
      const E* from = src.next();
      if (from == nullptr) return;
      const unsigned s = issued % S;
      if (issued >= (unsigned)S) mbar_wait(empty + s, (issued / S - 1) & 1);
      mbar_expect_tx(full + s, C::kBytes);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
          " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(buf + (size_t)s * C::kBytes)),
          "l"(from), "r"((unsigned)C::kBytes), "r"(smem_addr(full + s)), "l"(policy)
          : "memory");
      ++issued;
    }
  }

  // The next tile of the stream, applied as tile_apply<BN, FWD, MIR> would
  // apply it from device memory (xc: the forward operand; xr: the mirror's).
  template <bool FWD, bool MIR>
  __device__ __forceinline__ void apply_tile(const float* xc, const float* xr, float* qacc,
                                             float (&tacc)[NJ]) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    float xcv[NJ];
    if (FWD) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) xcv[j] = xc[lane + 32 * j];
    }
    for (int ci = 0; ci < C::kPerTile; ++ci) {
      if (threadIdx.x == 0) {
        const unsigned ahead = consumed + S - 1;
        produce(ahead > (unsigned)S ? ahead : (unsigned)S);
      }
      mbar_wait(full + stage, phase);
      const E* T = reinterpret_cast<const E*>(buf + (size_t)stage * C::kBytes);
      const int m0 = ci * C::kRows + w;  // this warp's rows: m0 + kWarps k
      float v[RW][NJ];
#pragma unroll
      for (int k = 0; k < RW; ++k) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          v[k][j] = widen<E>(T[(w + kWarps * k) * BN + lane + 32 * j]);
      }
      if (FWD) {
        float f[RW];
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          f[k] = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) f[k] = fmaf(v[k][j], xcv[j], f[k]);
        }
        const int k = row_sums<RW>(f);
        if ((lane & (32 / RW - 1)) == 0) qacc[m0 + kWarps * k] += f[0];
      }
      if (MIR) {
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          const float xm = xr[m0 + kWarps * k];
#pragma unroll
          for (int j = 0; j < NJ; ++j) tacc[j] = fmaf(v[k][j], xm, tacc[j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      ++consumed;
      if (++stage == S) {
        stage = 0;
        phase ^= 1u;
      }
    }
  }
};

// Host side of a ring-staged kernel: raise its dynamic shared memory limit
// to `smem` once, and size a persistent grid of at most as many CTAs as
// fit on the card at once, and never more than `nstrips`.  Each CTA then
// walks a contiguous span of strips (span_of).  Returns a cudaError_t;
// a kernel that cannot be resident at all is refused, never run otherwise.
// `cache` holds {the attribute set, the smem of `resident`, resident}.
template <class Kernel>
cudaError_t ring_grid(Kernel kernel, int smem, int nstrips, int (&cache)[3], int& grid) {
  int& set_smem = cache[0];
  int& resident = cache[2];
  if (smem > set_smem) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return e;
    set_smem = smem;
  }
  if (cache[1] != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
    cache[1] = smem;
  }
  grid = nstrips < resident ? nstrips : resident;
  return cudaSuccess;
}

// The strips [s0, s1) of CTA b of a grid of g over n strips: contiguous,
// in order, sizes differing by at most one.
__device__ __forceinline__ void span_of(int n, int& s0, int& s1) {
  s0 = (int)((int64_t)blockIdx.x * n / gridDim.x);
  s1 = (int)((int64_t)(blockIdx.x + 1) * n / gridDim.x);
}

}  // namespace
