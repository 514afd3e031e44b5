// Mamba2 SSD chunked scan for Hopper (sm_90a): bf16 x, B, C; fp32 log-decay;
// fp32 states; bf16 y and final state.  The backward's two kernels
// (ssd_chunk_scan_bwd, ssd_chunk_state_bwd) follow the forward's, with
// their own note.
//
// Replaces the TPU kernels of src/repro/kernels/ssd_scan.py: _intra_kernel
// (the pl.pallas_call at :106), the host associative_scan over chunk states
// (:121-136) and _inter_kernel (the pl.pallas_call at :138).  Same function,
// per (batch b, head h, chunk c of Q = min(chunk, S) steps), with
// cum = inclusive cumsum of log_a over the chunk and total = cum[Q - 1]:
//
//   state_c  = sum_j exp(total - cum_j) x_j (x) B_j                (P, N)
//   prev_0   = initial state or 0;  prev_c+1 = prev_c exp(total_c) + state_c
//   y_i      = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x_j
//            + exp(cum_i) C_i . prev_c                             (P,)
//   final    = prev_C
//
// B and C of group h / (H / G) serve head h; nothing is repeated to H heads.
//
// What bounds it on an H100: at the mamba2-780m prefill shape (B 4, S 2048,
// H 48, P 64, N 128, Q 256) the function must move ~110 MB (x and y in
// bf16, B, C, log_a, the final state) and do ~20 GFLOP, so it is bound by
// bytes (~33 us).  Split in two kernels it also writes and reads the fp32
// states (50 MB each way), and each kernel alone is bound by bytes too:
// ssd_chunk_state by x and the states (~32 us), ssd_chunk_scan by x, y and
// the states (~47 us), the latter with as many tensor-core operations
// (~45 GFLOP with the hi + lo halves below, ~46 us at peak).  So both must
// stream their bytes at the memory's rate, with the tensor cores busy under
// the loads: TMA and wgmma.
//
// Two kernels, split where the work changes its shape:
// * ssd_chunk_state: one block of one warpgroup per (b, h, c) computes
//   state_c = (x o w)^T B by wgmma m64nNk16, w_j = exp(total - cum_j), and
//   hands the states along the chunks.  Thread 0 issues TMA loads of the
//   chunk's 64-row tiles of x and B into a 2-stage mbarrier ring (49 KB at
//   N 128), so three blocks share an SM and hide each other's latencies
//   (the ticket, the first loads, the hand-off).  A is (x o w)^T from
//   registers: ldmatrix.trans of the x tile, scaled, split into bf16 hi +
//   lo, two wgmmas; B is read N-major from shared memory through the
//   transpose flag.  P 16 is padded to the 64 rows of a wgmma by the x
//   map's zero fill, N 16 to 64 columns by the B map's.
// * The state pass is a chained hand-off (a decoupled look-back over the
//   chunks).  Each block takes its (b, h, c) from an atomic ticket, chunk
//   by chunk, so the block of chunk c - 1 took an earlier ticket and has
//   started before the block of chunk c can wait on it: no schedule of the
//   blocks can deadlock.  Block c computes state_c, then waits on chunk c's
//   flag (thread 0, ld.acquire.gpu, then a block barrier), reads prev_c
//   past L1 (written by another SM; L2 should still hold it), writes
//   prev_c+1 = prev_c exp(total_c) + state_c past L1, every thread fences
//   its stores (__threadfence), and thread 0 raises flag c + 1
//   (st.release.gpu after a block barrier); the block of chunk 0 writes
//   prev_0 and the last chunk's writes the final state.  The state goes
//   through shared memory first, so that prev is read and written in
//   coalesced float4s.  Each prev
//   is written once and read once; no sum uses atomics, so the result is
//   the same bits every run.
// * ssd_chunk_scan: one block per (b, c, h), heads fastest, so the blocks
//   that run together share one chunk of B and C in L2.  Three warpgroups:
//   one loads (one thread issues TMA loads of every tile of the chunk's C,
//   B and x, each tile on its own mbarrier, while the warpgroup computes
//   cum, then converts prev_c, read once with every load in flight, into
//   bf16 hi and lo tiles in shared memory, K-major); two consumers each own
//   64-row tiles of y, paired long with short (tiles w and T - 1 - w) so
//   that both do the same work.  A row tile t runs, for each key tile
//   u <= t: S = C_t . B_u^T by wgmma from shared memory, the decay masked
//   before the exponent in registers, S split into bf16 hi + lo A
//   fragments in registers, y += S x_u by wgmma with x read N-major (the
//   transpose flag): the scores never touch shared memory.  As in flash
//   attention, tile u's scores and tile u - 1's S x are issued together
//   and tile u's decay runs while S x is on the tensor cores.  Then the
//   inter-chunk term C_t . prev^T by wgmma from shared memory (hi, then
//   lo; prev_c's conversion has run under the intra-chunk term), its rows
//   scaled by exp(cum_i) into y.  y is rounded to bf16 into the row tile's
//   dead C buffer and stored by TMA, which clips rows past Q and columns
//   past P.  At 193 KB of shared memory (Q 256, N 128) one block fills an
//   SM.
//
// Tiles arrive through 5-D tensor maps with a chunk dimension, x and y as
// (P, H, Q, C, B), B and C as (N, G, Q, C, B), 64 x 64 boxes with the
// 128-byte swizzle: a box never runs into the next chunk, rows past Q come
// in as zeros, and every stride is read in place (B and C are views into the
// conv output).
//
// Precision.  C . B^T multiplies bf16 inputs, exact in fp32 sums.  The three
// products whose left operand is fp32 in the reference (scores * decay,
// x * exp(total - cum), and the state prev) split that operand into two
// bf16 parts, hi = bf16(v) and lo = bf16(v - hi), and run one product on
// each: about 16 bits of mantissa instead of bf16's 8, at twice the
// tensor-core work.
//
// The decay is masked before the exponent: the masked entries (j > i or
// j >= Q) have positive exponents and would overflow, so their exponents
// are -inf and their decay 0.  In chunk_scan the exponential is __expf
// (decay_scores), relative error ~2^-22.
//
// Any Q <= 256 is taken (rows past Q are zero-filled by the maps and
// masked), any (P, N) of SSD_DISPATCH.
//
// What still holds them back (PERF.md; scripts/ssd_ablations.py): at the
// mamba2 shape ssd_chunk_state runs at ~53% of its bound and
// ssd_chunk_scan at ~30%.  Without its intra-chunk products the scan still
// takes ~55% of its time: one block fills an SM, so a block's first loads,
// cum, prev_c's conversion and epilogue are hidden under no other block's
// products.  Left for later: a persistent scan that loads the next
// (b, c, h) under this one's products, one fused kernel that keeps x on
// chip between the two passes, and C . B^T computed once for the heads of
// a group.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).  Plain C
// interface, loaded with ctypes; the kernels allocate nothing.  The tensor
// maps are encoded on the host for every call (hopper.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kTile = 64;            // rows of a tile: one wgmma's M
constexpr int kBox = kTile * 128;    // bytes of a 64 x 64 bf16 box
constexpr int kMaxChunk = 256;       // Q: two rows a thread in chunk_cumsum
constexpr int kMaxTiles = kMaxChunk / kTile;
constexpr int kStateThreads = 128;   // ssd_chunk_state: one warpgroup,
constexpr int kStateStages = 2;      // a 2-stage ring of x and B tiles,
constexpr int kStateBlocks = 3;      // three blocks an SM (4: spills)
constexpr int kConsumers = 2;        // ssd_chunk_scan: consumer warpgroups
constexpr int kScanThreads = (kConsumers + 1) * 128;
constexpr int kLoaderBar = 3;        // named barrier of the loading warpgroup

// Head dim P and state dim N padded to the 64 columns of a box.
template <int P, int N>
struct Shape {
  static_assert(P % 16 == 0 && P <= 64 && N % 16 == 0 && N <= 128, "dims");
  static constexpr int kNPad = (N + 63) / 64 * 64;
  static constexpr int kNBoxes = kNPad / 64;
  // dynamic shared memory: the state kernel's ring, the scan kernel's
  // `tiles` row tiles (+ 1024 to align the boxes on the swizzle's
  // 1024-byte atoms)
  static constexpr int state_smem() {
    return kStateStages * (1 + kNBoxes) * kBox + 1024;
  }
  static constexpr int scan_smem(int tiles) {
    return (tiles * (2 * kNBoxes + 1) + 2 * kNBoxes) * kBox + 1024;
  }
};

struct Params {
  const float* la;          // (B, S, H), strides la_s*
  const float* init;        // (B, H, P, N) contiguous, or null: zeros
  float* states;            // (B, H, C, P, N) contiguous: prev_c
  bf16* final_state;        // (B, H, P, N) contiguous
  int* flags;               // (B, H, C) zeros: prev_c is written
  int* ticket;              // zero: the next block's (b, h, c)
  int batch, seq, heads, groups, q, n_chunks;
  int64_t la_sb, la_ss, la_sh;
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// (lo, hi) fp32 pair -> its bf16 part and the bf16 of the remainder.
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& big,
                                           uint32_t& small) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 hf = __bfloat1622float2(h);
  big = *reinterpret_cast<const uint32_t*>(&h);
  small = pack_bf16(lo - hf.x, hi - hf.y);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Byte offset of the 16-byte chunk `ch` (8 bf16 columns) of row `row` in a
// box of 128-byte rows with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swizzled(int row, int ch) {
  return row * 128 + ((ch ^ (row % 8)) * 16);
}

// cum[r] = la[0] + ... + la[r] for r < q (inclusive, fp32); rows past q
// count la = 0.  la is one head's column, `stride` floats between rows.
// Run by the 128 threads t of one warpgroup, two rows each (a shuffle scan
// over each warp, then the warps' totals); `bar` is their named barrier.
__device__ void chunk_cumsum(float* cum, float* warp_total, const float* la,
                             int64_t stride, int q, int t, int bar) {
  const int lane = t % 32;
  const int warp = t / 32;
  const float v0 = 2 * t < q ? la[(2 * t) * stride] : 0.f;
  const float v1 = 2 * t + 1 < q ? la[(2 * t + 1) * stride] : 0.f;
  float incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) warp_total[warp] = incl;
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += warp_total[w];
  cum[2 * t] = base + excl + v0;
  cum[2 * t + 1] = cum[2 * t] + v1;
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
}

// ---------------------------------------------------------------------------
// Kernel 1: chunk states and the chained hand-off.  One warpgroup a block;
// warp w owns state rows p in [16w, 16w + 16), all N columns: accumulator
// element 4j + r holds row 16w + lane / 4 (+ 8 for r >= 2), column
// 8j + 2 (lane % 4) (+ 1 for odd r).  The chunk's 64-row tiles of x and B
// go through a 2-stage ring (49 KB of shared memory at N 128), so three
// blocks share an SM and hide each other's latencies: the ticket, the
// first loads, the hand-off.
// ---------------------------------------------------------------------------
template <int P, int N>
__global__ void __launch_bounds__(kStateThreads, kStateBlocks)
    ssd_chunk_state_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_b,
                           const Params prm) {
  using S = Shape<P, N>;
  constexpr int kNB = S::kNBoxes;
  constexpr int kStage = (1 + kNB) * kBox;   // x, then B's boxes
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kStateStages];
  __shared__ float weight[kMaxChunk];
  __shared__ float warp_total[4];
  __shared__ int s_ticket;
  const uint32_t s_ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const int q = prm.q;
  const int tiles = (q + kTile - 1) / kTile;
  const int tid = threadIdx.x;

  if (tid == 0) {
    s_ticket = atomicAdd(prm.ticket, 1);
    for (int st = 0; st < kStateStages; ++st) mbar_init(smem_addr(&full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Tickets run chunk by chunk, the (b, h) pairs fastest.
  const int pairs = prm.batch * prm.heads;
  const int c = s_ticket / pairs;
  const int bh = s_ticket % pairs;
  const int b = bh / prm.heads;
  const int h = bh % prm.heads;
  const int g = h / (prm.heads / prm.groups);

  // tile t of x and B into stage t % 2 (thread 0 only)
  const auto load = [&](int t) {
    const uint32_t bar = smem_addr(&full[t % kStateStages]);
    const uint32_t dst = s_ring + (t % kStateStages) * kStage;
    mbar_expect_tx(bar, kStage);
    tma_load_5d(dst, &map_x, bar, 0, h, t * kTile, c, b);
    for (int nb = 0; nb < kNB; ++nb)
      tma_load_5d(dst + (1 + nb) * kBox, &map_b, bar, nb * 64, g, t * kTile, c, b);
  };
  if (tid == 0) {
    for (int t = 0; t < tiles && t < kStateStages; ++t) load(t);
  }

  chunk_cumsum(weight, warp_total,
               prm.la + b * prm.la_sb + static_cast<int64_t>(c) * q * prm.la_ss +
                   h * prm.la_sh,
               prm.la_ss, q, tid, 1);
  const float total = weight[q - 1];
  __syncthreads();  // every thread has read total before it is overwritten
  for (int j = tid; j < kMaxChunk; j += kStateThreads)
    weight[j] = j < q ? expf(total - weight[j]) : 0.f;
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  float acc[S::kNPad / 2];
#pragma unroll
  for (int i = 0; i < S::kNPad / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const uint32_t x_tile = s_ring + (t % kStateStages) * kStage;
    mbar_wait(smem_addr(&full[t % kStateStages]), (t / kStateStages) & 1);
    // A = (x o w)^T, rows p, k = j: transposed loads of the [j][p] tile;
    // lanes 8i .. 8i + 7 address matrix i: j + 8 (i / 2), p + 8 (i % 2)
    uint32_t a_hi[kTile / 16][4], a_lo[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const int row = kk * 16 + (lane / 16) * 8 + lane % 8;
      uint32_t a[4];
      ldmatrix_x4_trans(a, x_tile + swizzled(row, 2 * warp + (lane / 8) % 2));
      const int j = t * kTile + kk * 16 + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jr = j + (r / 2) * 8;  // registers 2, 3 hold k + 8
        const float2 v = unpack_bf16(a[r]);
        split_bf16(v.x * weight[jr], v.y * weight[jr + 1], a_hi[kk][r],
                   a_lo[kk][r]);
      }
    }
    // B: the [j][n] tile N-major (transpose flag); a 16-row slice starts
    // 16 rows down, 8-row atoms 1024 bytes apart, the next 64 columns the
    // next box
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t desc = smem_desc(x_tile + kBox + kk * 16 * 128, kBox, 1024);
      wgmma_rs(acc, a_hi[kk], desc);
      wgmma_rs(acc, a_lo[kk], desc);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(a_hi);
    fence_frag(a_lo);
    if (t + kStateStages < tiles) {
      __syncthreads();   // every warp is done with the stage
      if (tid == 0) load(t + kStateStages);
    }
  }

  // -- the hand-off: prev_c+1 = prev_c exp(total_c) + state_c --------------
  // state_c into shared memory (the ring is free now), rows of N + 4
  // floats (the padding spreads a warp's fragment stores over the banks),
  // then every thread takes float4s of the (P, N) state: coalesced loads and
  // stores, few registers.
  constexpr int kRow = N + 4;
  static_assert(P * kRow * 4 <= kStateStages * kStage, "state staging");
  float* st = reinterpret_cast<float*>(smem_raw + (s_ring - smem_addr(smem_raw)));
  __syncthreads();   // every warp is done with the ring
  {
    const int p0 = warp * 16 + lane / 4;
    const int n0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < S::kNPad / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + 8 * half;
        const int n = 8 * j + n0;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(st + p * kRow + n) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
  const int64_t slot = static_cast<int64_t>(P) * N;
  float* states = prm.states + static_cast<int64_t>(bh) * prm.n_chunks * slot;
  // prev_c: chunk 0's is the initial state (or zeros), which it also
  // writes as prev_0; any other's was written by the block of chunk c - 1
  const float* prev = c > 0 ? states + c * slot
                            : prm.init ? prm.init + bh * slot : nullptr;
  if (c > 0 && tid == 0) {
    const int* flag = prm.flags + static_cast<int64_t>(bh) * prm.n_chunks + c;
    while (ld_acquire(flag) == 0) __nanosleep(64);
  }
  __syncthreads();   // the staged state, and prev_c once the flag is up
  const float decay = expf(total);
  const bool last = c + 1 == prm.n_chunks;
  float* next = states + (c + 1) * slot;
  bf16* fin = prm.final_state + bh * slot;
  // every thread's loads of prev_c in flight at once (16 float4s at N 128)
  constexpr int kVec = (P * N + 4 * kStateThreads - 1) / (4 * kStateThreads);
  float4 pv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int e = 4 * (i * kStateThreads + tid);
    // written by another SM: read past L1
    pv[i] = prev && e < P * N ? __ldcg(reinterpret_cast<const float4*>(prev + e))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int e = 4 * (i * kStateThreads + tid);
    if (e >= P * N) break;
    const float4 v = pv[i];
    if (c == 0) *reinterpret_cast<float4*>(states + e) = v;
    const float4 sc = *reinterpret_cast<const float4*>(st + (e / N) * kRow + e % N);
    const float4 r = make_float4(fmaf(v.x, decay, sc.x), fmaf(v.y, decay, sc.y),
                                 fmaf(v.z, decay, sc.z), fmaf(v.w, decay, sc.w));
    if (!last) {
      __stcg(reinterpret_cast<float4*>(next + e), r);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(fin + e) = __floats2bfloat162_rn(r.x, r.y);
      *reinterpret_cast<__nv_bfloat162*>(fin + e + 2) = __floats2bfloat162_rn(r.z, r.w);
    }
  }
  if (!last) {
    __threadfence();   // this thread's part of prev_c+1 is visible on the device
    __syncthreads();   // ... and every thread's
    if (tid == 0)
      st_release(prm.flags + static_cast<int64_t>(bh) * prm.n_chunks + c + 1, 1);
  }
}

// S = C_t B_u^T for one key tile, issued (not waited for): both K-major (n),
// 8-row atoms 1024 bytes apart, a 16-deep slice 32 bytes along, the next 64
// columns the next box.
template <int kNB>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t c_tile,
                                             uint32_t b_tile) {
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, smem_desc(c_tile + nb * kBox + kk * 32, 16, 1024),
               smem_desc(b_tile + nb * kBox + kk * 32, 16, 1024),
               nb > 0 || kk > 0);
  }
}

// y += S x_u, S as hi + lo A fragments, issued (not waited for): x N-major
// (the transpose flag), a 16-key slice 16 rows down.
__device__ __forceinline__ void issue_sx(float (&y)[32],
                                         const uint32_t (&a_hi)[4][4],
                                         const uint32_t (&a_lo)[4][4],
                                         uint32_t x_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dx = smem_desc(x_tile + kk * 16 * 128, kBox, 1024);
    wgmma_rs(y, a_hi[kk], dx);
    wgmma_rs(y, a_lo[kk], dx);
  }
}

// s_ij <- s_ij exp(cum_i - cum_j) where j <= i and j < q, else 0: the
// decay masked before the exponent, branch-free (a masked exponent is -inf,
// whose exponential is 0; a branch around each element's exponent cost as
// much as the rest of the kernel).  The exponent is the special-function
// unit's (__expf: ex2.approx of the difference times log2 e, relative
// error ~2^-22, results below 2^-126 flushed to 0), far inside the ~16 bits
// that the hi + lo split keeps.  Accumulator element 4j + r holds row `row`
// (+ 8 for r >= 2) and key `key` + 8j (+ 1 for odd r).
__device__ __forceinline__ void decay_scores(float (&s)[32], const float* cum,
                                             int row, int key, int q) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row + 8 * (r / 2);
      const int kj = key + 8 * j + r % 2;
      const float e = kj <= i && kj < q ? cum[i] - cum[kj] : -INFINITY;
      s[4 * j + r] *= __expf(e);
    }
  }
}

// S as hi + lo bf16 A fragments: columns 16kk .. 16kk + 15 of the
// accumulator are the A fragment of the kk-th 16-key slice.
__device__ __forceinline__ void split_scores(const float (&s)[32],
                                             uint32_t (&a_hi)[4][4],
                                             uint32_t (&a_lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], a_hi[kk][i], a_lo[kk][i]);
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: outputs.  One block per (b, c, h); warpgroup 2 loads, 0 and 1
// compute 64-row tiles of y.  Shared memory (dynamic, 1024-aligned boxes):
// the chunk's C tiles, B tiles, x tiles, then prev_c's hi and lo parts.
// ---------------------------------------------------------------------------
template <int P, int N>
__global__ void __launch_bounds__(kScanThreads, 1)
    ssd_chunk_scan_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_b,
                          const __grid_constant__ CUtensorMap map_c,
                          const __grid_constant__ CUtensorMap map_y,
                          const Params prm) {
  using S = Shape<P, N>;
  constexpr int kNB = S::kNBoxes;
  constexpr int kNPad = S::kNPad;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kMaxTiles];   // tile t of C, B and x is in
  __shared__ uint64_t cum_ready;         // cum is in
  __shared__ uint64_t prev_ready;        // prev_c's hi and lo parts are in
  __shared__ float cum[kMaxChunk];
  __shared__ float warp_total[4];
  const int q = prm.q;
  const int tiles = (q + kTile - 1) / kTile;
  const uint32_t s_c = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_b = s_c + tiles * kNB * kBox;     // + (t kNB + box) kBox
  const uint32_t s_x = s_b + tiles * kNB * kBox;     // + t kBox
  const uint32_t s_hi = s_x + tiles * kBox;          // + box kBox
  const uint32_t s_lo = s_hi + kNB * kBox;

  // heads fastest: the blocks running together share a chunk of B and C
  const int h = blockIdx.x % prm.heads;
  const int c = (blockIdx.x / prm.heads) % prm.n_chunks;
  const int b = blockIdx.x / (prm.heads * prm.n_chunks);
  const int g = h / (prm.heads / prm.groups);
  const int64_t bh = static_cast<int64_t>(b) * prm.heads + h;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int t = 0; t < tiles; ++t) mbar_init(smem_addr(&full[t]), 1);
    mbar_init(smem_addr(&cum_ready), 128);
    mbar_init(smem_addr(&prev_ready), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == kConsumers) {
    // -- loads: TMA for the tiles, this warpgroup for cum and prev_c ---------
    const int t128 = tid % 128;
    if (t128 == 0) {
      for (int t = 0; t < tiles; ++t) {
        const uint32_t bar = smem_addr(&full[t]);
        mbar_expect_tx(bar, (2 * kNB + 1) * kBox);
        for (int nb = 0; nb < kNB; ++nb) {
          tma_load_5d(s_c + (t * kNB + nb) * kBox, &map_c, bar, nb * 64, g,
                      t * kTile, c, b);
          tma_load_5d(s_b + (t * kNB + nb) * kBox, &map_b, bar, nb * 64, g,
                      t * kTile, c, b);
        }
        tma_load_5d(s_x + t * kBox, &map_x, bar, 0, h, t * kTile, c, b);
      }
    }
    chunk_cumsum(cum, warp_total,
                 prm.la + b * prm.la_sb + static_cast<int64_t>(c) * q * prm.la_ss +
                     h * prm.la_sh,
                 prm.la_ss, q, t128, kLoaderBar);
    mbar_arrive(smem_addr(&cum_ready));
    // prev_c (P, N) fp32 -> bf16 hi and lo, [p][n] K-major boxes of 64
    // rows (p, zero past P) x 64 columns (n, zero past N: C's columns there
    // are zeros, and 0 x garbage could be nan).  Every load is issued
    // before the first is used.
    constexpr int kItems = 64 * kNPad / 8 / 128;   // 8 floats a thread each
    const float* prev = prm.states + (bh * prm.n_chunks + c) * P * N;
    float4 v[kItems][2];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = i * 128 + t128;
      const int p = e / (kNPad / 8);
      const int n = (e % (kNPad / 8)) * 8;
      v[i][0] = v[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < P && n < N) {
        v[i][0] = *reinterpret_cast<const float4*>(prev + p * N + n);
        v[i][1] = *reinterpret_cast<const float4*>(prev + p * N + n + 4);
      }
    }
    unsigned char* smem = smem_raw + (s_hi - smem_addr(smem_raw));
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = i * 128 + t128;
      const int p = e / (kNPad / 8);
      const int n = (e % (kNPad / 8)) * 8;
      uint4 hi, lo;
      split_bf16(v[i][0].x, v[i][0].y, hi.x, lo.x);
      split_bf16(v[i][0].z, v[i][0].w, hi.y, lo.y);
      split_bf16(v[i][1].x, v[i][1].y, hi.z, lo.z);
      split_bf16(v[i][1].z, v[i][1].w, hi.w, lo.w);
      const uint32_t off = (n / 64) * kBox + swizzled(p, (n % 64) / 8);
      *reinterpret_cast<uint4*>(smem + off) = hi;
      *reinterpret_cast<uint4*>(smem + kNB * kBox + off) = lo;
    }
    fence_async_shared();   // the wgmmas read what these threads wrote
    mbar_arrive(smem_addr(&prev_ready));
  } else {
    // -- consumers: warpgroup wg owns row tiles wg and T - 1 - wg -------------
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int col = 2 * (lane % 4);
    // long with short: T 4 -> {0, 3}, {1, 2}; T 3 -> {0, 2}, {1}; T 2 ->
    // {0}, {1}; T 1 -> {0}, {}
    const int count = (wg < tiles) + (tiles - 1 - wg >= kConsumers);
    mbar_wait(smem_addr(&cum_ready), 0);
    for (int k = 0; k < count; ++k) {
      const int t = k == 0 ? wg : tiles - 1 - wg;
      const uint32_t c_t = s_c + t * kNB * kBox;
      // accumulator element 4j + r holds row `row` (+ 8 for r >= 2) of the
      // chunk and column 8j + col (+ 1 for odd r)
      const int row = t * kTile + warp * 16 + lane / 4;
      float y[32], s[32];
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] = 0.f;

      // Intra-chunk term over the key tiles up to the diagonal.  The
      // products of key tile u's scores and tile u - 1's S x are issued
      // together, and tile u's decay runs while S x is on the tensor cores.
      mbar_wait(smem_addr(&full[t]), 0);   // C_t
      mbar_wait(smem_addr(&full[0]), 0);
      fence_acc(s);
      wgmma_fence();
      issue_scores<kNB>(s, c_t, s_b);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      decay_scores(s, cum, row, col, q);
      split_scores(s, a_hi, a_lo);
      for (int u = 1; u <= t; ++u) {
        mbar_wait(smem_addr(&full[u]), 0);
        fence_acc(s);
        wgmma_fence();
        issue_scores<kNB>(s, c_t, s_b + u * kNB * kBox);
        wgmma_commit();
        fence_acc(y);
        wgmma_fence();
        issue_sx(y, a_hi, a_lo, s_x + (u - 1) * kBox);
        wgmma_commit();
        wgmma_wait<1>();   // the scores are done, S x may still run
        fence_acc(s);
        decay_scores(s, cum, row, u * kTile + col, q);
        wgmma_wait<0>();
        fence_acc(y);
        fence_frag(a_hi);
        fence_frag(a_lo);
        split_scores(s, a_hi, a_lo);
      }
      fence_acc(y);
      wgmma_fence();
      issue_sx(y, a_hi, a_lo, s_x + t * kBox);
      wgmma_commit();

      // Inter-chunk term: (C_t prev^T) exp(cum_i), prev as hi + lo, into s
      // while the last S x runs; C_t and prev both K-major (n).
      mbar_wait(smem_addr(&prev_ready), 0);
      fence_acc(s);
      wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = smem_desc(c_t + nb * kBox + kk * 32, 16, 1024);
          wgmma_ss(s, da, smem_desc(s_hi + nb * kBox + kk * 32, 16, 1024),
                   nb > 0 || kk > 0);
          wgmma_ss(s, da, smem_desc(s_lo + nb * kBox + kk * 32, 16, 1024), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(y);
      fence_acc(s);
      fence_frag(a_hi);
      fence_frag(a_lo);
      // rows past q read cum[q..], which hold cum[q - 1]: finite
      const float ea = expf(cum[row]);
      const float eb = expf(cum[row + 8]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[4 * j] += s[4 * j] * ea;
        y[4 * j + 1] += s[4 * j + 1] * ea;
        y[4 * j + 2] += s[4 * j + 2] * eb;
        y[4 * j + 3] += s[4 * j + 3] * eb;
      }

      // Epilogue: y in bf16 into C_t's first box (dead now), laid out as
      // the TMA store reads it, then one store, clipped at Q and P.
      warpgroup_sync(1 + wg);   // every warp's products are done with C_t
      unsigned char* out = smem_raw + (c_t - smem_addr(smem_raw));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = warp * 16 + lane / 4 + 8 * half;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + swizzled(rr, j) + (lane % 4) * 4) =
              __floats2bfloat162_rn(y[4 * j + 2 * half], y[4 * j + 2 * half + 1]);
      }
      fence_async_shared();
      warpgroup_sync(1 + wg);
      if (tid % 128 == 0) {
        tma_store_5d(&map_y, c_t, 0, h, t * kTile, c, b);
        bulk_commit();
      }
    }
    if (tid % 128 == 0) bulk_wait_read();   // the stores have read the buffers
  }
}

// ---------------------------------------------------------------------------
// The backward: two kernels that replace no Pallas kernel: they replace the
// XLA autodiff through which the reference differentiates its SSD
// (repro.kernels.ssd_scan, repro.models.ssm.ssd_chunked).  Scalar fp32 bodies over tiles of
// 64 rows in shared memory, each thread owning a 4 x 4 (or 4 x N/16) patch
// of every product: simple and right first; tensor cores are for a later
// version.  Per (b, h, c), with S_ij = (C_i . B_j) exp(cum_i - cum_j) for
// j <= i, dS_ij = dy_i . x_j and T = cum[Q - 1]:
//
// ssd_chunk_scan_bwd, one block per (b, c, h), heads fastest:
//   dx_j   = sum_i S_ij dy_i                      (the intra term's part)
//   dC_i   = sum_j dS_ij e_ij B_j + exp(cum_i) prev_c^T dy_i
//   dB_j   = sum_i dS_ij e_ij C_i                 (per head: fp32, B, S, H, N)
//   dcum_i = sum_j S_ij dS_ij - sum_i' S_i'i dS_i'i + exp(cum_i) dy_i.(prev_c C_i)
//   dprev_c = sum_i exp(cum_i) dy_i (x) C_i
// Phase A walks the row tiles I (dC_I, dcum's row sums, the inter term,
// dprev), phase B the key tiles J (dx_J, dB_J, dcum's column sums): S and
// dS of a tile pair are computed in both, so no sum needs atomics.
//
// ssd_chunk_state_bwd, one block per (b, h, c), tickets in reverse chunk
// order: the state pass in reverse, G_C = dfinal (or 0), G_c = dprev_c +
// exp(T_c) G_c+1, written over dprev_c (so dprev_0 becomes the initial
// state's gradient) and handed to chunk c - 1 by the chained hand-off of
// the forward (flag c raised after G_c is written; chunk c's block took its
// ticket after chunk c + 1's).  Then, with w_j = exp(T - cum_j) and
// G = G_c+1: dx_j += w_j G B_j, dB_j += w_j G^T x_j, dcum_j -= w_j x_j^T G
// B_j, and dcum[Q - 1] += exp(T) <prev_c, G> + sum_j w_j x_j^T G B_j.
//
// dx, dB, dC, dcum and dprev are fp32; the wrapper sums dB and dC over the
// heads of a group, turns dcum into dlog_a (a reverse cumsum within each
// chunk) and rounds dx to bf16: torch glue (ssd_scan.py, _bwd_finish).
// Every sum runs in a fixed order: the same bits every run.
//
// What bounds them: the function is bound by bytes (at the mamba2-780m
// training shape ~0.2 ms each on an H100: the per-head fp32 dB and dC, the
// states and their gradients; chip_smoke.py ssd_bwd_floor_ms).  These
// bodies are bound instead by the CUDA cores and shared memory: the scan's
// backward does ~100 GFLOP of fp32 FMAs there (S and dS twice, ~33 M FMAs
// per (b, h, c)) with two to three FMAs per shared-memory load and one
// 151 KB block an SM.  wgmma for the five products, S and dS computed
// once, is the way to the bound.
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 256;

template <int P, int N>
struct BwdShape {
  static constexpr int kLdN = N + 1;     // padded rows: no bank conflicts
  static constexpr int kLdP = P + 1;
  static constexpr int kLdT = kTile + 1;
  static constexpr int kCn = N / 16;     // columns a thread owns, of N
  static constexpr int kCp = P / 16;     // ... of P
  static constexpr int scan_bytes() {
    return 4 * (2 * kTile * kLdN + 2 * kTile * kLdP + 3 * kTile * kLdT +
                2 * kMaxChunk);
  }
  static constexpr int state_bytes() {
    return 4 * (P * kLdN + kTile * kLdP + kTile * kLdN + kMaxChunk);
  }
};

struct BwdParams {
  const bf16* x;
  const bf16* b;
  const bf16* c;
  const bf16* dy;           // (B, S, H, P) contiguous
  const float* la;
  const float* prev;        // (B, H, C, P, N): the forward's states
  const float* dfinal;      // (B, H, P, N) contiguous, or null: zeros
  float* dx;                // (B, S, H, P)
  float* db;                // (B, S, H, N), per head
  float* dc;                // (B, S, H, N), per head
  float* dprev;             // (B, H, C, P, N): dprev_c, then G_c
  float* dcum;              // (B, S, H)
  int* flags;               // (B, H, C) zeros: G_c is written
  int* ticket;              // zero
  int batch, seq, heads, groups, q, n_chunks;
  int64_t x_s[3], la_s[3], b_s[3], c_s[3];
};

// Rows [r0, r0 + 64) of a chunk's (Q, COLS) slab of a bf16 tensor (element
// (r, col) at base[r * row_stride + col]) into fp32 rows of `ld` floats;
// rows past q are zeros.
template <int COLS>
__device__ void load_rows(float* dst, int ld, const bf16* base,
                          int64_t row_stride, int r0, int q) {
  for (int e = threadIdx.x; e < kTile * COLS; e += kBwdThreads) {
    const int r = e / COLS, col = e % COLS;
    dst[r * ld + col] = r0 + r < q
        ? __bfloat162float(base[(r0 + r) * row_stride + col]) : 0.f;
  }
}

// Sum over the 16 lanes of a half warp (the threads of one row of patches).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v, the same on every thread, in a fixed order.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kBwdThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <int P, int N>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_chunk_scan_bwd_kernel(const BwdParams prm) {
  using S = BwdShape<P, N>;
  constexpr int kLdN = S::kLdN, kLdP = S::kLdP, kLdT = S::kLdT;
  constexpr int kCn = S::kCn, kCp = S::kCp;
  extern __shared__ float sm[];
  float* c_t = sm;                        // C of row tile I, [i][n]
  float* b_t = c_t + kTile * kLdN;        // B of key tile J [j][n]; prev [p][n]
  float* dy_t = b_t + kTile * kLdN;       // dy of row tile I, [i][p]
  float* x_t = dy_t + kTile * kLdP;       // x of key tile J, [j][p]
  float* s_t = x_t + kTile * kLdP;        // S_ij, [i][j]
  float* a_t = s_t + kTile * kLdT;        // dS_ij e_ij
  float* r_t = a_t + kTile * kLdT;        // S_ij dS_ij
  float* cum = r_t + kTile * kLdT;        // [kMaxChunk]
  float* dcum = cum + kMaxChunk;          // [kMaxChunk]
  __shared__ float warp_total[4];

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;   // the thread's patch
  const int h = blockIdx.x % prm.heads;
  const int c = (blockIdx.x / prm.heads) % prm.n_chunks;
  const int b = blockIdx.x / (prm.heads * prm.n_chunks);
  const int g = h / (prm.heads / prm.groups);
  const int q = prm.q;
  const int tiles = (q + kTile - 1) / kTile;
  const int64_t row0 = static_cast<int64_t>(c) * q;
  const int64_t bs = static_cast<int64_t>(b) * prm.seq + row0;   // (b, row 0)
  const int64_t hp = static_cast<int64_t>(prm.heads) * P;
  const int64_t hn = static_cast<int64_t>(prm.heads) * N;
  const bf16* xg = prm.x + b * prm.x_s[0] + row0 * prm.x_s[1] + h * prm.x_s[2];
  const bf16* bg = prm.b + b * prm.b_s[0] + row0 * prm.b_s[1] + g * prm.b_s[2];
  const bf16* cg = prm.c + b * prm.c_s[0] + row0 * prm.c_s[1] + g * prm.c_s[2];
  const bf16* dyg = prm.dy + bs * hp + h * P;
  const int64_t slot = (static_cast<int64_t>(b) * prm.heads + h) * prm.n_chunks + c;

  if (tid < 128)
    chunk_cumsum(cum, warp_total,
                 prm.la + b * prm.la_s[0] + row0 * prm.la_s[1] + h * prm.la_s[2],
                 prm.la_s[1], q, tid, 1);
  for (int i = tid; i < kMaxChunk; i += kBwdThreads) dcum[i] = 0.f;
  __syncthreads();

  // S, dS e and S dS of row tile I against key tile J (c_t, dy_t, b_t, x_t
  // loaded), each thread its rows ti + 16a, columns tj + 16k
  const auto pair = [&](int I, int J) {
    float cb[4][4] = {}, ds[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float cr[4], br[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cr[a] = c_t[(ti + 16 * a) * kLdN + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) br[k] = b_t[(tj + 16 * k) * kLdN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) cb[a][k] = fmaf(cr[a], br[k], cb[a][k]);
    }
    for (int p = 0; p < P; ++p) {
      float dr[4], xr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dr[a] = dy_t[(ti + 16 * a) * kLdP + p];
#pragma unroll
      for (int k = 0; k < 4; ++k) xr[k] = x_t[(tj + 16 * k) * kLdP + p];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) ds[a][k] = fmaf(dr[a], xr[k], ds[a][k]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = ti + 16 * a, j = tj + 16 * k;
        const int gi = I * kTile + i, gj = J * kTile + j;
        // masked before the exponent: j > i would overflow
        const float e = gj <= gi && gi < q ? expf(cum[gi] - cum[gj]) : 0.f;
        const float sv = cb[a][k] * e;
        s_t[i * kLdT + j] = sv;
        a_t[i * kLdT + j] = ds[a][k] * e;
        r_t[i * kLdT + j] = sv * ds[a][k];
      }
  };

  // -- phase A: row tiles ---------------------------------------------------
  float dprev[kCp][kCn] = {};   // rows p = ti + 16a, columns n = tj + 16k
  for (int I = 0; I < tiles; ++I) {
    __syncthreads();   // c_t, dy_t free
    load_rows<N>(c_t, kLdN, cg, prm.c_s[1], I * kTile, q);
    load_rows<P>(dy_t, kLdP, dyg, hp, I * kTile, q);
    float dc[4][kCn] = {};
    for (int J = 0; J <= I; ++J) {
      __syncthreads();   // b_t, x_t and the pair's tiles free
      load_rows<N>(b_t, kLdN, bg, prm.b_s[1], J * kTile, q);
      load_rows<P>(x_t, kLdP, xg, prm.x_s[1], J * kTile, q);
      __syncthreads();
      pair(I, J);
      __syncthreads();
      for (int j = 0; j < kTile; ++j) {
        float ar[4], br[kCn];
#pragma unroll
        for (int a = 0; a < 4; ++a) ar[a] = a_t[(ti + 16 * a) * kLdT + j];
#pragma unroll
        for (int k = 0; k < kCn; ++k) br[k] = b_t[j * kLdN + tj + 16 * k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < kCn; ++k) dc[a][k] = fmaf(ar[a], br[k], dc[a][k]);
      }
      if (tid < kTile) {
        float sum = 0.f;
        for (int j = 0; j < kTile; ++j) sum += r_t[tid * kLdT + j];
        dcum[I * kTile + tid] += sum;
      }
    }
    __syncthreads();   // b_t free, dcum's row sums done
    // the inter term: u_i = exp(cum_i) prev_c^T dy_i
    const float* prev = prm.prev + slot * P * N;
    for (int e = tid; e < P * N; e += kBwdThreads)
      b_t[(e / N) * kLdN + e % N] = prev[e];
    __syncthreads();
    float u[4][kCn] = {};
    for (int p = 0; p < P; ++p) {
      float dr[4], pr[kCn];
#pragma unroll
      for (int a = 0; a < 4; ++a) dr[a] = dy_t[(ti + 16 * a) * kLdP + p];
#pragma unroll
      for (int k = 0; k < kCn; ++k) pr[k] = b_t[p * kLdN + tj + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < kCn; ++k) u[a][k] = fmaf(dr[a], pr[k], u[a][k]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + 16 * a, gi = I * kTile + i;
      const float ec = gi < q ? expf(cum[gi]) : 0.f;
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < kCn; ++k) {
        const float uv = u[a][k] * ec;
        dc[a][k] += uv;
        part = fmaf(uv, c_t[i * kLdN + tj + 16 * k], part);
      }
      part = half_warp_sum(part);
      if (tj == 0 && gi < q) dcum[gi] += part;
      if (gi < q) {
        float* out = prm.dc + (bs + gi) * hn + h * N;
#pragma unroll
        for (int k = 0; k < kCn; ++k) out[tj + 16 * k] = dc[a][k];
      }
    }
    // dprev_c += sum_i exp(cum_i) dy_i (x) C_i
    for (int i = 0; i < kTile && I * kTile + i < q; ++i) {
      const float ec = expf(cum[I * kTile + i]);
      float dr[kCp], cr[kCn];
#pragma unroll
      for (int a = 0; a < kCp; ++a) dr[a] = dy_t[i * kLdP + ti + 16 * a] * ec;
#pragma unroll
      for (int k = 0; k < kCn; ++k) cr[k] = c_t[i * kLdN + tj + 16 * k];
#pragma unroll
      for (int a = 0; a < kCp; ++a)
#pragma unroll
        for (int k = 0; k < kCn; ++k) dprev[a][k] = fmaf(dr[a], cr[k], dprev[a][k]);
    }
  }
  {
    float* out = prm.dprev + slot * P * N;
#pragma unroll
    for (int a = 0; a < kCp; ++a)
#pragma unroll
      for (int k = 0; k < kCn; ++k) out[(ti + 16 * a) * N + tj + 16 * k] = dprev[a][k];
  }

  // -- phase B: key tiles ---------------------------------------------------
  for (int J = 0; J < tiles; ++J) {
    __syncthreads();   // b_t, x_t free
    load_rows<N>(b_t, kLdN, bg, prm.b_s[1], J * kTile, q);
    load_rows<P>(x_t, kLdP, xg, prm.x_s[1], J * kTile, q);
    float dx[4][kCp] = {}, db[4][kCn] = {};   // rows j = ti + 16a
    for (int I = J; I < tiles; ++I) {
      __syncthreads();   // c_t, dy_t and the pair's tiles free
      load_rows<N>(c_t, kLdN, cg, prm.c_s[1], I * kTile, q);
      load_rows<P>(dy_t, kLdP, dyg, hp, I * kTile, q);
      __syncthreads();
      pair(I, J);
      __syncthreads();
      for (int i = 0; i < kTile; ++i) {
        float sr[4], ar[4], dr[kCp], cr[kCn];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          sr[a] = s_t[i * kLdT + ti + 16 * a];
          ar[a] = a_t[i * kLdT + ti + 16 * a];
        }
#pragma unroll
        for (int k = 0; k < kCp; ++k) dr[k] = dy_t[i * kLdP + tj + 16 * k];
#pragma unroll
        for (int k = 0; k < kCn; ++k) cr[k] = c_t[i * kLdN + tj + 16 * k];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int k = 0; k < kCp; ++k) dx[a][k] = fmaf(sr[a], dr[k], dx[a][k]);
#pragma unroll
          for (int k = 0; k < kCn; ++k) db[a][k] = fmaf(ar[a], cr[k], db[a][k]);
        }
      }
      if (tid < kTile) {
        float sum = 0.f;
        for (int i = 0; i < kTile; ++i) sum += r_t[i * kLdT + tid];
        dcum[J * kTile + tid] -= sum;
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int gj = J * kTile + ti + 16 * a;
      if (gj >= q) continue;
      float* ox = prm.dx + (bs + gj) * hp + h * P;
      float* ob = prm.db + (bs + gj) * hn + h * N;
#pragma unroll
      for (int k = 0; k < kCp; ++k) ox[tj + 16 * k] = dx[a][k];
#pragma unroll
      for (int k = 0; k < kCn; ++k) ob[tj + 16 * k] = db[a][k];
    }
  }
  __syncthreads();
  for (int i = tid; i < q; i += kBwdThreads)
    prm.dcum[(bs + i) * prm.heads + h] = dcum[i];
}

template <int P, int N>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_chunk_state_bwd_kernel(const BwdParams prm) {
  using S = BwdShape<P, N>;
  constexpr int kLdN = S::kLdN, kLdP = S::kLdP;
  constexpr int kCn = S::kCn, kCp = S::kCp;
  extern __shared__ float sm[];
  float* g_s = sm;                        // G_c+1, [p][n]
  float* x_t = g_s + P * kLdN;            // x rows, [j][p]
  float* b_t = x_t + kTile * kLdP;        // B rows, [j][n]
  float* w = b_t + kTile * kLdN;          // cum, then w_j = exp(T - cum_j)
  __shared__ float warp_total[4];
  __shared__ float red[kBwdThreads / 32];
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  if (tid == 0) s_ticket = atomicAdd(prm.ticket, 1);
  __syncthreads();
  // Tickets run chunk by chunk from the last, the (b, h) pairs fastest.
  const int pairs = prm.batch * prm.heads;
  const int c = prm.n_chunks - 1 - s_ticket / pairs;
  const int bh = s_ticket % pairs;
  const int b = bh / prm.heads;
  const int h = bh % prm.heads;
  const int g = h / (prm.heads / prm.groups);
  const int q = prm.q;
  const int64_t row0 = static_cast<int64_t>(c) * q;
  const int64_t bs = static_cast<int64_t>(b) * prm.seq + row0;
  const int64_t hp = static_cast<int64_t>(prm.heads) * P;
  const int64_t hn = static_cast<int64_t>(prm.heads) * N;
  const bf16* xg = prm.x + b * prm.x_s[0] + row0 * prm.x_s[1] + h * prm.x_s[2];
  const bf16* bg = prm.b + b * prm.b_s[0] + row0 * prm.b_s[1] + g * prm.b_s[2];

  if (tid < 128)
    chunk_cumsum(w, warp_total,
                 prm.la + b * prm.la_s[0] + row0 * prm.la_s[1] + h * prm.la_s[2],
                 prm.la_s[1], q, tid, 1);
  __syncthreads();
  const float total = w[q - 1];
  __syncthreads();   // every thread has read total before it is overwritten
  for (int j = tid; j < kMaxChunk; j += kBwdThreads)
    w[j] = j < q ? expf(total - w[j]) : 0.f;

  // -- the state pass: G_c = dprev_c + exp(T_c) G_c+1 ----------------------
  const int64_t slot = static_cast<int64_t>(P) * N;
  float* gbuf = prm.dprev + static_cast<int64_t>(bh) * prm.n_chunks * slot;
  const float* prev = prm.prev + (static_cast<int64_t>(bh) * prm.n_chunks + c) * slot;
  const bool last = c + 1 == prm.n_chunks;
  const float* next = !last ? gbuf + (c + 1) * slot
                            : prm.dfinal ? prm.dfinal + bh * slot : nullptr;
  if (!last && tid == 0) {
    const int* flag = prm.flags + static_cast<int64_t>(bh) * prm.n_chunks + c + 1;
    while (ld_acquire(flag) == 0) __nanosleep(64);
  }
  __syncthreads();
  const float decay = expf(total);
  float dt = 0.f;   // this thread's part of <prev_c, G_c+1>
  for (int e = tid; e < P * N; e += kBwdThreads) {
    // written by another SM: read past L1
    const float gn = next ? __ldcg(next + e) : 0.f;
    g_s[(e / N) * kLdN + e % N] = gn;
    dt = fmaf(prev[e], gn, dt);
    __stcg(gbuf + c * slot + e, fmaf(decay, gn, gbuf[c * slot + e]));
  }
  if (c > 0) {
    __threadfence();   // this thread's part of G_c is visible on the device
    __syncthreads();   // ... and every thread's
    if (tid == 0) st_release(prm.flags + static_cast<int64_t>(bh) * prm.n_chunks + c, 1);
  }
  __syncthreads();

  // -- the chunk-state term, with G = G_c+1 ---------------------------------
  float t_sum = 0.f;
  for (int r0 = 0; r0 < q; r0 += kTile) {
    __syncthreads();   // x_t, b_t free
    load_rows<P>(x_t, kLdP, xg, prm.x_s[1], r0, q);
    load_rows<N>(b_t, kLdN, bg, prm.b_s[1], r0, q);
    __syncthreads();
    float gb[4][kCp] = {};   // (G B_j)_p: rows j = ti + 16a, p = tj + 16k
    for (int n = 0; n < N; ++n) {
      float br[4], gr[kCp];
#pragma unroll
      for (int a = 0; a < 4; ++a) br[a] = b_t[(ti + 16 * a) * kLdN + n];
#pragma unroll
      for (int k = 0; k < kCp; ++k) gr[k] = g_s[(tj + 16 * k) * kLdN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < kCp; ++k) gb[a][k] = fmaf(br[a], gr[k], gb[a][k]);
    }
    float gx[4][kCn] = {};   // (G^T x_j)_n: rows j = ti + 16a, n = tj + 16k
    for (int p = 0; p < P; ++p) {
      float xr[4], gr[kCn];
#pragma unroll
      for (int a = 0; a < 4; ++a) xr[a] = x_t[(ti + 16 * a) * kLdP + p];
#pragma unroll
      for (int k = 0; k < kCn; ++k) gr[k] = g_s[p * kLdN + tj + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < kCn; ++k) gx[a][k] = fmaf(xr[a], gr[k], gx[a][k]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = ti + 16 * a, gj = r0 + j;
      const float wj = w[gj];
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < kCp; ++k) part = fmaf(x_t[j * kLdP + tj + 16 * k], gb[a][k], part);
      const float t = wj * half_warp_sum(part);
      if (gj >= q) continue;
      float* ox = prm.dx + (bs + gj) * hp + h * P;
      float* ob = prm.db + (bs + gj) * hn + h * N;
#pragma unroll
      for (int k = 0; k < kCp; ++k) ox[tj + 16 * k] += wj * gb[a][k];
#pragma unroll
      for (int k = 0; k < kCn; ++k) ob[tj + 16 * k] += wj * gx[a][k];
      if (tj == 0) {
        prm.dcum[(bs + gj) * prm.heads + h] -= t;
        t_sum += t;
      }
    }
  }
  // dT: the pass's term and the chunk-state term, into the last row's dcum
  const float d_total = decay * block_sum(dt, red) + block_sum(t_sum, red);
  if (tid == 0) prm.dcum[(bs + q - 1) * prm.heads + h] += d_total;
}

// dims: batch, seq, heads, groups, head_dim P, state_dim N, Q, then the
// element strides of dims 0-2 of x, log_a, B and C (12 values).
struct Call {
  Params prm;
  int p, n;
  int64_t x_s[3], b_s[3], c_s[3];
};

bool fill(Call& call, const long long* d) {
  Params& prm = call.prm;
  prm.batch = static_cast<int>(d[0]);
  prm.seq = static_cast<int>(d[1]);
  prm.heads = static_cast<int>(d[2]);
  prm.groups = static_cast<int>(d[3]);
  call.p = static_cast<int>(d[4]);
  call.n = static_cast<int>(d[5]);
  prm.q = static_cast<int>(d[6]);
  for (int i = 0; i < 3; ++i) {
    call.x_s[i] = d[7 + i];
    call.b_s[i] = d[13 + i];
    call.c_s[i] = d[16 + i];
  }
  prm.la_sb = d[10], prm.la_ss = d[11], prm.la_sh = d[12];
  if (prm.batch <= 0 || prm.seq <= 0 || prm.heads <= 0 || prm.groups <= 0 ||
      prm.q <= 0 || prm.q > kMaxChunk || prm.seq % prm.q != 0 ||
      prm.heads % prm.groups != 0 ||
      static_cast<long long>(prm.batch) * prm.heads * (prm.seq / prm.q) >
          0x7fffffffLL)
    return false;
  prm.n_chunks = prm.seq / prm.q;
  return true;
}

// A 5-D map over (cols, heads or groups, Q, C, B) of a (B, S, heads, cols)
// bf16 view with element strides s (batch, seq, head); 64 x 64 boxes.
bool encode_5d(CUtensorMap* map, const void* base, int cols, int heads,
               const Params& prm, const int64_t (&s)[3]) {
  const cuuint64_t dims[5] = {
      static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(prm.q), static_cast<cuuint64_t>(prm.n_chunks),
      static_cast<cuuint64_t>(prm.batch)};
  const cuuint64_t strides[4] = {
      static_cast<cuuint64_t>(s[2]) * 2, static_cast<cuuint64_t>(s[1]) * 2,
      static_cast<cuuint64_t>(s[1]) * prm.q * 2, static_cast<cuuint64_t>(s[0]) * 2};
  const cuuint32_t box[5] = {64, 1, kTile, 1, 1};
  return encode(map, base, 5, dims, strides, box);
}

// Per device: whether each instantiation's shared-memory limit is raised.
constexpr int kMaxDevices = 64;

template <typename K>
int raise_smem(K kernel, int bytes, bool (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  return cudaSuccess;
}

template <int P, int N>
int launch_state(const Call& call, const void* x, const void* b,
                 cudaStream_t stream) {
  using S = Shape<P, N>;
  static bool raised[kMaxDevices];
  const int err = raise_smem(ssd_chunk_state_kernel<P, N>,
                             S::state_smem(), raised);
  if (err != cudaSuccess) return err;
  const Params& prm = call.prm;
  CUtensorMap map_x, map_b;
  if (!encode_5d(&map_x, x, P, prm.heads, prm, call.x_s) ||
      !encode_5d(&map_b, b, N, prm.groups, prm, call.b_s))
    return cudaErrorInvalidValue;
  const int blocks = prm.batch * prm.heads * prm.n_chunks;
  ssd_chunk_state_kernel<P, N><<<blocks, kStateThreads, S::state_smem(),
                                 stream>>>(map_x, map_b, prm);
  return cudaGetLastError();
}

template <int P, int N>
int launch_scan(const Call& call, const void* x, const void* b, const void* c,
                void* y, cudaStream_t stream) {
  using S = Shape<P, N>;
  static_assert(S::scan_smem(kMaxTiles) <= 227 * 1024, "shared memory");
  static bool raised[kMaxDevices];
  const int err = raise_smem(ssd_chunk_scan_kernel<P, N>,
                             S::scan_smem(kMaxTiles), raised);
  if (err != cudaSuccess) return err;
  const Params& prm = call.prm;
  // y (B, S, H, P) contiguous
  const int64_t y_s[3] = {static_cast<int64_t>(prm.seq) * prm.heads * P,
                          static_cast<int64_t>(prm.heads) * P, P};
  CUtensorMap map_x, map_b, map_c, map_y;
  if (!encode_5d(&map_x, x, P, prm.heads, prm, call.x_s) ||
      !encode_5d(&map_b, b, N, prm.groups, prm, call.b_s) ||
      !encode_5d(&map_c, c, N, prm.groups, prm, call.c_s) ||
      !encode_5d(&map_y, y, P, prm.heads, prm, y_s))
    return cudaErrorInvalidValue;
  const int tiles = (prm.q + kTile - 1) / kTile;
  const int blocks = prm.batch * prm.heads * prm.n_chunks;
  ssd_chunk_scan_kernel<P, N><<<blocks, kScanThreads, S::scan_smem(tiles),
                                stream>>>(map_x, map_b, map_c, map_y, prm);
  return cudaGetLastError();
}


// The backward's parameters from a filled call and the forward's inputs.
BwdParams bwd_params(const Call& call, const void* x, const void* log_a,
                     const void* b, const void* c, const void* states) {
  const Params& prm = call.prm;
  BwdParams bp = {};
  bp.x = static_cast<const bf16*>(x);
  bp.b = static_cast<const bf16*>(b);
  bp.c = static_cast<const bf16*>(c);
  bp.la = static_cast<const float*>(log_a);
  bp.prev = static_cast<const float*>(states);
  bp.batch = prm.batch, bp.seq = prm.seq, bp.heads = prm.heads;
  bp.groups = prm.groups, bp.q = prm.q, bp.n_chunks = prm.n_chunks;
  bp.la_s[0] = prm.la_sb, bp.la_s[1] = prm.la_ss, bp.la_s[2] = prm.la_sh;
  for (int i = 0; i < 3; ++i)
    bp.x_s[i] = call.x_s[i], bp.b_s[i] = call.b_s[i], bp.c_s[i] = call.c_s[i];
  return bp;
}

template <int P, int N>
int launch_scan_bwd(const BwdParams& bp, cudaStream_t stream) {
  using S = BwdShape<P, N>;
  static_assert(S::scan_bytes() <= 227 * 1024, "shared memory");
  static bool raised[kMaxDevices];
  const int err = raise_smem(ssd_chunk_scan_bwd_kernel<P, N>, S::scan_bytes(), raised);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_bwd_kernel<P, N><<<bp.batch * bp.heads * bp.n_chunks, kBwdThreads,
                                    S::scan_bytes(), stream>>>(bp);
  return cudaGetLastError();
}

template <int P, int N>
int launch_state_bwd(const BwdParams& bp, cudaStream_t stream) {
  using S = BwdShape<P, N>;
  static bool raised[kMaxDevices];
  const int err = raise_smem(ssd_chunk_state_bwd_kernel<P, N>, S::state_bytes(), raised);
  if (err != cudaSuccess) return err;
  ssd_chunk_state_bwd_kernel<P, N><<<bp.batch * bp.heads * bp.n_chunks, kBwdThreads,
                                     S::state_bytes(), stream>>>(bp);
  return cudaGetLastError();
}

}  // namespace

// The (P, N) pairs compiled here are HEAD_STATE_DIMS in
// repro_torch/kernels/ssd_scan.py.  Each function returns the launch's
// cudaError_t (0 on success).
#define SSD_DISPATCH(FN, ...)                                            \
  if (call.p == 64 && call.n == 128) return FN<64, 128>(__VA_ARGS__);   \
  if (call.p == 64 && call.n == 64) return FN<64, 64>(__VA_ARGS__);     \
  if (call.p == 64 && call.n == 16) return FN<64, 16>(__VA_ARGS__);     \
  if (call.p == 16 && call.n == 16) return FN<16, 16>(__VA_ARGS__);     \
  return cudaErrorInvalidValue;

extern "C" {

// states (B, H, C, P, N) fp32, holding prev_c (the state entering chunk
// c), and final_state (B, H, P, N) bf16 <- x, log_a, B and the initial
// state (fp32, or null for zeros).  Workspace, zeroed by the caller for
// every call: flags, B * H * C int32; ticket, one int32.
int ssd_chunk_state(const void* x, const void* log_a, const void* b,
                    const void* init, void* states, void* final_state,
                    void* flags, void* ticket, const long long* dims,
                    void* stream) {
  Call call = {};
  if (!fill(call, dims)) return cudaErrorInvalidValue;
  Params& prm = call.prm;
  prm.la = static_cast<const float*>(log_a);
  prm.init = static_cast<const float*>(init);
  prm.states = static_cast<float*>(states);
  prm.final_state = static_cast<bf16*>(final_state);
  prm.flags = static_cast<int*>(flags);
  prm.ticket = static_cast<int*>(ticket);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SSD_DISPATCH(launch_state, call, x, b, s)
}

// y (B, S, H, P) bf16, contiguous <- x, log_a, B, C and the passed states
// (prev_c) from ssd_chunk_state.
int ssd_chunk_scan(const void* x, const void* log_a, const void* b,
                   const void* c, const void* states, void* y,
                   const long long* dims, void* stream) {
  Call call = {};
  if (!fill(call, dims)) return cudaErrorInvalidValue;
  Params& prm = call.prm;
  prm.la = static_cast<const float*>(log_a);
  prm.states = static_cast<float*>(const_cast<void*>(states));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SSD_DISPATCH(launch_scan, call, x, b, c, y, s)
}


// The scan's backward, from dy (B, S, H, P) bf16 contiguous: dx (B, S, H, P)
// (its intra term), dB and dC per head (B, S, H, N), dstates (B, H, C, P, N):
// each chunk's dprev_c, dcum (B, S, H); all fp32 and contiguous, every
// element written.
int ssd_chunk_scan_bwd(const void* x, const void* log_a, const void* b,
                       const void* c, const void* states, const void* dy,
                       void* dx, void* db, void* dc, void* dstates, void* dcum,
                       const long long* dims, void* stream) {
  Call call = {};
  if (!fill(call, dims)) return cudaErrorInvalidValue;
  BwdParams bp = bwd_params(call, x, log_a, b, c, states);
  bp.dy = static_cast<const bf16*>(dy);
  bp.dx = static_cast<float*>(dx);
  bp.db = static_cast<float*>(db);
  bp.dc = static_cast<float*>(dc);
  bp.dprev = static_cast<float*>(dstates);
  bp.dcum = static_cast<float*>(dcum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SSD_DISPATCH(launch_scan_bwd, bp, s)
}

// The state pass in reverse and the chunk-state term: dstates (dprev_c from
// ssd_chunk_scan_bwd) becomes G_c, the gradient of the state entering chunk
// c (G_0: the initial state's); the chunk-state term is added to dx, dB
// (per head) and dcum.  dfinal (B, H, P, N) fp32, or null for zeros.
// Workspace, zeroed by the caller for every call: flags, B * H * C int32;
// ticket, one int32.
int ssd_chunk_state_bwd(const void* x, const void* log_a, const void* b,
                        const void* states, const void* dfinal, void* dstates,
                        void* dx, void* db, void* dcum, void* flags,
                        void* ticket, const long long* dims, void* stream) {
  Call call = {};
  if (!fill(call, dims)) return cudaErrorInvalidValue;
  BwdParams bp = bwd_params(call, x, log_a, b, b, states);
  bp.dfinal = static_cast<const float*>(dfinal);
  bp.dprev = static_cast<float*>(dstates);
  bp.dx = static_cast<float*>(dx);
  bp.db = static_cast<float*>(db);
  bp.dcum = static_cast<float*>(dcum);
  bp.flags = static_cast<int*>(flags);
  bp.ticket = static_cast<int*>(ticket);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SSD_DISPATCH(launch_state_bwd, bp, s)
}

}  // extern "C"
