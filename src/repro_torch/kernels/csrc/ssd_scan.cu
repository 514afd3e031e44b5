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
constexpr int kMaxChunk = 256;       // Q: at most 256 rows a chunk
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
  // the backward's state pass only (ssd_chunk_state_bwd): init is dfinal,
  // states G_c+1, and
  float* final_f32;         // (B, H, P, N): G_0, the initial state's gradient
  const float* prev;        // (B, H, C, P, N): the forward's prev_c
  float* dt;                // (B, H, C): exp(T_c) <prev_c, G_c+1>
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
// Run by the 256 / kRows threads t of whole warps, kRows rows each (a
// shuffle scan over each warp, then the warps' totals); `bar` is their
// named barrier.
template <int kRows>
__device__ void chunk_cumsum(float* cum, float* warp_total, const float* la,
                             int64_t stride, int q, int t, int bar) {
  constexpr int kThreads = kMaxChunk / kRows;
  const int lane = t % 32;
  const int warp = t / 32;
  float v[kRows];
  float incl = 0.f;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = kRows * t + k;
    v[k] = r < q ? la[r * stride] : 0.f;
    incl += v[k];
  }
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) warp_total[warp] = incl;
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kThreads) : "memory");
  float run = 0.f;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  run += excl;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    run += v[k];
    cum[kRows * t + k] = run;
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kThreads) : "memory");
}

// The block's sum of v (kStateThreads threads), the same on every thread,
// in a fixed order.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kStateThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// Kernel 1: chunk states and the chained hand-off.  One warpgroup a block;
// warp w owns state rows p in [16w, 16w + 16), all N columns: accumulator
// element 4j + r holds row 16w + lane / 4 (+ 8 for r >= 2), column
// 8j + 2 (lane % 4) (+ 1 for odd r).  The chunk's 64-row tiles of x and B
// go through a 2-stage ring (49 KB of shared memory at N 128), so three
// blocks share an SM and hide each other's latencies: the ticket, the
// first loads, the hand-off.
//
// kBwd: the same body runs the backward's state pass
// (ssd_chunk_state_bwd_kernel, see the backward's note): map_x reads dy,
// map_b reads C, the weight is exp(cum_j), the chunks run last to first and
// the hand-off passes G.
// ---------------------------------------------------------------------------
template <int P, int N, bool kBwd>
__device__ __forceinline__ void chunk_state_body(const CUtensorMap& map_x,
                                                 const CUtensorMap& map_b,
                                                 const Params& prm) {
  using S = Shape<P, N>;
  constexpr int kNB = S::kNBoxes;
  constexpr int kStage = (1 + kNB) * kBox;   // x, then B's boxes
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kStateStages];
  __shared__ float weight[kMaxChunk];
  __shared__ float warp_total[4];
  __shared__ float red[kStateThreads / 32];
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
  // Tickets run chunk by chunk (from the last in the backward), the (b, h)
  // pairs fastest.
  const int pairs = prm.batch * prm.heads;
  const int c = kBwd ? prm.n_chunks - 1 - s_ticket / pairs : s_ticket / pairs;
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

  chunk_cumsum<2>(weight, warp_total,
               prm.la + b * prm.la_sb + static_cast<int64_t>(c) * q * prm.la_ss +
                   h * prm.la_sh,
               prm.la_ss, q, tid, 1);
  const float total = weight[q - 1];
  __syncthreads();  // every thread has read total before it is overwritten
  for (int j = tid; j < kMaxChunk; j += kStateThreads)
    weight[j] = j < q ? expf(kBwd ? weight[j] : total - weight[j]) : 0.f;
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

  // -- the hand-off -------------------------------------------------------
  // Forward: prev_c+1 = prev_c exp(total_c) + state_c, first chunk to last;
  // backward: G_c = G_c+1 exp(T_c) + dprev_c, last chunk to first.  `in`
  // enters this chunk's step (prev_c; G_c+1), `out` leaves it (prev_c+1;
  // G_c, stored where the next chunk's block reads its `in`).
  // The step's state goes into shared memory first (the ring is free now),
  // rows of N + 4 floats (the padding spreads a warp's fragment stores over
  // the banks), then every thread takes float4s of the (P, N) state:
  // coalesced loads and stores, few registers.
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
  // the chain's first step takes the initial state (dfinal), or zeros, and
  // also stores it as its `in`; any other step's `in` was stored by the
  // block of the chunk before it in the chain
  const bool head = kBwd ? c + 1 == prm.n_chunks : c == 0;
  const bool tail = kBwd ? c == 0 : c + 1 == prm.n_chunks;
  const int out_c = kBwd ? c - 1 : c + 1;
  const float* in = !head ? states + c * slot
                          : prm.init ? prm.init + bh * slot : nullptr;
  if (!head && tid == 0) {
    const int* flag = prm.flags + static_cast<int64_t>(bh) * prm.n_chunks + c;
    while (ld_acquire(flag) == 0) __nanosleep(64);
  }
  __syncthreads();   // the staged state, and `in` once the flag is up
  const float decay = expf(total);
  float* next = states + out_c * slot;
  // every thread's loads of `in` in flight at once (16 float4s at N 128)
  constexpr int kVec = (P * N + 4 * kStateThreads - 1) / (4 * kStateThreads);
  float4 pv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int e = 4 * (i * kStateThreads + tid);
    // written by another SM: read past L1
    pv[i] = in && e < P * N ? __ldcg(reinterpret_cast<const float4*>(in + e))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float dot = 0.f;   // the backward's <prev_c, G_c+1>, this thread's part
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int e = 4 * (i * kStateThreads + tid);
    if (e >= P * N) break;
    const float4 v = pv[i];
    if (head) *reinterpret_cast<float4*>(states + c * slot + e) = v;
    if constexpr (kBwd) {
      const float4 pr = *reinterpret_cast<const float4*>(
          prm.prev + (static_cast<int64_t>(bh) * prm.n_chunks + c) * slot + e);
      dot = fmaf(v.x, pr.x, fmaf(v.y, pr.y, fmaf(v.z, pr.z, fmaf(v.w, pr.w, dot))));
    }
    const float4 sc = *reinterpret_cast<const float4*>(st + (e / N) * kRow + e % N);
    const float4 r = make_float4(fmaf(v.x, decay, sc.x), fmaf(v.y, decay, sc.y),
                                 fmaf(v.z, decay, sc.z), fmaf(v.w, decay, sc.w));
    if (!tail) {
      __stcg(reinterpret_cast<float4*>(next + e), r);
    } else if constexpr (kBwd) {
      *reinterpret_cast<float4*>(prm.final_f32 + bh * slot + e) = r;
    } else {
      bf16* fin = prm.final_state + bh * slot;
      *reinterpret_cast<__nv_bfloat162*>(fin + e) = __floats2bfloat162_rn(r.x, r.y);
      *reinterpret_cast<__nv_bfloat162*>(fin + e + 2) = __floats2bfloat162_rn(r.z, r.w);
    }
  }
  if (!tail) {
    __threadfence();   // this thread's part of `out` is visible on the device
    __syncthreads();   // ... and every thread's
    if (tid == 0)
      st_release(prm.flags + static_cast<int64_t>(bh) * prm.n_chunks + out_c, 1);
  }
  if constexpr (kBwd) {
    const float sum = block_sum(dot, red);
    if (tid == 0) prm.dt[static_cast<int64_t>(bh) * prm.n_chunks + c] = decay * sum;
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kStateThreads, kStateBlocks)
    ssd_chunk_state_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_b,
                           const Params prm) {
  chunk_state_body<P, N, false>(map_x, map_b, prm);
}

template <int P, int N>
__global__ void __launch_bounds__(kStateThreads, kStateBlocks)
    ssd_chunk_state_bwd_kernel(const __grid_constant__ CUtensorMap map_x,
                               const __grid_constant__ CUtensorMap map_b,
                               const Params prm) {
  chunk_state_body<P, N, true>(map_x, map_b, prm);
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
    chunk_cumsum<2>(cum, warp_total,
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
// (repro.kernels.ssd_scan, repro.models.ssm.ssd_chunked).  Per (b, h, c),
// with S_ij = (C_i . B_j) e_ij, e_ij = exp(cum_i - cum_j) for j <= i (else
// 0), dS_ij = dy_i . x_j, A_ij = dS_ij e_ij, R_ij = S_ij dS_ij, T = cum[Q-1],
// w_j = exp(T - cum_j) and G_c the gradient of the state entering chunk c:
//
// ssd_chunk_state_bwd (launched first; kernel 1 with kBwd): the state pass
//   in reverse.  dprev_c = sum_i exp(cum_i) dy_i (x) C_i by wgmma (the
//   forward's (x o w)^T B with dy, C and exp(cum)), G_C = dfinal (or 0),
//   G_c = dprev_c + exp(T_c) G_c+1, handed from chunk c + 1's block to
//   chunk c's by the forward's ticketed chained hand-off run backwards.
//   Writes gnext[c] = G_c+1 (what chunk c's outputs need), G_0 (the initial
//   state's gradient) and dT_c = exp(T_c) <prev_c, G_c+1>, all fp32.
//
// ssd_chunk_scan_bwd: everything else, in final form:
//   dx_j   = sum_{i >= j} S_ij dy_i + w_j G_c+1 B_j           (bf16)
//   dB_j   = sum_i A_ij C_i + w_j G_c+1^T x_j                (summed over heads)
//   dC_i   = sum_j A_ij B_j + exp(cum_i) prev_c^T dy_i       (summed over heads)
//   dcum_i = sum_j R_ij - sum_i' R_i'i + exp(cum_i) dy_i . (prev_c C_i)
//            - w_i x_i . (G_c+1 B_i), plus dT_c + sum_j w_j x_j . (G_c+1 B_j)
//            at i = Q - 1;  dlog_a = its reverse cumsum within the chunk.
//   One block a (b, c, set of `rep` heads of one group), heads fastest.
//   Roles: a consumer warpgroup; a producer warp (one thread issues every
//   TMA load through the forward's 5-D maps: B_J with x_J, then C_I with
//   dy_I, each buffer on full/empty mbarriers); three converter warps that
//   turn prev_c and G_c+1 (fp32) into hi + lo bf16 operand planes in shared
//   memory, and with a (J, head)'s first planes compute the head's cum of
//   log_a, each loaded into registers while the consumer still works on
//   the planes' last use.  The consumer walks key tiles J, then the set's
//   heads, then row tiles I >= J.  For each tile pair it computes S^T =
//   B_J C_I^T and dS^T = x_J dy_I^T once (wgmma, both K-major from shared
//   memory), masks the decay before the exponent, takes R's row sums (into
//   dcum_j, in registers) and column sums (over the warps through shared
//   memory, into dcum_i), and then:
//   - dx_J += S^T dy_I with S^T as hi + lo bf16 A fragments (registers);
//   - A^T goes to shared memory as hi + lo bf16 tiles, from which come
//     dB_J += A^T C_I (A^T read K-major) and dC_I's part A B_J (read
//     MN-major, 64 columns a commit group), by wgmma with C_I and B_J
//     N-major; the stage goes back to the producer before dC's part.
//   dx_J stays in registers over I and leaves in bf16 at the end of the
//   head; dB_J stays in registers over the heads and I (the sum over the
//   group's heads on chip) and leaves once a J.  dC_I sums over J and the
//   heads: each part is added, by the thread that holds it, to an fp32
//   accumulator of the whole chunk in shared memory (16-byte chunks
//   swizzled by row: conflict-free), written out once at the end.  dB and
//   dC leave in fp32, one slice a block's set of heads (B, S, H / rep, N);
//   the wrapper adds the slices of a group in a fixed order.  The inter
//   term (prev_c's planes, once a head, with the first key tile) and the
//   chunk-state term (G_c+1's planes, at the start of each (J, head)) are
//   wgmma products on the same tiles.  Every sum runs in a fixed order and
//   no atomics add floats: the same bits every run, and for a batch of gang
//   members the same bits as each alone (rep does not depend on the batch).
//
//   Why a block owns a chunk, and not a key tile with dC handed on in
//   key-tile order through L2 (the flash-attention backward's dQ): a chunk
//   has at most 4 key tiles, so a block a key tile would repeat the per-
//   head set-up (cum, G's planes, x) 4 times over as many blocks, and each
//   dC part would travel to L2 and back in turn; inside one block the parts
//   meet in shared memory.  The price is the chunk's fp32 dC (128 KB at
//   Q 256, N 128).  Chosen from these counts, not by timing the other; the
//   sum over heads was measured (scripts/ssd_ablations.py
//   bwd-one-head-a-block: one head a block is 1.18x slower at mamba2's
//   shape, and its 48 slices a group make the whole backward 1.7x slower).
//
// Precision: the fp32 operands (the decayed scores S and A, prev, G) are
// split into bf16 hi + lo parts, as in the forward: ~16 bits of mantissa.
//
// What bounds them (chip_smoke.py ssd_bwd_floor_ms): at the mamba2-780m
// training shape the whole backward must move ~213 MB (x, dy and dx in
// bf16, the fp32 states prev; ~64 us on an H100) and do ~65 GFLOP (C B^T
// once a group; ~66 us); the state pass moves dy, prev and G (~161 MB,
// ~48 us); the scan's backward x, dy, dx, prev, G and the dB/dC slices
// (~292 MB, ~87 us) and issues ~143 GFLOP of wgmma (C B^T for each head,
// the hi + lo halves; ~0.15 ms at peak).  What holds the scan's backward
// back (PERF.md; scripts/ssd_bwd_phases.py and ssd_ablations.py): the
// consumer's elementwise work on a tile pair (the decay, R's sums, the hi
// + lo splits, A^T's stores) takes a third of its cycles, dC's parts and
// their accumulation a sixth, the inter and chunk-state terms a quarter,
// the tensor-core phases under a tenth: one warpgroup a block, so one warp
// a scheduler, and nothing hides the elementwise latency.  The dC
// accumulators leave room for one block an SM and a single-stage ring.
// Next: a second consumer warpgroup that takes half of each pair's
// columns.
// ---------------------------------------------------------------------------
constexpr int kConverters = 96;    // threads that fill the operand planes
// one consumer warpgroup, one producer warp, three converter warps
constexpr int kBwdThreads = 128 + 32 + kConverters;
constexpr int kMaxRep = 12;        // heads a block of the scan's backward walks
constexpr int kBarBwd = 1;         // the consumer warpgroup's named barrier

struct BwdParams {
  const float* la;          // (B, S, H), strides la_s*
  const float* prev;        // (B, H, C, P, N): the forward's prev_c
  const float* gnext;       // (B, H, C, P, N): G_c+1
  const float* dt;          // (B, H, C): exp(T_c) <prev_c, G_c+1>
  bf16* dx;                 // (B, S, H, P)
  float* dla;               // (B, S, H)
  float* db;                // (B, S, H / rep, N): a block's heads summed
  float* dc;                // (B, S, H / rep, N)
  int batch, seq, heads, groups, q, n_chunks, rep;
  int64_t la_sb, la_ss, la_sh;
};

template <int P, int N>
struct BwdShape {
  static constexpr int kNPad = Shape<P, N>::kNPad;
  static constexpr int kNB = Shape<P, N>::kNBoxes;
  static constexpr int kKN = N / 16;    // 16-deep k-steps over n
  static constexpr int kKP = P / 16;    // ... over p
  // dynamic shared memory for `tiles` row tiles: B_J (kNB boxes), x_J, C_I
  // (kNB), dy_I, the operand planes (hi, lo: kNB boxes each), the chunk's
  // dC accumulators (tiles x 64 x kNPad fp32), dcum (kMaxRep x 256 fp32)
  // and 1024 to align the boxes on the swizzle's atoms
  static constexpr int kBoxes = 4 * kNB + 2;
  static constexpr int smem(int tiles) {
    return kBoxes * kBox + tiles * kTile * kNPad * 4 + kMaxRep * kMaxChunk * 4 + 1024;
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Sum over the 4 lanes of a quad (the threads of one accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Float offset of element (row, col) of a 64 x W fp32 accumulator tile
// whose 16-byte chunks are swizzled by row % 8: a warp's float2s of one
// accumulator register pair fall on distinct banks.
template <int W>
__device__ __forceinline__ int acc_off(int row, int col) {
  return row * W + ((((col >> 2) ^ (row & 7))) << 2) + (col & 3);
}

// tile += v, v a warpgroup's 64 x 2V accumulator (element 4j + r: row
// row0 + 8 (r / 2), column 8j + col0 + r % 2) of a 64 x W tile.
template <int W, int V>
__device__ __forceinline__ void add_to_tile(float* tile, const float (&v)[V],
                                            int row0, int col0) {
#pragma unroll
  for (int j = 0; j < V / 4; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2* d = reinterpret_cast<float2*>(tile + acc_off<W>(row0 + 8 * half, 8 * j + col0));
      float2 a = *d;
      a.x += v[4 * j + 2 * half];
      a.y += v[4 * j + 2 * half + 1];
      *d = a;
    }
  }
}

// A (P, N) fp32 matrix for the operand planes, in two steps: this thread's
// part of it into registers (load_planes, early), then into the planes as
// bf16 hi and lo parts (store_planes): [p][n] boxes of 64 rows (zero past
// P) by 64 columns (zero past N: 0 x garbage could be nan), 128-byte
// swizzle.  Run by kConverters threads t, 8 floats an item.
template <int P, int N>
struct Planes {
  static constexpr int kNPad = Shape<P, N>::kNPad;
  static constexpr int kItems = 64 * kNPad / 8;
  static constexpr int kPer = (kItems + kConverters - 1) / kConverters;
  float4 v[kPer][2];

  __device__ __forceinline__ void load(const float* src, int t) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kConverters + t;
      const int p = e / (kNPad / 8);
      const int n = (e % (kNPad / 8)) * 8;
      v[i][0] = v[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < kItems && p < P && n < N) {
        v[i][0] = *reinterpret_cast<const float4*>(src + p * N + n);
        v[i][1] = *reinterpret_cast<const float4*>(src + p * N + n + 4);
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* hi, unsigned char* lo, int t) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kConverters + t;
      if (e >= kItems) break;
      const int p = e / (kNPad / 8);
      const int n = (e % (kNPad / 8)) * 8;
      uint4 h, l;
      split_bf16(v[i][0].x, v[i][0].y, h.x, l.x);
      split_bf16(v[i][0].z, v[i][0].w, h.y, l.y);
      split_bf16(v[i][1].x, v[i][1].y, h.z, l.z);
      split_bf16(v[i][1].z, v[i][1].w, h.w, l.w);
      const uint32_t off = (n / 64) * kBox + swizzled(p, (n % 64) / 8);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
  }
};

// The bf16 pair (col, col + 1) of row `row` of a chunk tile of 64-column
// boxes in shared memory, as floats.
__device__ __forceinline__ float2 tile_pair(const unsigned char* tile, int row, int col) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(
      tile + (col / 64) * kBox + swizzled(row, (col % 64) / 8) + (col % 8) * 2));
}

template <int P, int N>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_chunk_scan_bwd_kernel(const __grid_constant__ CUtensorMap map_x,
                              const __grid_constant__ CUtensorMap map_dy,
                              const __grid_constant__ CUtensorMap map_b,
                              const __grid_constant__ CUtensorMap map_c,
                              const BwdParams prm) {
  using S = BwdShape<P, N>;
  constexpr int kNB = S::kNB, kNPad = S::kNPad, kKN = S::kKN, kKP = S::kKP;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t xb_full, xb_empty, st_full, st_empty, pl_full, pl_empty;
  __shared__ float cum_buf[2][kMaxChunk];   // a (J, head)'s cum, double-buffered
  __shared__ float cum[kMaxChunk];          // the consumer's scratch (dlog_a)
  __shared__ float cv_total[2];             // the converters' warp totals
  __shared__ float colbuf[4][kTile];
  __shared__ float warp_total[4];
  __shared__ float red[4];
  __shared__ float dtot[kMaxRep];
  const int q = prm.q;
  const int tiles = (q + kTile - 1) / kTile;
  const uint32_t s_b = (smem_addr(smem_raw) + 1023) & ~1023u;   // B_J
  const uint32_t s_x = s_b + kNB * kBox;                        // x_J
  const uint32_t s_c = s_x + kBox;                              // C_I
  const uint32_t s_dy = s_c + kNB * kBox;                       // dy_I
  const uint32_t s_hi = s_dy + kBox;                            // operand planes
  const uint32_t s_lo = s_hi + kNB * kBox;
  unsigned char* const smem = smem_raw - smem_addr(smem_raw);   // + a shared address
  float* const dcacc = reinterpret_cast<float*>(smem + s_lo + kNB * kBox);
  float* const dcum = dcacc + tiles * kTile * kNPad;            // + r x 256

  // heads fastest: the blocks running together share a chunk of B and C
  const int sets = prm.heads / prm.rep;
  const int set = blockIdx.x % sets;
  const int c = (blockIdx.x / sets) % prm.n_chunks;
  const int b = blockIdx.x / (sets * prm.n_chunks);
  const int h0 = set * prm.rep;
  const int g = h0 / (prm.heads / prm.groups);
  const int64_t row0_s = static_cast<int64_t>(b) * prm.seq + static_cast<int64_t>(c) * q;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(smem_addr(&xb_full), 1);
    mbar_init(smem_addr(&xb_empty), 128);
    mbar_init(smem_addr(&st_full), 1);
    mbar_init(smem_addr(&st_empty), 128);
    mbar_init(smem_addr(&pl_full), kConverters);
    mbar_init(smem_addr(&pl_empty), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  unsigned char* const hi = smem + s_hi;
  unsigned char* const lo = smem + s_lo;
  const int64_t slot = static_cast<int64_t>(P) * N;
  if (tid >= 160) {
    // -- the converters: prev_c (with the first key tile) and G_c+1 of each
    // (J, head) into the planes, in the consumer's order; each loaded into
    // registers while the consumer still works on the planes' last use
    // and, with a (J, head)'s first planes, the head's cum into cum_buf
    const int t = tid - 160;
    Planes<P, N> pl;
    int pu = 0, jh = 0;
    for (int J = 0; J < tiles; ++J) {
      for (int r = 0; r < prm.rep; ++r, ++jh) {
        const int h = h0 + r;
        const int64_t bhc = (static_cast<int64_t>(b) * prm.heads + h) * prm.n_chunks + c;
        for (int k = J == 0 ? 0 : 1; k < 2; ++k) {
          pl.load((k == 0 ? prm.prev : prm.gnext) + bhc * slot, t);
          // cum_buf[jh % 2] was last read in (J, head) jh - 2, whose planes
          // were handed back before this thread's last fill
          if (k == (J == 0 ? 0 : 1) && t < 64)
            chunk_cumsum<4>(cum_buf[jh & 1], cv_total,
                           prm.la + b * prm.la_sb + static_cast<int64_t>(c) * q * prm.la_ss +
                               h * prm.la_sh,
                           prm.la_ss, q, t, 2);
          mbar_wait(smem_addr(&pl_empty), (pu & 1) ^ 1);
          pl.store(hi, lo, t);
          fence_async_shared();   // the wgmmas read what these threads wrote
          mbar_arrive(smem_addr(&pl_full));
          ++pu;
        }
      }
    }
    return;
  }
  if (tid >= 128) {
    // -- the producer: one thread issues every load, in the consumer's order
    if (tid == 128) {
      int it = 0, xu = 0;
      for (int J = 0; J < tiles; ++J) {
        for (int r = 0; r < prm.rep; ++r) {
          const int h = h0 + r;
          mbar_wait(smem_addr(&xb_empty), (xu & 1) ^ 1);
          const uint32_t xf = smem_addr(&xb_full);
          mbar_expect_tx(xf, (r == 0 ? kNB + 1 : 1) * kBox);
          tma_load_5d(s_x, &map_x, xf, 0, h, J * kTile, c, b);
          if (r == 0) {
            for (int nb = 0; nb < kNB; ++nb)
              tma_load_5d(s_b + nb * kBox, &map_b, xf, nb * 64, g, J * kTile, c, b);
          }
          ++xu;
          // the inter term's row tiles (with the first key tile), then the pairs'
          const int inter = J == 0 ? tiles : 0;
          for (int k = 0; k < inter + tiles - J; ++k) {
            const int I = k < inter ? k : J + k - inter;
            mbar_wait(smem_addr(&st_empty), (it & 1) ^ 1);
            const uint32_t sf = smem_addr(&st_full);
            mbar_expect_tx(sf, (kNB + 1) * kBox);
            for (int nb = 0; nb < kNB; ++nb)
              tma_load_5d(s_c + nb * kBox, &map_c, sf, nb * 64, g, I * kTile, c, b);
            tma_load_5d(s_dy, &map_dy, sf, 0, h, I * kTile, c, b);
            ++it;
          }
        }
      }
    }
    return;
  }

  // -- the consumer warpgroup ------------------------------------------------
  const int warp = tid / 32, lane = tid % 32;
  // accumulator element 4j + r: row row0 + 8 (r / 2), column 8j + col0 + r % 2
  const int row0 = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  for (int e = tid; e < tiles * kTile * kNPad / 4; e += 128)
    reinterpret_cast<float4*>(dcacc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < prm.rep * kMaxChunk; e += 128) dcum[e] = 0.f;
  if (tid < kMaxRep) dtot[tid] = 0.f;
  warpgroup_sync(kBarBwd);
  int it = 0, xu = 0, pu = 0;

  for (int J = 0; J < tiles; ++J) {
    float db[kNPad / 2];
    zero(db);
    for (int r = 0; r < prm.rep; ++r) {
      const int h = h0 + r;
      float* const dcum_h = dcum + r * kMaxChunk;
      // this (J, head)'s cum, from the converters with its first planes
      const float* const cum = cum_buf[(J * prm.rep + r) & 1];

      // -- the inter-chunk term, once a head (with the first key tile):
      // dC_I += exp(cum_i) (dy_I prev_c), dcum_i += that row . C_i
      const int inter = J == 0 ? tiles : 0;
      if (inter > 0) {
        mbar_wait(smem_addr(&pl_full), pu & 1);   // prev_c
        ++pu;
      }
      for (int I = 0; I < inter; ++I) {
        mbar_wait(smem_addr(&st_full), it & 1);
        float acc[kNPad / 2];
        fence_acc(acc);
        wgmma_fence();
        // dy_I K-major (p), prev N-major: 16 rows of p a step
#pragma unroll
        for (int kk = 0; kk < kKP; ++kk)
          wgmma_ss<0, 1>(acc, smem_desc(s_dy + kk * 32, 16, 1024),
                         smem_desc(s_hi + kk * 16 * 128, kBox, 1024), kk > 0);
#pragma unroll
        for (int kk = 0; kk < kKP; ++kk)
          wgmma_ss<0, 1>(acc, smem_desc(s_dy + kk * 32, 16, 1024),
                         smem_desc(s_lo + kk * 16 * 128, kBox, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // rows past q: dy is zero there, and cum finite
          const float ea = expf(cum[I * kTile + row0 + 8 * half]);
#pragma unroll
          for (int j = 0; j < kNPad / 8; ++j) {
            acc[4 * j + 2 * half] *= ea;
            acc[4 * j + 2 * half + 1] *= ea;
            if (8 * j < N) {
              const float2 cv = tile_pair(smem + s_c, row0 + 8 * half, 8 * j + col0);
              part[half] = fmaf(acc[4 * j + 2 * half], cv.x,
                                fmaf(acc[4 * j + 2 * half + 1], cv.y, part[half]));
            }
          }
          part[half] = quad_sum(part[half]);
        }
        mbar_arrive(smem_addr(&st_empty));
        ++it;
        if (lane % 4 == 0) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = I * kTile + row0 + 8 * half;
            if (i < q) dcum_h[i] += part[half];
          }
        }
        add_to_tile<kNPad>(dcacc + I * kTile * kNPad, acc, row0, col0);
      }

      if (inter > 0) mbar_arrive(smem_addr(&pl_empty));   // done with prev_c

      // -- the chunk-state term with G = G_c+1 (N-major planes): dx_J =
      // w (B_J G^T), dB_J += w (x_J G), dcum_j -= w_j x_j . (G B_j)
      mbar_wait(smem_addr(&pl_full), pu & 1);   // G_c+1
      ++pu;
      const float total = cum[q - 1];
      mbar_wait(smem_addr(&xb_full), xu & 1);
      float dx[32];
      float rowacc[2];
      {
        float tmp[kNPad / 2];
        fence_acc(dx);
        fence_acc(tmp);
        wgmma_fence();
        // B_J and G both K-major (n): 16 columns of n a step, the next 64
        // the next box
#pragma unroll
        for (int kk = 0; kk < kKN; ++kk) {
          const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
          wgmma_ss(dx, smem_desc(s_b + off, 16, 1024), smem_desc(s_hi + off, 16, 1024),
                   kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < kKN; ++kk) {
          const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
          wgmma_ss(dx, smem_desc(s_b + off, 16, 1024), smem_desc(s_lo + off, 16, 1024), 1);
        }
        // x_J K-major (p), G N-major
#pragma unroll
        for (int kk = 0; kk < kKP; ++kk)
          wgmma_ss<0, 1>(tmp, smem_desc(s_x + kk * 32, 16, 1024),
                         smem_desc(s_hi + kk * 16 * 128, kBox, 1024), kk > 0);
#pragma unroll
        for (int kk = 0; kk < kKP; ++kk)
          wgmma_ss<0, 1>(tmp, smem_desc(s_x + kk * 32, 16, 1024),
                         smem_desc(s_lo + kk * 16 * 128, kBox, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dx);
        fence_acc(tmp);
        float w[2], t[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = J * kTile + row0 + 8 * half;
          w[half] = j < q ? expf(total - cum[j]) : 0.f;
#pragma unroll
          for (int jj = 0; jj < P / 8; ++jj) {
            const float2 xv = tile_pair(smem + s_x, row0 + 8 * half, 8 * jj + col0);
            t[half] = fmaf(xv.x, dx[4 * jj + 2 * half],
                           fmaf(xv.y, dx[4 * jj + 2 * half + 1], t[half]));
          }
          t[half] = quad_sum(t[half]);
          rowacc[half] = -w[half] * t[half];
        }
        // dT's chunk-state part, sum_j w_j x_j . (G B_j): one value a row
        float tsum = lane % 4 == 0 ? w[0] * t[0] + w[1] * t[1] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off /= 2) tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
        if (lane == 0) red[warp] = tsum;
#pragma unroll
        for (int i = 0; i < 32; ++i) dx[i] *= w[(i % 4) / 2];
#pragma unroll
        for (int i = 0; i < kNPad / 2; ++i) db[i] = fmaf(w[(i % 4) / 2], tmp[i], db[i]);
      }
      warpgroup_sync(kBarBwd);   // every warp is done with the planes; red is in
      if (tid == 0) dtot[r] += red[0] + red[1] + red[2] + red[3];

      // -- the tile pairs (I >= J): S^T and dS^T once each -------------------
      float rowpart[2] = {0.f, 0.f};
      for (int I = J; I < tiles; ++I) {
        mbar_wait(smem_addr(&st_full), it & 1);
        float s[32], ds[32];
        fence_acc(s);
        fence_acc(ds);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKN; ++kk) {
          const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
          wgmma_ss(s, smem_desc(s_b + off, 16, 1024), smem_desc(s_c + off, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < kKP; ++kk)
          wgmma_ss(ds, smem_desc(s_x + kk * 32, 16, 1024),
                   smem_desc(s_dy + kk * 32, 16, 1024), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(s);
        fence_acc(ds);
        // rows are keys j, columns queries i: the decay masked before the
        // exponent (-inf where j > i or j >= q), branch-free; R's column
        // sums over the warp's 16 rows, then (colbuf) the warps
        float col[16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          col[2 * jj] = col[2 * jj + 1] = 0.f;
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int j = J * kTile + row0 + 8 * (rr / 2);
            const int i = I * kTile + 8 * jj + col0 + rr % 2;
            const float e = __expf(j <= i && j < q ? cum[i] - cum[j] : -INFINITY);
            const float sv = s[4 * jj + rr] * e;
            const float rv = sv * ds[4 * jj + rr];
            s[4 * jj + rr] = sv;
            ds[4 * jj + rr] *= e;
            rowpart[rr / 2] += rv;
            col[2 * jj + rr % 2] += rv;
          }
        }
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          col[k] += __shfl_xor_sync(0xffffffffu, col[k], 4);
          col[k] += __shfl_xor_sync(0xffffffffu, col[k], 8);
          col[k] += __shfl_xor_sync(0xffffffffu, col[k], 16);
        }
        if (lane < 4) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<float2*>(&colbuf[warp][8 * jj + col0]) =
                make_float2(col[2 * jj], col[2 * jj + 1]);
        }
        // A^T (rows j, 128 bytes of i) into the planes, then S^T as A
        // fragments
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = row0 + 8 * half;
            uint32_t vh, vl;
            split_bf16(ds[4 * jj + 2 * half], ds[4 * jj + 2 * half + 1], vh, vl);
            const uint32_t off = swizzled(row, jj) + col0 * 2;
            *reinterpret_cast<uint32_t*>(hi + off) = vh;
            *reinterpret_cast<uint32_t*>(lo + off) = vl;
          }
        }
        uint32_t a_hi[4][4], a_lo[4][4];
        split_scores(s, a_hi, a_lo);
        fence_async_shared();
        warpgroup_sync(kBarBwd);   // A^T and colbuf are in
        if (tid < kTile && I * kTile + tid < q)
          dcum_h[I * kTile + tid] += colbuf[0][tid] + colbuf[1][tid] + colbuf[2][tid] +
                                     colbuf[3][tid];
        fence_acc(dx);
        fence_acc(db);
        wgmma_fence();
        // dx_J += S^T dy_I: dy_I N-major, 16 rows of i a step
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t d = smem_desc(s_dy + kk * 16 * 128, kBox, 1024);
          wgmma_rs(dx, a_hi[kk], d);
          wgmma_rs(dx, a_lo[kk], d);
        }
        // dB_J += A^T C_I: A^T K-major (i), C_I N-major
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t d = smem_desc(s_c + kk * 16 * 128, kBox, 1024);
          wgmma_ss<0, 1>(db, smem_desc(s_hi + kk * 32, 16, 1024), d, 1);
          wgmma_ss<0, 1>(db, smem_desc(s_lo + kk * 32, 16, 1024), d, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dx);
        fence_acc(db);
        fence_frag(a_hi);
        fence_frag(a_lo);
        mbar_arrive(smem_addr(&st_empty));   // C_I and dy_I are read
        ++it;
        // dC_I's part A B_J, 64 columns a commit group (the registers): A^T
        // read MN-major (rows j are its k), B_J N-major; the first group's
        // sum goes into shared memory while the second runs
        float part[kNB][32];
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
          fence_acc(part[nb]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t d = smem_desc(s_b + nb * kBox + kk * 16 * 128, kBox, 1024);
            wgmma_ss<1, 1>(part[nb], smem_desc(s_hi + kk * 16 * 128, kBox, 1024), d,
                           kk > 0);
            wgmma_ss<1, 1>(part[nb], smem_desc(s_lo + kk * 16 * 128, kBox, 1024), d, 1);
          }
          wgmma_commit();
        }
        float* const tile = dcacc + I * kTile * kNPad;
        if constexpr (kNB == 2) {
          wgmma_wait<1>();
          fence_acc(part[0]);
          add_to_tile<kNPad>(tile, part[0], row0, col0);
        }
        wgmma_wait<0>();
        fence_acc(part[kNB - 1]);
        add_to_tile<kNPad>(tile, part[kNB - 1], row0, 64 * (kNB - 1) + col0);
        warpgroup_sync(kBarBwd);   // every warp is done with the planes and colbuf
      }

      // -- the end of (J, head): dcum's row terms, dx_J out in bf16 ----------
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float rs = quad_sum(rowpart[half]);
        const int j = J * kTile + row0 + 8 * half;
        if (lane % 4 == 0 && j < q) dcum_h[j] += rowacc[half] - rs;
        if (j < q) {
          bf16* out = prm.dx + ((row0_s + j) * prm.heads + h) * P;
#pragma unroll
          for (int jj = 0; jj < P / 8; ++jj)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + col0) =
                __floats2bfloat162_rn(dx[4 * jj + 2 * half], dx[4 * jj + 2 * half + 1]);
        }
      }
      mbar_arrive(smem_addr(&xb_empty));
      ++xu;
      mbar_arrive(smem_addr(&pl_empty));   // the planes' A^T is dead
    }
    // -- dB_J, summed over the set's heads, out in fp32 ---------------------
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = J * kTile + row0 + 8 * half;
      if (j >= q) continue;
      float* out = prm.db + ((row0_s + j) * sets + set) * N;
#pragma unroll
      for (int jj = 0; jj < kNPad / 8; ++jj) {
        if (8 * jj >= N) break;
        *reinterpret_cast<float2*>(out + 8 * jj + col0) =
            make_float2(db[4 * jj + 2 * half], db[4 * jj + 2 * half + 1]);
      }
    }
  }

  // -- dlog_a: dcum with dT at the last row, summed from the chunk's end ----
  warpgroup_sync(kBarBwd);
  for (int r = 0; r < prm.rep; ++r) {
    const int h = h0 + r;
    float* const dcum_h = dcum + r * kMaxChunk;
    if (tid == 0)
      dcum_h[q - 1] += dtot[r] + prm.dt[(static_cast<int64_t>(b) * prm.heads + h) *
                                            prm.n_chunks + c];
    warpgroup_sync(kBarBwd);
    // cum[k] = dcum[q - 1] + ... + dcum[q - 1 - k]
    chunk_cumsum<2>(cum, warp_total, dcum_h + q - 1, -1, q, tid, kBarBwd);
    for (int k = tid; k < q; k += 128)
      prm.dla[(row0_s + q - 1 - k) * prm.heads + h] = cum[k];
    warpgroup_sync(kBarBwd);
  }
  // -- dC, summed over the set's heads, out in fp32 -------------------------
  for (int e = tid; e < tiles * kTile * kNPad / 4; e += 128) {
    const int I = e / (kTile * kNPad / 4);
    const int row = (e / (kNPad / 4)) % kTile;
    const int col = (e % (kNPad / 4)) * 4;
    const int i = I * kTile + row;
    if (i < q && col < N)
      *reinterpret_cast<float4*>(prm.dc + ((row0_s + i) * sets + set) * N + col) =
          *reinterpret_cast<const float4*>(dcacc + I * kTile * kNPad +
                                           acc_off<kNPad>(row, col));
  }
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

// The state pass, forward or (kBwd: x is dy, b is C) backward.
template <int P, int N, bool kBwd>
int launch_state(const Call& call, const void* x, const void* b,
                 cudaStream_t stream) {
  using S = Shape<P, N>;
  const auto kernel = kBwd ? ssd_chunk_state_bwd_kernel<P, N> : ssd_chunk_state_kernel<P, N>;
  static bool raised[kMaxDevices];
  const int err = raise_smem(kernel, S::state_smem(), raised);
  if (err != cudaSuccess) return err;
  const Params& prm = call.prm;
  CUtensorMap map_x, map_b;
  if (!encode_5d(&map_x, x, P, prm.heads, prm, call.x_s) ||
      !encode_5d(&map_b, b, N, prm.groups, prm, call.b_s))
    return cudaErrorInvalidValue;
  const int blocks = prm.batch * prm.heads * prm.n_chunks;
  kernel<<<blocks, kStateThreads, S::state_smem(), stream>>>(map_x, map_b, prm);
  return cudaGetLastError();
}

template <int P, int N>
int launch_state_fwd(const Call& call, const void* x, const void* b,
                     cudaStream_t stream) {
  return launch_state<P, N, false>(call, x, b, stream);
}

template <int P, int N>
int launch_state_bwd(const Call& call, const void* dy, const void* c,
                     cudaStream_t stream) {
  return launch_state<P, N, true>(call, dy, c, stream);
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


template <int P, int N>
int launch_scan_bwd(const Call& call, int rep, const void* x, const void* b,
                    const void* c, const void* dy, BwdParams bp,
                    cudaStream_t stream) {
  using S = BwdShape<P, N>;
  // the static shared memory (barriers, cum, colbuf, ...) is under 2.5 KB
  static_assert(S::smem(kMaxTiles) + 2560 <= 227 * 1024, "shared memory");
  const Params& prm = call.prm;
  if (rep < 1 || rep > kMaxRep || (prm.heads / prm.groups) % rep != 0)
    return cudaErrorInvalidValue;
  static bool raised[kMaxDevices];
  const int err = raise_smem(ssd_chunk_scan_bwd_kernel<P, N>, S::smem(kMaxTiles), raised);
  if (err != cudaSuccess) return err;
  // dy (B, S, H, P) contiguous
  const int64_t dy_s[3] = {static_cast<int64_t>(prm.seq) * prm.heads * P,
                           static_cast<int64_t>(prm.heads) * P, P};
  CUtensorMap map_x, map_dy, map_b, map_c;
  if (!encode_5d(&map_x, x, P, prm.heads, prm, call.x_s) ||
      !encode_5d(&map_dy, dy, P, prm.heads, prm, dy_s) ||
      !encode_5d(&map_b, b, N, prm.groups, prm, call.b_s) ||
      !encode_5d(&map_c, c, N, prm.groups, prm, call.c_s))
    return cudaErrorInvalidValue;
  bp.batch = prm.batch, bp.seq = prm.seq, bp.heads = prm.heads;
  bp.groups = prm.groups, bp.q = prm.q, bp.n_chunks = prm.n_chunks, bp.rep = rep;
  bp.la_sb = prm.la_sb, bp.la_ss = prm.la_ss, bp.la_sh = prm.la_sh;
  const int tiles = (prm.q + kTile - 1) / kTile;
  const int blocks = prm.batch * prm.n_chunks * (prm.heads / rep);
  ssd_chunk_scan_bwd_kernel<P, N><<<blocks, kBwdThreads, S::smem(tiles), stream>>>(
      map_x, map_dy, map_b, map_c, bp);
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
  SSD_DISPATCH(launch_state_fwd, call, x, b, s)
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


// The backward's state pass, from dy (B, S, H, P) bf16 contiguous, log_a,
// C and the forward's states prev (B, H, C, P, N) fp32: gnext (B, H, C, P,
// N) fp32, holding G_c+1 (the gradient of the state leaving chunk c), dinit
// (B, H, P, N) fp32 (G_0, the initial state's gradient) and dt (B, H, C)
// fp32 (exp(T_c) <prev_c, G_c+1>).  dfinal (B, H, P, N) fp32, or null for
// zeros.  dims as for ssd_chunk_state with dy's strides in x's place and
// C's in B's.  Workspace, zeroed by the caller for every call: flags,
// B * H * C int32; ticket, one int32.
int ssd_chunk_state_bwd(const void* dy, const void* log_a, const void* c,
                        const void* states, const void* dfinal, void* gnext,
                        void* dinit, void* dt, void* flags, void* ticket,
                        const long long* dims, void* stream) {
  Call call = {};
  if (!fill(call, dims)) return cudaErrorInvalidValue;
  Params& prm = call.prm;
  prm.la = static_cast<const float*>(log_a);
  prm.init = static_cast<const float*>(dfinal);
  prm.states = static_cast<float*>(gnext);
  prm.final_f32 = static_cast<float*>(dinit);
  prm.prev = static_cast<const float*>(states);
  prm.dt = static_cast<float*>(dt);
  prm.flags = static_cast<int*>(flags);
  prm.ticket = static_cast<int*>(ticket);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SSD_DISPATCH(launch_state_bwd, call, dy, c, s)
}

// The rest of the backward, from x, log_a, B, C, dy (B, S, H, P) bf16
// contiguous, the forward's states and ssd_chunk_state_bwd's gnext and dt:
// dx (B, S, H, P) bf16, dla (B, S, H) fp32 (log_a's gradient), db and dc
// (B, S, H / rep, N) fp32 (B's and C's gradients, each summed over one
// block's `rep` heads), all contiguous, every element written.  dims as
// for ssd_chunk_scan, then rep (a divisor of H / G, at most kMaxRep).
int ssd_chunk_scan_bwd(const void* x, const void* log_a, const void* b,
                       const void* c, const void* dy, const void* states,
                       const void* gnext, const void* dt, void* dx, void* dla,
                       void* db, void* dc, const long long* dims, void* stream) {
  Call call = {};
  if (!fill(call, dims)) return cudaErrorInvalidValue;
  BwdParams bp = {};
  bp.la = static_cast<const float*>(log_a);
  bp.prev = static_cast<const float*>(states);
  bp.gnext = static_cast<const float*>(gnext);
  bp.dt = static_cast<const float*>(dt);
  bp.dx = static_cast<bf16*>(dx);
  bp.dla = static_cast<float*>(dla);
  bp.db = static_cast<float*>(db);
  bp.dc = static_cast<float*>(dc);
  const int rep = static_cast<int>(dims[19]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SSD_DISPATCH(launch_scan_bwd, call, rep, x, b, c, dy, bp, s)
}

}  // extern "C"
