// Flash attention for Hopper (sm_90a), bf16 in, bf16 out, fp32 softmax: the
// forward (with the rows' log-sum-exp as an optional output) and, below it,
// the backward (dQ, dK, dV from that log-sum-exp).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel, the pl.pallas_call at :127; padding wrapper
// kernels/ops.py::flash_attention).  Same function: exact attention with an
// online softmax; running max m, row sum l and the output accumulator in
// fp32; GQA by reading KV head h / (Hq / Hkv) in place; masks causal,
// sliding window (0 <= q - k < window) or bidirectional, plus the key bound
// k < S; rows whose every key is masked give 0 (the l == 0 guard).
//
// What bounds it on an H100: at the gemma3-1b prefill shapes (B 4, S 2048,
// Hq 4, Hkv 1, D 256) one call does ~1.5e10 (window 512) to ~3.4e10 (global)
// tensor-core FLOPs against ~42 MB of Q, K, V and O, so it is bound by
// operations, not bytes (see PERF.md for the numbers): the tensor cores
// must be kept busy, which on Hopper takes wgmma fed by TMA.
//
// What the design does about that:
// * A block serves 128 query rows of one (batch, head) with 3 warpgroups:
//   one producer (a single thread issues every TMA load; setmaxnreg.dec to
//   24 registers) and two consumers of 64 rows each (setmaxnreg.inc to
//   240: 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536).  One if/else on
//   the warpgroup that never rejoins, or ptxas ignores setmaxnreg.
// * Q, K and V arrive by TMA through 4-D tensor maps over (D, H, S, B)
//   with the 128-byte swizzle and boxes 64 columns wide.  D is padded to a
//   multiple of 64 in shared memory only (16, 32 -> 64; 80 -> 128): columns
//   past D and rows past S come in as zeros (the maps' out-of-bounds fill),
//   so nothing is padded in device memory and one swizzle and descriptor
//   scheme serves every head dim (at D 80 the tensor work is 1.6x).
//   Q is loaded once; K and V go through a 2-stage ring with full and
//   empty mbarriers of their own, so QK^T of a tile starts while its V is
//   still in flight (2 stages is the most that fits at D 256).
// * S = Q K^T by wgmma m64nBKk16, both operands K-major in shared memory.
//   BK, the key tile, is 128 up to D_pad 128 and 64 at D 256 (shared
//   memory: 64 KB of Q + 2 x (32 + 32) KB of K and V = 192 KB at D 256;
//   32 + 2 x 64 = 160 KB at D 128).
// * The mask and the online softmax run on the accumulator registers once
//   the wgmma has completed (a branch around a wgmma makes ptxas serialise
//   it).  Only tiles that cross the diagonal, the window's far edge or S
//   are masked.  A row's max and sum are reduced over the 4 threads that
//   share it in the accumulator layout.  Masked scores are -inf; a row
//   that has seen only masked keys subtracts 0 instead of its max, so
//   exp2 gives 0 and never nan.  exp2 is the special-function unit's
//   (ex2.approx.ftz: results below 2^-126 of the row's max become 0).
//   O is rescaled only when some row's max moved in the warp.
// * O += P V by wgmma m64nD_padk16 with A from registers: the fp32 S
//   fragment is rounded to bf16 and is already the A fragment of the next
//   product, k16 slice by k16 slice.  V is read N-major through the
//   instruction's transpose flag: 64-column boxes BK rows deep, so the
//   descriptor's leading offset (next 64 columns) is BK x 128 bytes and its
//   stride offset (next 8 keys) 1024.
// * Overlap.  A consumer issues tile t's QK^T and tile t - 1's PV together
//   and runs tile t's softmax while PV is on the tensor cores.  Up to
//   D_pad 128 the two consumers also take turns issuing their products
//   (named barriers, FA3's ping-pong), so one's softmax runs under the
//   other's products; at D 256 that was slower and is off (PERF.md).
// * The TPU's sequential KV grid axis becomes the loop over key tiles.
//   Its bounds replace the Pallas tile skip (pl.when(reachable)): the
//   producer loads the tiles that any of the block's 128 rows can reach;
//   each consumer runs its products only on the tiles its own 64 rows
//   reach and only waits and releases the others, so the work done is the
//   mask's, not S^2.
// * The log-sum-exp of each row, ln 2 (m + log2 l), goes to an fp32 (B, Hq, S)
//   output when the caller passes one (training: the backward reads it).
// * Epilogue: O / l rounded to bf16 into the consumer's own 64 rows of the
//   Q buffer (Q is dead after its last QK^T), in the swizzled layout the TMA
//   store reads; the store clips rows past S and columns past D.  No
//   atomics: the output is deterministic.
// * Block order.  The (batch, head) pairs are cut into even sections whose
//   K and V fit in L2 together (20 MB of the 50); within a section the
//   longest query tiles run first, the pairs fastest, so the long causal
//   rows start early and the heads of one KV group run together.  Walking
//   every pair at once re-read K and V from device memory at olmoe's and
//   deepseek's shapes (64 and 128 MB of K and V).
//
// What still holds it back (PERF.md): with the softmax removed the
// products run at ~70% of the card's peak; the softmax is not wholly
// hidden under them; each block pays its own Q load, pipeline fill and
// epilogue (no persistent grid), which short rows (window 512) feel most.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).  Plain C
// interface, loaded with ctypes; the kernel allocates nothing.  The tensor
// maps are encoded on the host for every call (hopper.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <array>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kRowsWG = 64;                        // query rows a consumer
constexpr int kBlockQ = kConsumers * kRowsWG;      // query rows a block
constexpr int kChunk = 64;     // head-dim columns of a box: 128 bytes of bf16
constexpr int kStages = 2;     // the K/V ring (3 was no faster at D 128)
// K and V bytes a section of blocks may share in the 50 MB L2
constexpr long long kL2Budget = 20LL << 20;

template <int D>
struct Tiles {
  static constexpr int kDPad = (D + kChunk - 1) / kChunk * kChunk;
  static constexpr int kChunks = kDPad / kChunk;
  static constexpr int kBK = kDPad >= 256 ? 64 : 128;  // keys a tile
  // The consumers take turns on the tensor cores up to D_pad 128; at 256
  // taking turns was slower (PERF.md).
  static constexpr bool kPingPong = kDPad <= 128;
  static constexpr int kQBox = kRowsWG * 128;          // 64 rows x 64 cols
  static constexpr int kQBytes = kConsumers * kChunks * kQBox;
  static constexpr int kKVBox = kBK * 128;             // BK rows x 64 cols
  static constexpr int kKVBytes = kChunks * kKVBox;    // one K or V tile
  // + 1024 bytes to align the buffers on the swizzle's 1024-byte atoms
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
  static_assert(kSmem <= 227 * 1024, "shared memory");
  static_assert(kQBox % 1024 == 0 && kKVBox % 1024 == 0, "swizzle atoms");
};

// 2^x by the special-function unit, subnormal results flushed to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int seq_len,
                                        int causal, int window) {
  return kpos < seq_len && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

// S = Q K^T for one key tile, issued (not waited for): D_pad / 16 k-steps;
// Q and the K tile are K-major rows of 128 bytes, 8-row swizzle atoms 1024
// bytes apart (SBO), a 16-deep slice 32 bytes further along, the next 64
// columns the next box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Tiles<D>::kBK / 2],
                                         uint32_t q_wg, uint32_t k_tile) {
  using T = Tiles<D>;
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      wgmma_ss(s, smem_desc(q_wg + c * T::kQBox + kk * 32, 16, 1024),
               smem_desc(k_tile + c * T::kKVBox + kk * 32, 16, 1024),
               c > 0 || kk > 0);
  }
}

// O += P V for one key tile, issued (not waited for): the V tile N-major,
// rows of 64 columns 128 bytes apart, 8-key atoms 1024 bytes apart (SBO),
// the next 64 columns the next box, BK x 128 bytes on (LBO); a 16-key slice
// starts 16 rows down.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[Tiles<D>::kDPad / 2],
    const uint32_t (&p)[Tiles<D>::kBK / 16][4], uint32_t v_tile) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < T::kBK / 16; ++kk)
    wgmma_rs(o, p[kk], smem_desc(v_tile + kk * 16 * 128, T::kKVBox, 1024));
}

// Sets the scores of masked (q, k) pairs to -inf.  Accumulator element
// 4j + r holds row `row` (+ 8 for r >= 2) and key `key` + 8j (+ 1 for odd r).
template <int BK>
__device__ __forceinline__ void mask_scores(float (&s)[BK / 2], int row,
                                            int key, int seq_len, int causal,
                                            int window) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!allowed(row + 8 * (r / 2), key + 8 * j + (r % 2), seq_len, causal,
                   window))
        s[4 * j + r] = -INFINITY;
    }
  }
}

// The online softmax of one tile, in base 2 with the scale folded with
// log2 e: updates the running max m and this thread's partial sums l of its
// two rows, gives the factor alpha by which O must shrink, and replaces the
// scores by exp2(s scale - m).  A row with no allowed key yet subtracts 0:
// exp2(-inf) = 0, never nan.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) mx[r / 2] = fmaxf(mx[r / 2], s[4 * j + r]);
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 threads that share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2_ftz(m[r] - m_use);
    m[r] = m_new;
    neg_m[r] = -m_use;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = exp2_ftz(fmaf(s[4 * j + r], scale_log2, neg_m[r / 2]));
      s[4 * j + r] = e;
      l[r / 2] += e;
    }
  }
}

// P in bf16: the S fragment's columns 16kk .. 16kk + 15 are the A fragment
// of the kk-th 16-key slice of O += P V.
template <int BK>
__device__ __forceinline__ void to_bf16(const float (&s)[BK / 2],
                                        uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

// O *= alpha, row by row; skipped once the row maxima have settled and
// alpha is 1 on every row of the warp (exact: it multiplies by 1).
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[4 * j + r] *= alpha[r / 2];
  }
}

// With kOn, the two consumers take turns issuing their products (named
// barriers 3 and 4, each counting both warpgroups), so one's softmax runs
// under the other's products.
template <bool kOn>
__device__ __forceinline__ void turn_wait(int wg) {
  if (kOn) asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
template <bool kOn>
__device__ __forceinline__ void turn_pass(int wg) {
  if (kOn) asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_o,
                               float* __restrict__ lse, int seq_len, int hq,
                               int hkv, int causal, int window, int section,
                               float scale_log2) {
  using T = Tiles<D>;
  constexpr int kBK = T::kBK;
  constexpr int kChunks = T::kChunks;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t q_full;
  __shared__ uint64_t k_full[kStages], v_full[kStages];
  __shared__ uint64_t k_empty[kStages], v_empty[kStages];
  // The 128-byte swizzle repeats every 1024 bytes: every box starts on it.
  const uint32_t s_q = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + T::kQBytes;               // + stage x kKVBytes
  const uint32_t s_v = s_k + kStages * T::kKVBytes;

  // Blocks walk sections of `section` (batch, head) pairs, whose K and V
  // fit in L2 together; in a section, query tiles last first and the pairs
  // fastest, so the long causal rows start early and the heads of one KV
  // group run together.
  const int pairs = gridDim.y * gridDim.z;
  const int linear = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int first = linear / (section * gridDim.x) * section;
  const int in_section = min(section, pairs - first);
  const int idx = linear - first * gridDim.x;
  const int q_tile = gridDim.x - 1 - idx / in_section;
  const int pair = first + idx % in_section;
  const int h = pair % hq;
  const int b = pair / hq;
  const int h_kv = h / (hq / hkv);
  const int q_start = q_tile * kBlockQ;

  // Key tiles any of the block's rows can reach (the Pallas tile skip).
  const int k_lo = window > 0 ? max(0, q_start - window + 1) : 0;
  const int k_hi = causal ? min(seq_len, q_start + kBlockQ) : seq_len;
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(smem_addr(&q_full), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&k_full[s]), 1);
      mbar_init(smem_addr(&v_full[s]), 1);
      mbar_init(smem_addr(&k_empty[s]), kConsumers * 4);  // every warp
      mbar_init(smem_addr(&v_empty[s]), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = tid / 128;

  // One if/else on the warpgroup, never rejoined: ptxas honours setmaxnreg
  // only so.
  if (wg == kConsumers) {
    // -- producer: one thread issues every TMA load --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      const uint32_t qf = smem_addr(&q_full);
      mbar_expect_tx(qf, T::kQBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(s_q + (w * kChunks + c) * T::kQBox, &map_q, qf,
                      c * kChunk, h, q_start + w * kRowsWG, b);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo;
        const int stage = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const uint32_t kf = smem_addr(&k_full[stage]);
        const uint32_t vf = smem_addr(&v_full[stage]);
        mbar_wait(smem_addr(&k_empty[stage]), parity);
        mbar_expect_tx(kf, T::kKVBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(s_k + stage * T::kKVBytes + c * T::kKVBox, &map_k, kf,
                      c * kChunk, h_kv, t * kBK, b);
        mbar_wait(smem_addr(&v_empty[stage]), parity);
        mbar_expect_tx(vf, T::kKVBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(s_v + stage * T::kKVBytes + c * T::kKVBox, &map_v, vf,
                      c * kChunk, h_kv, t * kBK, b);
      }
    }
  } else {
    // -- consumers: warpgroup wg owns query rows [q0, q0 + 64) ---------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int q0 = q_start + wg * kRowsWG;
    // accumulator element 4j + r holds row 16 warp + lane / 4 (+ 8 for
    // r >= 2) and column 8j + 2 (lane % 4) (+ 1 for odd r)
    const int row = q0 + warp * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    // This warpgroup's own key tiles, inside the block's, at least one
    // (only rows past S reach none: they are computed and never stored).
    const int lo_key = window > 0 ? max(0, q0 - window + 1) : 0;
    const int hi_key = causal ? min(seq_len, q0 + kRowsWG) : seq_len;
    const int lo = min(max(lo_key / kBK, t_lo), t_hi - 1);
    const int hi = min(max((hi_key + kBK - 1) / kBK, lo + 1), t_hi);
    const uint32_t q_wg = s_q + wg * kChunks * T::kQBox;
    const auto stage_of = [&](int t) { return (t - t_lo) % kStages; };
    const auto parity_of = [&](int t) {
      return static_cast<uint32_t>(((t - t_lo) / kStages) & 1);
    };
    const auto needs_mask = [&](int k_start) {
      // the tile crosses the sequence end, the diagonal or the window's
      // far edge
      return k_start + kBK > seq_len || (causal && k_start + kBK - 1 > q0) ||
             (window > 0 && k_start < q0 + kRowsWG - window);
    };
    // A tile outside this warpgroup's rows' reach: wait for it (so that the
    // release counts toward this tile's phase) and hand it back.
    const auto pass = [&](int t) {
      const int stage = stage_of(t);
      mbar_wait(smem_addr(&k_full[stage]), parity_of(t));
      if (lane == 0) mbar_arrive(smem_addr(&k_empty[stage]));
      mbar_wait(smem_addr(&v_full[stage]), parity_of(t));
      if (lane == 0) mbar_arrive(smem_addr(&v_empty[stage]));
      turn_wait<T::kPingPong>(wg);
      turn_pass<T::kPingPong>(wg);
    };

    float o[T::kDPad / 2];
#pragma unroll
    for (int j = 0; j < T::kDPad / 2; ++j) o[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max, scaled (base 2)
    float l[2] = {0.f, 0.f};               // this thread's partial row sums
    float alpha[2];
    float s[kBK / 2];
    uint32_t p[kBK / 16][4];
    // Q is in (and the epilogue may reuse its buffer) once this completes.
    mbar_wait(smem_addr(&q_full), 0);
    if (T::kPingPong && wg == 0) turn_pass<true>(1);   // the first turn is 0's

    for (int t = t_lo; t < lo; ++t) pass(t);
    // The products of tile t + 1's QK^T and tile t's PV are issued together,
    // and tile t + 1's softmax runs while PV is on the tensor cores.
    {
      const int stage = stage_of(lo);
      mbar_wait(smem_addr(&k_full[stage]), parity_of(lo));
      turn_wait<T::kPingPong>(wg);
      fence_acc(s);
      wgmma_fence();
      issue_qk<D>(s, q_wg, s_k + stage * T::kKVBytes);
      wgmma_commit();
      turn_pass<T::kPingPong>(wg);
      wgmma_wait<0>();
      fence_acc(s);
      if (lane == 0) mbar_arrive(smem_addr(&k_empty[stage]));
      if (needs_mask(lo * kBK))
        mask_scores<kBK>(s, row, lo * kBK + col, seq_len, causal, window);
      online_softmax<kBK>(s, m, l, alpha, scale_log2);
      to_bf16<kBK>(s, p);
    }
    for (int t = lo + 1; t < hi; ++t) {
      const int ks = stage_of(t);
      const int vs = stage_of(t - 1);
      // opaque to the compiler, so that it does not keep Q's descriptors
      // in registers from one tile to the next
      uint32_t q_addr = q_wg;
      asm volatile("" : "+r"(q_addr));
      mbar_wait(smem_addr(&k_full[ks]), parity_of(t));
      turn_wait<T::kPingPong>(wg);
      fence_acc(s);
      wgmma_fence();
      issue_qk<D>(s, q_addr, s_k + ks * T::kKVBytes);
      wgmma_commit();
      rescale(o, alpha);
      mbar_wait(smem_addr(&v_full[vs]), parity_of(t - 1));
      fence_acc(o);
      wgmma_fence();
      issue_pv<D>(o, p, s_v + vs * T::kKVBytes);
      wgmma_commit();
      turn_pass<T::kPingPong>(wg);
      wgmma_wait<1>();   // QK^T is done, PV may still run
      fence_acc(s);
      if (lane == 0) mbar_arrive(smem_addr(&k_empty[ks]));
      if (needs_mask(t * kBK))
        mask_scores<kBK>(s, row, t * kBK + col, seq_len, causal, window);
      online_softmax<kBK>(s, m, l, alpha, scale_log2);
      wgmma_wait<0>();
      fence_acc(o);
      fence_frag(p);
      if (lane == 0) mbar_arrive(smem_addr(&v_empty[vs]));
      to_bf16<kBK>(s, p);
    }
    {
      const int vs = stage_of(hi - 1);
      rescale(o, alpha);
      mbar_wait(smem_addr(&v_full[vs]), parity_of(hi - 1));
      turn_wait<T::kPingPong>(wg);
      fence_acc(o);
      wgmma_fence();
      issue_pv<D>(o, p, s_v + vs * T::kKVBytes);
      wgmma_commit();
      turn_pass<T::kPingPong>(wg);
      wgmma_wait<0>();
      fence_acc(o);
      fence_frag(p);
      if (lane == 0) mbar_arrive(smem_addr(&v_empty[vs]));
    }
    for (int t = hi; t < t_hi; ++t) pass(t);

    // Epilogue: O / l in bf16 into this warpgroup's rows of the Q buffer,
    // laid out as the TMA store reads it (64 x 64 boxes, 128-byte swizzle:
    // column 8j is 16-byte chunk j % 8 of its row in box j / 8, moved to
    // chunk (j % 8) ^ (row % 8)), then one TMA store a box.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];  // the l == 0 guard
    }
    // The log-sum-exp of each row's scaled scores, natural log, for the
    // backward: ln 2 (m + log2 l), -inf for a row that saw no key.
    if (lse != nullptr && lane % 4 == 0) {
      float* lse_bh = lse + (static_cast<long long>(b) * hq + h) * seq_len;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row + 8 * r < seq_len)
          lse_bh[row + 8 * r] =
              l[r] == 0.f ? -INFINITY : (m[r] + log2f(l[r])) * 0.6931471805599453f;
      }
    }
    warpgroup_sync(1 + wg);   // every warp's products are done with Q
    unsigned char* q_ptr = smem_raw + (q_wg - smem_addr(smem_raw));
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = r0 + 8 * half;
#pragma unroll
      for (int j = 0; j < T::kDPad / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            q_ptr + (j / 8) * T::kQBox + rr * 128 + (((j % 8) ^ (rr % 8)) * 16) +
            (lane % 4) * 4) =
            __floats2bfloat162_rn(o[4 * j + 2 * half] * inv[half],
                                  o[4 * j + 2 * half + 1] * inv[half]);
    }
    fence_async_shared();
    warpgroup_sync(1 + wg);
    if (tid % 128 == 0 && q0 < seq_len) {
      for (int c = 0; c < kChunks && c * kChunk < D; ++c)
        tma_store_4d(&map_o, q_wg + c * T::kQBox, c * kChunk, h, q0, b);
      bulk_commit();
      bulk_wait();   // the buffer outlives the stores
    }
  }
}

// Per device: whether each instantiation's shared-memory limit is raised.
constexpr int kMaxDevices = 64;

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int seq_len, int hq, int hkv, int causal, int window,
           cudaStream_t stream) {
  using T = Tiles<D>;
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(flash_attention_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmem);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  // (D, H, S, B), innermost first; boxes of 64 columns x 1 head x rows.
  const auto dims = [&](int heads) {
    return std::array<cuuint64_t, 4>{static_cast<cuuint64_t>(D),
                                     static_cast<cuuint64_t>(heads),
                                     static_cast<cuuint64_t>(seq_len),
                                     static_cast<cuuint64_t>(batch)};
  };
  const auto strides = [&](int heads) {
    const cuuint64_t row = static_cast<cuuint64_t>(heads) * D * 2;
    return std::array<cuuint64_t, 3>{static_cast<cuuint64_t>(D) * 2, row,
                                     row * seq_len};
  };
  const auto q_dims = dims(hq), kv_dims = dims(hkv);
  const auto q_strides = strides(hq), kv_strides = strides(hkv);
  const cuuint32_t q_box[4] = {kChunk, 1, kRowsWG, 1};
  const cuuint32_t kv_box[4] = {kChunk, 1, T::kBK, 1};
  CUtensorMap map_q, map_k, map_v, map_o;
  if (!encode(&map_q, q, 4, q_dims.data(), q_strides.data(), q_box) ||
      !encode(&map_k, k, 4, kv_dims.data(), kv_strides.data(), kv_box) ||
      !encode(&map_v, v, 4, kv_dims.data(), kv_strides.data(), kv_box) ||
      !encode(&map_o, o, 4, q_dims.data(), q_strides.data(), q_box))
    return cudaErrorInvalidValue;
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, hq, batch);
  // (batch, head) pairs a section: whole KV groups whose K and V take at
  // most kL2Budget bytes, the pairs spread evenly over the sections (a
  // small last section would leave SMs idle at the end)
  const long long pairs = static_cast<long long>(hq) * batch;
  const long long kv_bytes = 2LL * seq_len * D * 2;
  const long long group = hq / hkv;
  const long long most = std::max(1LL, kL2Budget / kv_bytes) * group;
  const long long sections = (pairs + most - 1) / most;
  const int section = static_cast<int>(
      ((pairs + sections - 1) / sections + group - 1) / group * group);
  const float scale_log2 = rsqrtf(static_cast<float>(D)) * 1.4426950408889634f;
  flash_attention_fwd_kernel<D><<<grid, kThreads, T::kSmem, stream>>>(
      map_q, map_k, map_v, map_o, lse, seq_len, hq, hkv, causal, window,
      section, scale_log2);
  return cudaGetLastError();
}

// ===========================================================================
// Backward: dQ, dK and dV from the forward's log-sum-exp (FA3's algorithm)
// ===========================================================================
//
// The Pallas kernel has no backward: the reference differentiates its plain
// attention with XLA's autodiff.  This replaces that XLA gradient, for the
// forward above.  From q, k, v, o, dO (bf16) and the forward's LSE (fp32):
//   delta = rowsum(dO o O);  P = exp(Q K^T scale - LSE);  dV = P^T dO;
//   dS = P o (dO V^T - delta);  dQ = dS K scale;  dK = dS^T Q scale,
// with the forward's masks (causal, window, bidirectional, k < S), every sum
// in fp32 and P and dS rounded to bf16 as operands of the last three
// products.  A row whose LSE is -inf (it saw no key) contributes nothing
// and gets dQ = 0.  GQA reads KV head h / (Hq / Hkv) in place.
//
// What bounds it on an H100: five products per allowed (q, k) pair, 2.5x
// the forward's operations, against ~9 tensors of bytes; at gemma3-1b's
// training shapes (B 4, S 2048, Hq 4, Hkv 1, D 256) ~8.6e10 FLOPs (global
// layer) against ~42 MB, so operations (PERF.md has the numbers).  The
// tensor cores must be fed: wgmma from shared memory filled by TMA, and
// each product done once.
//
// Three kernels, launched in order by one entry point:
// * prep: delta = rowsum(dO o O) and the LSE in base 2 (+inf for a row that
//   saw no key or lies past S, so that its P is exp2(-inf) = 0), both fp32
//   (B, Hq, S padded to 64 rows); zeroes the hand-offs' counters and the
//   block ticket.
// * main: a block owns a tile of key rows of one (batch, KV head) and
//   computes S and dP once for every (query row, key) pair that the mask
//   allows in it: 5 products a pair.  Three warpgroups: the producer's
//   (setmaxnreg.dec to 24 registers: one thread issues every load, another
//   is the dQ writer, below) and two consumers (setmaxnreg.inc to 240:
//   128 x 24 + 256 x 240 = 64,512 of 65,536).
//   - K and V of the tile are loaded once, through the forward's 4-D
//     tensor maps (D, H, S, B) with the 128-byte swizzle, 64-column boxes;
//     D is padded to a multiple of 64 in shared memory only (16, 32 -> 64;
//     80 -> 128) by the maps' out-of-bounds zeros, rows past S too.
//   - The block walks query heads of its KV group (the GQA sum of dK and dV
//     is this loop, in a fixed order) and in each the 64-row query tiles
//     that reach its keys, last first.  The producer streams each tile's
//     Q, dO (TMA) and its rows' LSE and delta (bulk copies) through a
//     2-stage ring with full and empty mbarriers (a third stage gained
//     nothing up to D 128 and does not fit at D 256).
//   - S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory (both
//     operands K-major); the mask, P = exp2(S^T scale log2 e - LSE2) and
//     dS^T = P o (dP^T - delta) on the accumulator registers.
//   - dV += P^T dO and dK += dS^T Q by wgmma, dO and Q read N-major (the
//     transpose flag); dQ's part, dS K, by wgmma with dS^T read from shared
//     memory (bf16, 128-byte swizzle) as an MN-major A and K N-major.
//   - Up to D_pad 128 a block has 128 key rows, 64 a consumer: each
//     consumer computes its own S^T and dP^T (m64n64), keeps dK and dV of
//     its rows for every column (m64nD_pad: 128 registers at D 128), takes
//     P^T and dS^T as A fragments from registers (as the forward's PV) and
//     writes dS^T once to shared memory for dQ, whose columns the two
//     consumers split (m64n64 each at D_pad 128; at D_pad 64 both compute
//     the 64 columns and the second discards them: a branch around a wgmma
//     makes ptxas serialise every wgmma of the kernel).  64 key rows a
//     block in D 256's layout was 1.7-1.8x slower at D 128 (PERF.md).
//   - At D 256 the accumulators decide.  dK and dV of 64 key rows are
//     128 KB of fp32, 256 registers a thread for one warpgroup, so a block
//     has 64 key rows and the consumers split the columns: consumer w holds
//     dK, dV and dQ columns [128w, 128w + 128) (m64n128, 64 registers each;
//     ~200 live at the peak, under the 240).  S^T and dP^T are split by
//     query columns instead (m64n32 each, w's 32 queries), written to
//     shared memory as P^T and dS^T in bf16, and both consumers' dV, dK and
//     dQ products read them from there as A.  Shared memory at D 256: K
//     and V 2 x 32 KB, the ring 2 x (Q 32 + dO 32) KB, P^T and dS^T 2 x
//     8 KB, the rows' LSE and delta 1 KB, 1 KB to align = 210 KB of the
//     227 KB; a third ring stage (64 KB) does not fit.  Up to D_pad 128:
//     K, V 2 x 32, the ring 2 x 32, dS^T 16, 2 = 146 KB.
//   - Load balance.  Under a causal mask key tile 0 meets every query
//     tile; with gemma3-1b's one KV head its block would do 4 heads x 32
//     tiles, twice an even share of the work over the SMs.  The host then
//     splits the group's heads over 2 or 4 blocks (split_heads); the parts
//     add their fp32 dK and dV in order through the workspace (the later
//     part waits on the earlier one's counter), the last writes them out.
//   - dK (times scale) and dV leave in bf16 through the ring's shared
//     memory (dead by then) and TMA stores, which clip rows past S and
//     columns past D.  No atomics: each (b, KV head, key tile) is written
//     by one block.
// * convert: dQ = scale x the fp32 accumulator, rounded to bf16.
//
// dQ stays deterministic.  Every key tile that reaches a query tile adds
// its dS K to that tile's fp32 accumulator (the workspace the wrapper
// allocates; the kernel allocates nothing), in ascending key-tile order.
// The consumers leave an item's fp32 part (64 x D_pad floats, in their
// register order) in the item's ring stage, which is exactly its size (Q
// and dO are dead by then).  The dQ writer thread waits (ld.acquire.gpu)
// until the tile's counter says that the key tiles before this one have
// added theirs, stores (the first) or adds (the rest: cp.reduce.async.bulk
// .add.f32) the part by one bulk copy, hands the stage back to the producer
// once the copy has read it, and raises the counter (st.release.gpu) once
// the copy is complete.  So every element is the same sum in the same
// order every run, and the consumers never wait on the hand-off themselves.
// Blocks take their (key tile, b, KV head, part) from an atomic ticket, key
// tile before key tile within a section of (b, KV head) pairs: the block
// of key tile j - 1 has started before the block of key tile j can wait on
// it, so no schedule of the blocks can deadlock; under the causal mask the
// longest key tiles start first.  Sections are one wave of blocks or more
// (while their dQ accumulators, Q, dO, K and V fit 20 MB of L2), used only
// past half a wave of pairs: deepseek-7b's 128 pairs otherwise added to dQ
// tiles that L2 no longer held.  A block walks its query tiles last first,
// so the predecessor in the chain reaches a tile no later than its
// successor (first to last was 1.5x slower over a train step's calls).
//
// What still holds it back (PERF.md: scripts/fa_bwd_ablations.py, and
// scripts/fa_bwd_phases.py, which times each role's phases by clock64):
// at D 256 the consumers wait 35-42% of an item for its Q and dO, because
// a stage is handed back only once the dQ writer's bulk copy has read the
// fp32 part out of it (~3,000 cycles for 64 KB: the SM's rate to L2), and
// the writer is busy 81-89% of the time (turn, read, completion); at D 128
// the elementwise work (~35%) and the products (~31%) of each consumer
// run one after the other, with no overlap between the two consumers.
// Over a train step's calls, removing the products or the elementwise work
// saves 1-3%, the inner loads 11%, the whole dQ hand-off 25%.
//
namespace bwd {

constexpr int kConsumersB = 2;                  // consumer warpgroups
constexpr int kThreadsB = (kConsumersB + 1) * 128;
constexpr int kBM = 64;                         // query rows a step
// named barriers of the two consumers (256 threads; 0 is __syncthreads)
constexpr int kBarScores = 1;   // P^T / dS^T are in shared memory
constexpr int kBarDone = 2;     // both consumers' products of an item are done
constexpr int kBarOut = 3;      // (+ warpgroup: 3, 4) the epilogue's tiles
constexpr int kBarPart = 5;     // the dK/dV partial sums' turn has come, or they are out

template <int D>
struct Shape {
  static constexpr int kDPad = (D + kChunk - 1) / kChunk * kChunk;
  static constexpr int kChunks = kDPad / kChunk;
  // D 256: the consumers split the columns (and S's query columns)
  static constexpr bool kSplit = kDPad > 128;
  static constexpr int kBN = kSplit ? 64 : 128;               // key rows a block
  static constexpr int kScoreN = kSplit ? kBM / 2 : kBM;      // S^T's columns a consumer
  static constexpr int kAccN = kSplit ? kDPad / 2 : kDPad;    // dK/dV columns a consumer
  static constexpr int kDqParts = kDPad >= 128 ? 2 : 1;       // dQ's column parts
  static constexpr int kDqN = kDPad / kDqParts;               // dQ columns a consumer
  static constexpr int kKVBox = kBN * 128;                    // kBN rows x 64 cols
  static constexpr int kKVBytes = kChunks * kKVBox;
  static constexpr int kQBox = kBM * 128;                     // 64 rows x 64 cols
  static constexpr int kQBytes = kChunks * kQBox;
  static constexpr int kStageBytes = 2 * kQBytes;             // Q, then dO
  static constexpr int kScoreBytes = kBN * 128;               // kBN keys x 64 queries, bf16
  static constexpr int kScoreTiles = kSplit ? 2 : 1;          // dS^T (then P^T)
  static constexpr int kRowBytes = 2 * kBM * 4;               // a stage's LSE2, delta
  static constexpr int kStages = 2;                           // the Q/dO ring (3 at D 256: 274 KB)
  static constexpr int kSmem = 2 * kKVBytes + kStages * kStageBytes +
                               kScoreTiles * kScoreBytes + kStages * kRowBytes + 1024;
  // the epilogue's dK and dV tiles, both consumers', in the ring
  static constexpr int kOutBytes = 2 * (kAccN / kChunk) * kQBox;
  static_assert(kSmem <= 227 * 1024, "shared memory");
  static_assert(kConsumersB * kOutBytes <= kStages * kStageBytes, "epilogue");
  // an item's dQ part (64 x D_pad fp32) leaves through its stage's Q and dO
  static_assert(kBM * kDPad * 4 == kStageBytes, "dQ part in a stage");
  static_assert(kKVBox % 1024 == 0 && kQBox % 1024 == 0, "swizzle atoms");
};

// The workspace of one call, in 4-byte words: the dQ accumulator (64 x
// D_pad floats a (b, query head, query tile)), the rows' LSE2 and delta
// (B x Hq x S_pad each); under GQA (Hq > Hkv) the dK/dV partial sums of
// the blocks that split a KV group's heads (2 x 128 x D_pad floats a
// (b, KV head, 128 keys)); the dQ hand-off's counters (B x Hq x query
// tiles); under GQA the partial sums' counters (B x Hkv x S_pad / 64); the
// ticket.  flash_attention.py's _bwd_workspace_bytes is the same.
struct Work {
  float* dq_acc;
  float* lse2;
  float* delta;
  float* dkv_part;   // null without GQA
  int* counters;     // then the partial sums' counters, then the ticket
  int* dkv_flags;
  int* ticket;
  int n_zero;        // the ints from counters to the ticket
};

template <int D>
Work carve(void* base, int batch, int seq_len, int hq, int hkv) {
  const long long n_qt = (seq_len + kBM - 1) / kBM;
  const long long rows = static_cast<long long>(batch) * hq * n_qt * kBM;
  const bool gqa = hq > hkv;
  const long long kv_rows = static_cast<long long>(batch) * hkv * ((seq_len + 127) / 128 * 128);
  const long long n_flags = gqa ? static_cast<long long>(batch) * hkv * n_qt : 0;
  Work w;
  w.dq_acc = static_cast<float*>(base);
  w.lse2 = w.dq_acc + rows * Shape<D>::kDPad;
  w.delta = w.lse2 + rows;
  w.dkv_part = gqa ? w.delta + rows : nullptr;
  w.counters = reinterpret_cast<int*>(w.delta + rows + (gqa ? 2 * kv_rows * Shape<D>::kDPad : 0));
  w.dkv_flags = w.counters + batch * hq * n_qt;
  w.ticket = w.dkv_flags + n_flags;
  w.n_zero = static_cast<int>(batch * hq * n_qt + n_flags + 1);
  return w;
}

struct Params {
  const float* lse2;   // (B, Hq, S_pad): LSE log2 e; +inf: no key, or past S
  const float* delta;  // (B, Hq, S_pad)
  float* dq_acc;
  int* counters;       // (B, Hq, query tiles): key tiles added so far
  float* dkv_part;     // a (b, KV head, key tile)'s dK, dV partial sums
  int* dkv_flags;      // ... and the parts added to them so far
  int* ticket;
  int batch, seq_len, hq, hkv, causal, window, n_qt;
  int split;           // blocks a (b, KV head, key tile): the group's heads split
  int section;         // (b, KV head) pairs whose blocks run key tile by key tile
  float scale, scale_log2;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// a barrier over the two consumer warpgroups
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// Orders this thread's generic-proxy accesses to global memory with its
// bulk (async-proxy) ones.
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// S^T = K Q^T and dP^T = V dO^T for this consumer, issued (not waited for):
// D_pad / 16 k-steps, every operand K-major (rows of 128 bytes, 8-row atoms
// 1024 bytes apart, a 16-deep slice 32 bytes along, the next 64 columns the
// next box).  Up to D_pad 128 consumer wg takes key rows [64 wg, 64 wg + 64)
// and all 64 queries; at D 256 all 64 keys and queries [32 wg, 32 wg + 32).
template <int D>
__device__ __forceinline__ void issue_scores(float (&st)[Shape<D>::kScoreN / 2],
                                             float (&dpt)[Shape<D>::kScoreN / 2],
                                             uint32_t s_k, uint32_t s_v, uint32_t sq,
                                             uint32_t sdo, int wg) {
  using T = Shape<D>;
  const uint32_t a_off = T::kSplit ? 0 : wg * 64 * 128;
  const uint32_t b_off = T::kSplit ? wg * T::kScoreN * 128 : 0;
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const uint32_t a = c * T::kKVBox + a_off + kk * 32;
      const uint32_t b = c * T::kQBox + b_off + kk * 32;
      wgmma_ss<0, 0>(st, smem_desc(s_k + a, 16, 1024), smem_desc(sq + b, 16, 1024),
                       c > 0 || kk > 0);
      wgmma_ss<0, 0>(dpt, smem_desc(s_v + a, 16, 1024), smem_desc(sdo + b, 16, 1024),
                       c > 0 || kk > 0);
    }
  }
}

// P and dS from S^T and dP^T in place.  Element 4j + r holds key `key`
// (+ 8 for r >= 2) and query `query` + 8j (+ 1 for odd r); lse2 and delta
// point at this thread's first query's entries.
template <int N>
__device__ __forceinline__ void grads(float (&s)[N / 2], float (&dp)[N / 2],
                                      const float* lse2, const float* delta, int query,
                                      int key, bool mask, int seq_len, int causal,
                                      int window, float scale_log2) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float p = exp2_ftz(fmaf(s[4 * j + r], scale_log2, -(r % 2 ? l2.y : l2.x)));
      if (mask && !allowed(query + 8 * j + r % 2, key + 8 * (r / 2), seq_len, causal,
                           window))
        p = 0.f;
      s[4 * j + r] = p;
      dp[4 * j + r] = p * (dp[4 * j + r] - (r % 2 ? dl.y : dl.x));
    }
  }
}

// Rounds an S^T-shaped fragment (N query columns from 16-byte chunk
// `chunk0`) to bf16 into a score tile: rows of keys, 128 bytes of queries
// each, 128-byte swizzle (chunk j of row r at (j ^ (r % 8)) x 16).
template <int N>
__device__ __forceinline__ void store_scores(unsigned char* tile, const float (&v)[N / 2],
                                             int row, int chunk0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = row + 8 * half;
      *reinterpret_cast<uint32_t*>(tile + rr * 128 + (((chunk0 + j) ^ (rr % 8)) * 16) +
                                   (lane % 4) * 4) =
          pack_bf16(v[4 * j + 2 * half], v[4 * j + 2 * half + 1]);
    }
  }
}

// One accumulator (64 rows x N columns) times `factor` in bf16 into 64 x 64
// boxes at `out`, laid out as the TMA store reads them (the forward's
// epilogue).
template <int N>
__device__ __forceinline__ void stage_out(unsigned char* out, const float (&acc)[N / 2],
                                          float factor, int warp, int lane) {
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = r0 + 8 * half;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (j / 8) * (kBM * 128) + rr * 128 + (((j % 8) ^ (rr % 8)) * 16) +
          (lane % 4) * 4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * factor,
                                acc[4 * j + 2 * half + 1] * factor);
  }
}

// delta and the base-2 LSE of one row of (B, Hq, S_pad) a warp (8 of D a
// lane), and zeros for the hand-offs' counters.
template <int D>
__global__ void __launch_bounds__(256) flash_attention_bwd_prep_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ lse2,
    float* __restrict__ delta, int* __restrict__ zeros, int n_zero, int seq_len,
    int hq, int s_pad, long long rows) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid < n_zero) zeros[tid] = 0;
  const long long row = tid / 32;   // one warp a row of (B, Hq, S_pad)
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = static_cast<int>(row % s_pad);
  const long long bh = row / s_pad;
  float acc = 0.f, l2 = INFINITY;
  if (s < seq_len) {
    const long long off = ((bh / hq * seq_len + s) * hq + bh % hq) * D;
    for (int d = lane * 8; d < D; d += 256) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + off + d);
      const uint4 g = *reinterpret_cast<const uint4*>(dout + off + d);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv[i]));
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    }
#pragma unroll
    for (int off2 = 16; off2 > 0; off2 /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off2);
    const float x = lse[bh * seq_len + s];
    l2 = x == -INFINITY ? INFINITY : x * 1.4426950408889634f;
  }
  if (lane == 0) {
    lse2[row] = l2;
    delta[row] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsB, 1)
    flash_attention_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const __grid_constant__ CUtensorMap map_dk,
                               const __grid_constant__ CUtensorMap map_dv,
                               const Params prm) {
  using T = Shape<D>;
  constexpr int kBN = T::kBN;
  constexpr int kChunks = T::kChunks;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t kv_full, drained;
  __shared__ uint64_t full[T::kStages], empty[T::kStages], dq_full[T::kStages];
  __shared__ int s_ticket;
  // The 128-byte swizzle repeats every 1024 bytes: every tile starts on it.
  const uint32_t s_k = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_v = s_k + T::kKVBytes;
  const uint32_t s_ring = s_v + T::kKVBytes;   // + stage x (Q, dO)
  const uint32_t s_ds = s_ring + T::kStages * T::kStageBytes;
  const uint32_t s_p = s_ds + T::kScoreBytes;  // at D 256 only
  const uint32_t s_rows = s_ds + T::kScoreTiles * T::kScoreBytes;  // + stage x (LSE2, delta)
  unsigned char* const smem = smem_raw - smem_addr(smem_raw);      // + a shared address

  const int tid = threadIdx.x;
  if (tid == 0) {
    s_ticket = atomicAdd(prm.ticket, 1);
    mbar_init(smem_addr(&kv_full), 1);
    mbar_init(smem_addr(&drained), 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 1);                   // the dQ writer
      mbar_init(smem_addr(&dq_full[s]), kConsumersB * 4);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Tickets run section by section of (batch, KV head) pairs; in a section
  // key tile by key tile, then pair by pair, then the parts of a split
  // group of heads, fastest.
  const int pairs = prm.batch * prm.hkv;
  const int n_kt = (prm.seq_len + kBN - 1) / kBN;
  const int per_pair = n_kt * prm.split;
  const int first = s_ticket / (prm.section * per_pair) * prm.section;
  const int in_section = min(prm.section, pairs - first);
  const int r = s_ticket - first * per_pair;
  const int kt = r / (in_section * prm.split);
  const int pair = first + r % (in_section * prm.split) / prm.split;
  const int part = r % prm.split;
  const int unit = kt * pairs + pair;   // (key tile, b, KV head)
  const int b = pair / prm.hkv;
  const int h_kv = pair % prm.hkv;
  const int group = prm.hq / prm.hkv;
  const int heads = group / prm.split;     // this block's query heads
  const int seq_len = prm.seq_len;
  const int key0 = kt * kBN;
  // The query tiles that these keys reach: the mask's band.
  const int key_end = min(seq_len, key0 + kBN);
  const int q_lo = prm.causal ? key0 : 0;
  const int q_hi = prm.window > 0 ? min(seq_len, key_end - 1 + prm.window) : seq_len;
  const int qt_lo = q_lo / kBM;
  const int n_t = (q_hi + kBM - 1) / kBM - qt_lo;   // >= 1
  const int n_items = heads * n_t;
  // item i: query head h_kv group + part heads + i / n_t, query tile (last
  // first)
  const auto head_of = [&](int i) { return h_kv * group + part * heads + i / n_t; };
  const auto tile_of = [&](int i) { return qt_lo + n_t - 1 - i % n_t; };
  const long long s_pad = static_cast<long long>(prm.n_qt) * kBM;
  // an item's dQ accumulator (64 x D_pad floats, the consumers' register
  // order) and its counter
  const auto dq_tile = [&](int i) {
    return (static_cast<long long>(b) * prm.hq + head_of(i)) * prm.n_qt + tile_of(i);
  };

  const int wg = tid / 128;
  // One if/else on the warpgroup, never rejoined: ptxas honours setmaxnreg
  // only so.
  if (wg == kConsumersB) {
    // -- producer: one thread issues every load ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumersB * 128) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      prefetch_tensormap(&map_do);
      const uint32_t kvf = smem_addr(&kv_full);
      mbar_expect_tx(kvf, 2 * T::kKVBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(s_k + c * T::kKVBox, &map_k, kvf, c * kChunk, h_kv, key0, b);
        tma_load_4d(s_v + c * T::kKVBox, &map_v, kvf, c * kChunk, h_kv, key0, b);
      }
      // item i's Q, dO, LSE2 and delta into stage `stage`
      const auto load_item = [&](int i, int stage) {
        const int h = head_of(i);
        const int q0 = tile_of(i) * kBM;
        const uint32_t bar = smem_addr(&full[stage]);
        const uint32_t sq = s_ring + stage * T::kStageBytes;
        mbar_expect_tx(bar, T::kStageBytes + T::kRowBytes);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sq + c * T::kQBox, &map_q, bar, c * kChunk, h, q0, b);
          tma_load_4d(sq + T::kQBytes + c * T::kQBox, &map_do, bar, c * kChunk, h, q0, b);
        }
        const long long row = (static_cast<long long>(b) * prm.hq + h) * s_pad + q0;
        const uint32_t rows = s_rows + stage * T::kRowBytes;
        bulk_load(rows, prm.lse2 + row, kBM * 4, bar);
        bulk_load(rows + kBM * 4, prm.delta + row, kBM * 4, bar);
      };
      for (int i = 0; i < n_items; ++i) {
        const int stage = i % T::kStages;
        mbar_wait(smem_addr(&empty[stage]), ((i / T::kStages) & 1) ^ 1);
        load_item(i, stage);
      }
    } else if (tid == kConsumersB * 128 + 32) {
      // -- the dQ writer: each item's part, in its key tile's turn ----------
      // The consumers leave an item's fp32 dQ part in its stage (Q and dO
      // are dead by then).  Wait until the key tiles before this one have
      // added theirs to the query tile (ld.acquire of its counter), store
      // (the first) or add (the rest) the part by one bulk copy, hand the
      // stage back once it is read, and raise the counter (st.release) once
      // the copy is complete.
      for (int i = 0; i < n_items; ++i) {
        const int stage = i % T::kStages;
        const int q0 = tile_of(i) * kBM;
        const int turn = kt - (prm.window > 0 ? max(0, q0 - prm.window + 1) : 0) / kBN;
        int* counter = prm.counters + dq_tile(i);
        float* dst = prm.dq_acc + dq_tile(i) * (kBM * T::kDPad);
        const uint32_t src = s_ring + stage * T::kStageBytes;
        mbar_wait(smem_addr(&dq_full[stage]), (i / T::kStages) & 1);
        if (turn > 0) {
          while (ld_acquire(counter) < turn) __nanosleep(32);
          fence_proxy_global();
          bulk_reduce_add_f32(dst, src, T::kStageBytes);
        } else {
          bulk_store(dst, src, T::kStageBytes);
        }
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(smem_addr(&empty[stage]));
        bulk_wait();
        fence_proxy_global();
        __threadfence();
        st_release(counter, turn + 1);
      }
      mbar_arrive(smem_addr(&drained));
    }
  } else {
    // -- consumers ------------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    // This consumer's part of S^T: key rows [r_wg, r_wg + 64) of the tile,
    // query columns [c_wg, c_wg + kScoreN); accumulator element 4j + r holds
    // row 16 warp + lane / 4 (+ 8 for r >= 2), column 8j + 2 (lane % 4)
    // (+ 1 for odd r).
    const int r_wg = T::kSplit ? 0 : 64 * wg;
    const int c_wg = T::kSplit ? T::kScoreN * wg : 0;
    const int key_row = r_wg + warp * 16 + lane / 4;
    const int col = c_wg + 2 * (lane % 4);

    float dk[T::kAccN / 2], dv[T::kAccN / 2];
    zero(dk);
    zero(dv);
    mbar_wait(smem_addr(&kv_full), 0);

    for (int i = 0; i < n_items; ++i) {
      const int q0 = tile_of(i) * kBM;
      const int stage = i % T::kStages;
      const uint32_t sq = s_ring + stage * T::kStageBytes;
      const uint32_t sdo = sq + T::kQBytes;
      const float* lse2_s = reinterpret_cast<const float*>(smem + s_rows + stage * T::kRowBytes);
      const float* delta_s = lse2_s + kBM;
      // opaque to the compiler, so that it does not keep descriptors in
      // registers from one item to the next
      uint32_t k_addr = s_k;
      asm volatile("" : "+r"(k_addr));
      mbar_wait(smem_addr(&full[stage]), (i / T::kStages) & 1);

      float st[T::kScoreN / 2], dpt[T::kScoreN / 2];
      fence_acc(st);
      fence_acc(dpt);
      wgmma_fence();
      issue_scores<D>(st, dpt, k_addr, s_v, sq, sdo, wg);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      {
        // the mask is needed where this consumer's part crosses S, the
        // diagonal or the window's far edge
        const int k_first = key0 + r_wg;
        const int q_first = q0 + c_wg;
        const bool mask = k_first + 64 > seq_len ||
                          (prm.causal && q_first < k_first + 63) ||
                          (prm.window > 0 && q_first + T::kScoreN - 1 - k_first >= prm.window);
        grads<T::kScoreN>(st, dpt, lse2_s + col, delta_s + col, q0 + col, key0 + key_row,
                          mask, seq_len, prm.causal, prm.window, prm.scale_log2);
      }

      float dq[T::kDqN / 2];
      if constexpr (!T::kSplit) {
        // dS^T of this consumer's 64 keys into shared memory for dQ; the
        // other consumer's products of the last item are done with it
        // (kBarDone)
        store_scores<T::kScoreN>(smem + s_ds, dpt, key_row, 0, lane);
        uint32_t pf[kBM / 16][4], dsf[kBM / 16][4];
        to_bf16<kBM>(st, pf);
        to_bf16<kBM>(dpt, dsf);
        fence_async_shared();
        // dV += P^T dO and dK += dS^T Q for this consumer's keys (A from
        // registers; dO and Q N-major: 64-column boxes 64 rows deep, the
        // next 64 columns kQBox on, 8-row atoms 1024 bytes apart), issued
        // before the other consumer's dS^T is in; then dQ = dS K for its
        // columns (dS^T MN-major: rows of keys; K N-major)
        fence_acc(dv);
        fence_acc(dk);
        fence_acc(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_rs(dv, pf[kk], smem_desc(sdo + kk * 16 * 128, T::kQBox, 1024));
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_rs(dk, dsf[kk], smem_desc(sq + kk * 16 * 128, T::kQBox, 1024));
        wgmma_commit();
        consumers_sync(kBarScores);
        const uint32_t k_cols = k_addr + (T::kDqParts > 1 ? wg : 0) * T::kKVBox;
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_ss<1, 1>(dq, smem_desc(s_ds + kk * 16 * 128, T::kScoreBytes, 1024),
                           smem_desc(k_cols + kk * 16 * 128, T::kKVBox, 1024), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_frag(pf);
        fence_frag(dsf);
      } else {
        // P^T and dS^T of this consumer's 32 queries into shared memory,
        // then every product reads both consumers' parts from there:
        // dV, dK += (P^T, dS^T) (K-major A) x (dO, Q) columns [128 wg, +128)
        // N-major; dQ = dS K for the same columns
        store_scores<T::kScoreN>(smem + s_p, st, key_row, c_wg / 8, lane);
        store_scores<T::kScoreN>(smem + s_ds, dpt, key_row, c_wg / 8, lane);
        fence_async_shared();
        consumers_sync(kBarScores);
        const uint32_t box = wg * (T::kAccN / kChunk);
        fence_acc(dv);
        fence_acc(dk);
        fence_acc(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_ss<0, 1>(dv, smem_desc(s_p + kk * 32, 16, 1024),
                           smem_desc(sdo + box * T::kQBox + kk * 16 * 128, T::kQBox, 1024), 1);
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_ss<0, 1>(dk, smem_desc(s_ds + kk * 32, 16, 1024),
                           smem_desc(sq + box * T::kQBox + kk * 16 * 128, T::kQBox, 1024), 1);
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_ss<1, 1>(dq, smem_desc(s_ds + kk * 16 * 128, T::kScoreBytes, 1024),
                           smem_desc(k_addr + box * T::kKVBox + kk * 16 * 128, T::kKVBox, 1024),
                           kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_acc(dv);
      fence_acc(dk);
      fence_acc(dq);
      // Both consumers are done with the stage's Q and dO and with the score
      // tiles: this consumer's dQ part goes to the stage, float4s in
      // register order (conflict-free), for the dQ writer.
      consumers_sync(kBarDone);
      if (wg < T::kDqParts) {
        float4* out = reinterpret_cast<float4*>(smem + sq) + wg * (T::kDqN / 8) * 128 +
                      tid % 128;
#pragma unroll
        for (int j = 0; j < T::kDqN / 8; ++j)
          out[j * 128] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&dq_full[stage]));
    }

    // A group of heads split over blocks: the parts add their dK and dV in
    // order through fp32 partial sums (float4s in register order), each
    // waiting for the one before (ld.acquire of the unit's counter); the
    // last part writes the sums out.
    float4* const sums = reinterpret_cast<float4*>(prm.dkv_part) +
                         static_cast<long long>(unit) * (2 * kBN * T::kDPad / 4) +
                         wg * 2 * (T::kAccN / 8) * 128 + tid % 128;
    int* const sums_counter = prm.dkv_flags + unit;
    if (part > 0) {
      if (tid == 0) {
        while (ld_acquire(sums_counter) < part) __nanosleep(64);
      }
      __syncwarp();
      consumers_sync(kBarPart);
#pragma unroll
      for (int j = 0; j < T::kAccN / 8; ++j) {
        const float4 a = __ldcg(sums + j * 128);
        const float4 c = __ldcg(sums + (T::kAccN / 8 + j) * 128);
        dk[4 * j] += a.x; dk[4 * j + 1] += a.y; dk[4 * j + 2] += a.z; dk[4 * j + 3] += a.w;
        dv[4 * j] += c.x; dv[4 * j + 1] += c.y; dv[4 * j + 2] += c.z; dv[4 * j + 3] += c.w;
      }
    }
    if (part + 1 < prm.split) {
#pragma unroll
      for (int j = 0; j < T::kAccN / 8; ++j) {
        __stcg(sums + j * 128, make_float4(dk[4 * j], dk[4 * j + 1], dk[4 * j + 2], dk[4 * j + 3]));
        __stcg(sums + (T::kAccN / 8 + j) * 128,
               make_float4(dv[4 * j], dv[4 * j + 1], dv[4 * j + 2], dv[4 * j + 3]));
      }
      __threadfence();
      consumers_sync(kBarPart);
      if (tid == 0) st_release(sums_counter, part + 1);
    } else {
      // Epilogue: dK x scale and dV in bf16 into this consumer's part of the
      // ring, once the dQ writer has read its last part there, then one TMA
      // store a 64 x 64 box.
      mbar_wait(smem_addr(&drained), 0);
      const uint32_t s_out = s_ring + wg * T::kOutBytes;
      constexpr int kBoxes = T::kAccN / kChunk;
      stage_out<T::kAccN>(smem + s_out, dk, prm.scale, warp, lane);
      stage_out<T::kAccN>(smem + s_out + kBoxes * T::kQBox, dv, 1.f, warp, lane);
      fence_async_shared();
      warpgroup_sync(kBarOut + wg);
      const int row0 = key0 + r_wg;
      if (tid % 128 == 0 && row0 < seq_len) {
        for (int c = 0; c < kBoxes; ++c) {
          const int gc = (T::kSplit ? wg * kBoxes : 0) + c;   // column box in dK, dV
          if (gc * kChunk >= D) break;
          tma_store_4d(&map_dk, s_out + c * T::kQBox, gc * kChunk, h_kv, row0, b);
          tma_store_4d(&map_dv, s_out + (kBoxes + c) * T::kQBox, gc * kChunk, h_kv, row0, b);
        }
        bulk_commit();
        bulk_wait();   // the shared memory outlives the stores
      }
    }
  }
}

// dQ = scale x the accumulator of one (b, query head, query tile) a block,
// in bf16.  The accumulator's float4 number (part, j, th) holds elements
// 4j .. 4j + 3 of consumer thread th of dQ part `part` (the main kernel's
// register order): rows r and r + 8 (r = 16 (th / 32) + th % 32 / 4),
// columns c and c + 1 (c = part N + 8j + 2 (th % 4)).  A warp takes 8 j's
// by 4 th's of one r, so each of its stores writes 128 contiguous bytes of
// a dQ row.
template <int D>
__global__ void __launch_bounds__(256) flash_attention_bwd_convert_kernel(
    const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq, int seq_len,
    int hq, int n_qt, float scale) {
  using T = Shape<D>;
  constexpr int kJ = T::kDqN / 8;             // float4s of a thread's part
  constexpr int kPartF4 = kJ * 128;
  static_assert(kJ % 8 == 0, "a warp's 8 j's");
  const long long chunk = blockIdx.x;
  const int t = static_cast<int>(chunk % n_qt);
  const long long bh = chunk / n_qt;
  const int h = static_cast<int>(bh % hq);
  const long long b = bh / hq;
  const float4* src = reinterpret_cast<const float4*>(dq_acc + chunk * kBM * T::kDPad);
  for (int f = threadIdx.x; f < T::kDqParts * kPartF4; f += blockDim.x) {
    // f = ((part x 32 + th / 4) x kJ / 8 + j / 8) x 32 + (j % 8) x 4 + th % 4
    const int lane = f % 32;
    const int jb = f / 32 % (kJ / 8);
    const int th4 = f / 32 / (kJ / 8) % 32;
    const int part = f / 32 / (kJ / 8) / 32;
    const int j = jb * 8 + lane / 4;
    const int th = th4 * 4 + lane % 4;
    const int c = part * T::kDqN + 8 * j + 2 * (lane % 4);
    if (c >= D) continue;
    const int row = t * kBM + (th4 / 8) * 16 + th4 % 8;
    const float4 v = src[part * kPartF4 + j * 128 + th];
    if (row < seq_len)
      *reinterpret_cast<__nv_bfloat162*>(dq + ((b * seq_len + row) * hq + h) * D + c) =
          __floats2bfloat162_rn(v.x * scale, v.y * scale);
    if (row + 8 < seq_len)
      *reinterpret_cast<__nv_bfloat162*>(dq + ((b * seq_len + row + 8) * hq + h) * D + c) =
          __floats2bfloat162_rn(v.z * scale, v.w * scale);
  }
}

// The query tiles that key tile kt reaches (the mask's band), as the kernel
// counts them.
inline int reached(int kt, int bn, int seq_len, int causal, int window) {
  const int key0 = kt * bn;
  const int key_end = std::min(seq_len, key0 + bn);
  const int q_lo = causal ? key0 : 0;
  const int q_hi = window > 0 ? std::min(seq_len, key_end - 1 + window) : seq_len;
  return (q_hi + kBM - 1) / kBM - q_lo / kBM;
}

// Blocks a (b, KV head, key tile) takes: 1, or a divisor of the group size
// that splits the group's heads when the block of the longest key tile
// would otherwise run past 1.2x an even share of the work over the SMs
// (gemma3-1b's global layer: Hkv 1, key tile 0 meets every query tile).
template <int D>
int split_heads(int seq_len, int n_kt, int batch, int hq, int hkv, int causal, int window,
                int sms) {
  const int group = hq / hkv;
  long long total = 0;
  int longest = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int n = reached(kt, Shape<D>::kBN, seq_len, causal, window);
    total += n;
    longest = std::max(longest, n);
  }
  const double even = static_cast<double>(total) * group * batch * hkv / sms;
  for (int split = 1; split < group; ++split) {
    if (group % split == 0 && static_cast<double>(longest) * group / split <= 1.2 * even)
      return split;
  }
  return group;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           void* workspace, int batch, int seq_len, int hq, int hkv, int causal,
           int window, cudaStream_t stream) {
  using T = Shape<D>;
  using bf16 = __nv_bfloat16;
  static int device_sms[kMaxDevices];   // 0: the attribute not raised yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (device_sms[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_attention_bwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    device_sms[dev] = sms;
  }
  const int n_qt = (seq_len + kBM - 1) / kBM;
  const long long rows = static_cast<long long>(batch) * hq * n_qt * kBM;
  const Work w = carve<D>(workspace, batch, seq_len, hq, hkv);
  const long long prep_threads = std::max<long long>(rows * 32, w.n_zero);
  flash_attention_bwd_prep_kernel<D><<<static_cast<unsigned>((prep_threads + 255) / 256),
                                       256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, w.lse2, w.delta,
      w.counters, w.n_zero, seq_len, hq, n_qt * kBM, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // (D, H, S, B), innermost first; boxes of 64 columns x 1 head x rows
  const auto dims = [&](int heads) {
    return std::array<cuuint64_t, 4>{static_cast<cuuint64_t>(D),
                                     static_cast<cuuint64_t>(heads),
                                     static_cast<cuuint64_t>(seq_len),
                                     static_cast<cuuint64_t>(batch)};
  };
  const auto strides = [&](int heads) {
    const cuuint64_t row = static_cast<cuuint64_t>(heads) * D * 2;
    return std::array<cuuint64_t, 3>{static_cast<cuuint64_t>(D) * 2, row, row * seq_len};
  };
  const auto q_dims = dims(hq), kv_dims = dims(hkv);
  const auto q_strides = strides(hq), kv_strides = strides(hkv);
  const cuuint32_t q_box[4] = {kChunk, 1, kBM, 1};
  const cuuint32_t kv_box[4] = {kChunk, 1, T::kBN, 1};
  CUtensorMap map_q, map_k, map_v, map_do, map_dk, map_dv;
  if (!encode(&map_q, q, 4, q_dims.data(), q_strides.data(), q_box) ||
      !encode(&map_do, dout, 4, q_dims.data(), q_strides.data(), q_box) ||
      !encode(&map_k, k, 4, kv_dims.data(), kv_strides.data(), kv_box) ||
      !encode(&map_v, v, 4, kv_dims.data(), kv_strides.data(), kv_box) ||
      !encode(&map_dk, dk, 4, kv_dims.data(), kv_strides.data(), q_box) ||
      !encode(&map_dv, dv, 4, kv_dims.data(), kv_strides.data(), q_box))
    return cudaErrorInvalidValue;
  Params prm;
  prm.lse2 = w.lse2;
  prm.delta = w.delta;
  prm.dq_acc = w.dq_acc;
  prm.counters = w.counters;
  prm.dkv_part = w.dkv_part;
  prm.dkv_flags = w.dkv_flags;
  prm.ticket = w.ticket;
  prm.batch = batch;
  prm.seq_len = seq_len;
  prm.hq = hq;
  prm.hkv = hkv;
  prm.causal = causal;
  prm.window = window;
  prm.n_qt = n_qt;
  prm.scale = 1.f / sqrtf(static_cast<float>(D));
  prm.scale_log2 = prm.scale * 1.4426950408889634f;
  const int n_kt = (seq_len + T::kBN - 1) / T::kBN;
  prm.split = split_heads<D>(seq_len, n_kt, batch, hq, hkv, causal, window, device_sms[dev]);
  // Key tile by key tile over every (b, KV head) pair, the key tiles of one
  // pair are pairs x split tickets apart.  Past half a wave of blocks
  // (deepseek-7b: 128 pairs) they run a wave apart, and the later ones add
  // to dQ tiles that L2 no longer holds (134 MB of accumulators re-read and
  // re-written in device memory).  Then the pairs go in sections of about
  // a wave of blocks, or more while their dQ accumulators, Q, dO, K and V
  // fit kL2Budget; sections of fewer pairs only cost balance.
  const int pairs = batch * hkv;
  const long long pair_bytes = static_cast<long long>(hq / hkv) * n_qt * kBM *
                                   (T::kDPad * 4 + 2 * D * 2) +
                               2LL * seq_len * D * 2;
  const int per_pair = n_kt * prm.split;
  prm.section = pairs;
  if (pairs * prm.split > device_sms[dev] / 2)
    prm.section = static_cast<int>(std::min<long long>(
        pairs, std::max<long long>((device_sms[dev] + per_pair - 1) / per_pair,
                                   kL2Budget / pair_bytes)));
  flash_attention_bwd_kernel<D><<<n_kt * batch * hkv * prm.split, kThreadsB, T::kSmem,
                                  stream>>>(
      map_q, map_k, map_v, map_do, map_dk, map_dv, prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_convert_kernel<D><<<batch * hq * n_qt, 256, 0, stream>>>(
      w.dq_acc, static_cast<bf16*>(dq), seq_len, hq, n_qt, prm.scale);
  return cudaGetLastError();
}

}  // namespace bwd

}  // namespace

extern "C" {

// q, o: (B, S, Hq, D); k, v: (B, S, Hkv, D); all contiguous bf16 on one
// device, 16-byte aligned.  lse: (B, Hq, S) fp32, written when not null.
// Returns the launch's cudaError_t (0 on success).  The head dims compiled
// here are HEAD_DIMS in repro_torch/kernels/flash_attention.py.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int batch, int seq_len, int hq, int hkv,
                        int head_dim, int causal, int window, void* stream) {
  if (batch <= 0 || seq_len <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, o, l, batch, seq_len, hq, hkv, causal, window, s);
    case 32: return launch<32>(q, k, v, o, l, batch, seq_len, hq, hkv, causal, window, s);
    case 64: return launch<64>(q, k, v, o, l, batch, seq_len, hq, hkv, causal, window, s);
    case 80: return launch<80>(q, k, v, o, l, batch, seq_len, hq, hkv, causal, window, s);
    case 128: return launch<128>(q, k, v, o, l, batch, seq_len, hq, hkv, causal, window, s);
    case 256: return launch<256>(q, k, v, o, l, batch, seq_len, hq, hkv, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward of flash_attention_fwd: q, k, v, o, dout as there (dout o's
// shape), lse its (B, Hq, S) fp32 output; writes dq (q's shape) and dk, dv
// (k's shape) in bf16.  workspace: fp32 scratch, 16-byte aligned, of the
// bytes that flash_attention.py's _bwd_workspace_bytes gives (bwd::carve
// lays it out: the dQ accumulator, the rows' LSE and delta, the dK/dV
// partial sums of a split group of heads, counters and the ticket), at
// least 4 B Hq S.
// Launches the prep, main and convert kernels on `stream`.
// Returns the first failing launch's cudaError_t (0 on success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* workspace, int batch,
                        int seq_len, int hq, int hkv, int head_dim, int causal,
                        int window, void* stream) {
  if (batch <= 0 || seq_len <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
#define REPRO_FA_BWD(D)                                                      \
  bwd::launch<D>(q, k, v, o, l, dout, dq, dk, dv, workspace, batch, seq_len, \
                 hq, hkv, causal, window, s)
  switch (head_dim) {
    case 16: return REPRO_FA_BWD(16);
    case 32: return REPRO_FA_BWD(32);
    case 64: return REPRO_FA_BWD(64);
    case 80: return REPRO_FA_BWD(80);
    case 128: return REPRO_FA_BWD(128);
    case 256: return REPRO_FA_BWD(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FA_BWD
}

}  // extern "C"
