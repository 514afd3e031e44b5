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
// Backward: dQ, dK and dV from the forward's log-sum-exp (FA2's algorithm)
// ===========================================================================
//
// The Pallas kernel has no backward: the reference differentiates its plain
// attention with XLA's autodiff.  This is that gradient on the card, for the
// forward above.  From q, k, v, o, dO (bf16) and the forward's LSE (fp32):
//   delta = rowsum(dO o O);  P = exp(Q K^T scale - LSE);  dV = P^T dO;
//   dS = P o (dO V^T - delta);  dQ = dS K scale;  dK = dS^T Q scale,
// with the forward's masks (causal, window, bidirectional, k < S), every sum
// in fp32 and P and dS rounded to bf16 as operands of the last three
// products.  A row whose LSE is -inf (it saw no key) contributes nothing.
//
// What bounds it: five products per allowed (q, k) pair, 2.5x the forward's
// operations, against ~9 tensors of bytes, so operations.  This first
// version recomputes S and dP in both kernels (7 products), with mma.sync
// m16n8k16 tiles fed by ldmatrix from padded shared memory (row stride D + 8
// elements: the 8 rows of an ldmatrix fall on distinct banks); each block
// loads its next inner tile by cp.async into a second buffer while it
// computes the current one.  What holds it back (PERF.md, by ablation):
// the operands' traffic through ldmatrix and the loads; wgmma and TMA are
// later work.
//
// Two kernels, launched in order by one entry point, both deterministic (no
// atomics):
// * dq: one block of 8 warps serves 64 query rows of one (batch, head).  It
//   first computes delta for its rows (written out for the second kernel),
//   then walks the key tiles its rows reach (64 keys each): S and dP for the
//   tile, dS into shared memory in bf16, dQ += dS K in registers.
// * dkv: one block serves a tile of key rows of one (batch, KV head) -- 64
//   rows, or 32 at D 256, so that the dK and dV accumulators (2 x rows x D
//   fp32) take at most 64 registers a thread and do not spill -- and walks
//   every query head of the KV group and, in each, the query tiles that
//   reach its keys: S^T and dP^T, P^T and dS^T into shared memory in bf16,
//   then dV += P^T dO and dK += dS^T Q.  Summing over the group's heads in
//   one block is the GQA reduction, in a fixed order.
// Tiles that no row of the block reaches are skipped, so gemma3's window-512
// layers at S 2048 do about a quarter of a global layer's work.

namespace bwd {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;        // query rows of a dq block; query/key tiles
constexpr int kLdS = kTile + 8;  // row stride (elements) of the bf16 score tiles

template <int D>
struct Shape {
  static constexpr int kLd = D + 8;                 // row stride, elements
  static constexpr int kKeyRows = D >= 256 ? 32 : 64;  // key rows of a dkv block
  // dq: warps 4 (rows) x 2 (columns)
  static constexpr int kDqNt = D / 16;              // n8 tiles of dQ a warp
  static constexpr int kDqSmem =   // Q, dO, 2 x (K, V), dS, LSE, delta
      6 * kTile * kLd * 2 + kTile * kLdS * 2 + 2 * kTile * 4;
  // dkv: warps (key rows / 16) x the rest
  static constexpr int kWm = kKeyRows / 16;
  static constexpr int kWn = kWarps / kWm;
  static constexpr int kScoreNt = kTile / kWn / 8;  // n8 tiles of S^T a warp
  static constexpr int kAccNt = D / 8 / kWn;        // n8 tiles of dK, dV a warp
  // K, V, 2 x (Q, dO), P^T, dS^T, 2 x (LSE, delta)
  static constexpr int kDkvSmem = 2 * kKeyRows * kLd * 2 + 4 * kTile * kLd * 2 +
                                  2 * kKeyRows * kLdS * 2 + 4 * kTile * 4;
  static_assert(D % 16 == 0, "head dim");
  static_assert(kScoreNt % 2 == 0, "score tiles come in pairs");
  static_assert(D % (8 * kWn) == 0, "dK/dV columns split over the warps");
  static_assert(kDqSmem <= 227 * 1024 && kDkvSmem <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies rows [row0, row0 + kRows) of a (S, H, D) slice (rows `stride`
// elements apart) into shared memory at `dst` (row stride D + 8), 16 bytes a
// thread and step; rows at or past S become zeros.  Not waited for.
template <int D, int kRows>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src,
                                          int row0, int seq_len, long long stride) {
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = i % kPerRow;
    const bool valid = row0 + r < seq_len;
    const __nv_bfloat16* p = valid ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(dst + (r * (D + 8) + c * 8) * 2, p, valid);
  }
}

// c[j] (16 x 8, n8 tile j) = A B, A 16 rows of `a` (row-major, k contiguous,
// `ld` bytes a row), B's column n row n of `bt` (n-major, k contiguous), k
// over kDepth.  Each ldmatrix.x4 of bt gives the b fragments of two n8 tiles.
template <int kNt, int kDepth>
__device__ __forceinline__ void warp_abt(float (&c)[kNt][4], uint32_t a,
                                         uint32_t bt, int ld, int lane) {
#pragma unroll
  for (int j = 0; j < kNt; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  const uint32_t a_row = a + (lane % 16) * ld + (lane / 16) * 16;
  const uint32_t b_row = bt + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 16;
#pragma unroll
  for (int k = 0; k < kDepth / 16; ++k) {
    uint32_t af[4];
    ldsm_x4(af, a_row + k * 32);
#pragma unroll
    for (int j = 0; j < kNt; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b_row + j * 8 * ld + k * 32);
      mma16816(c[j], af, bf[0], bf[1]);
      mma16816(c[j + 1], af, bf[2], bf[3]);
    }
  }
}

// c[j] += A B, A 16 rows of `a` (row-major, `lda` bytes a row), B kDepth
// rows of `b` (k-major: row k holds the n columns, `ldb` bytes a row), read
// with ldmatrix's transpose; kNt n8 tiles from b's first column.
template <int kNt, int kDepth>
__device__ __forceinline__ void warp_ab(float (&c)[kNt][4], uint32_t a, int lda,
                                        uint32_t b, int ldb, int lane) {
  const uint32_t a_row = a + (lane % 16) * lda + (lane / 16) * 16;
  const uint32_t b_row = b + (((lane / 8) % 2) * 8 + lane % 8) * ldb + (lane / 16) * 16;
#pragma unroll
  for (int k = 0; k < kDepth / 16; ++k) {
    uint32_t af[4];
    ldsm_x4(af, a_row + k * 32);
#pragma unroll
    for (int j = 0; j + 1 < kNt; j += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b_row + k * 16 * ldb + j * 16);
      mma16816(c[j], af, bf[0], bf[1]);
      mma16816(c[j + 1], af, bf[2], bf[3]);
    }
    if constexpr (kNt % 2 == 1) {
      uint32_t bf[2];
      ldsm_x2_t(bf, b_row + k * 16 * ldb + (kNt - 1) * 16);
      mma16816(c[kNt - 1], af, bf[0], bf[1]);
    }
  }
}

__device__ __forceinline__ bool allowed_pair(int qpos, int kpos, int seq_len,
                                             int causal, int window) {
  return qpos < seq_len && allowed(qpos, kpos, seq_len, causal, window);
}

// A row's LSE in base 2 for exp2: +inf for a row past S or one that saw no
// key (LSE -inf), so that its P is exp2(-inf) = 0.
__device__ __forceinline__ float lse_base2(const float* lse, int qpos, int seq_len) {
  if (qpos >= seq_len) return INFINITY;
  const float x = lse[qpos];
  return x == -INFINITY ? INFINITY : x * 1.4426950408889634f;
}

// Stores a warp's 16 x (8 kNt) fp32 fragments (times `scale`) as bf16 into
// rows [row0, row0 + 16) and columns [col0, ...) of a (S, H, D) slice, rows
// at or past S skipped.
template <int kNt>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&c)[kNt][4],
                                           int row0, int col0, int seq_len,
                                           long long stride, float scale, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + lane / 4 + 8 * half;
    if (r >= seq_len) continue;
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + r * stride + col0 + 8 * j +
                                         2 * (lane % 4)) =
          __floats2bfloat162_rn(c[j][2 * half] * scale, c[j][2 * half + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int seq_len,
    int hq, int hkv, int causal, int window, float scale, float scale_log2) {
  using T = Shape<D>;
  constexpr int kLdB = T::kLd * 2;   // bytes a row
  constexpr int kTileB = kTile * kLdB;
  extern __shared__ unsigned char smem_raw[];
  // Q, dO, then K and V in two buffers each (tile i + 1 loads while tile i
  // is computed), dS, the rows' LSE and delta
  const uint32_t s_q = smem_addr(smem_raw);
  const uint32_t s_do = s_q + kTileB;
  const uint32_t s_k = s_do + kTileB;      // + buffer x kTileB
  const uint32_t s_v = s_k + 2 * kTileB;   // + buffer x kTileB
  const uint32_t s_ds = s_v + 2 * kTileB;
  __nv_bfloat16* ds_ptr = reinterpret_cast<__nv_bfloat16*>(smem_raw + 6 * kTileB);
  float* lse_s = reinterpret_cast<float*>(smem_raw + 6 * kTileB + kTile * kLdS * 2);
  float* delta_s = lse_s + kTile;
  const __nv_bfloat16* do_ptr = reinterpret_cast<const __nv_bfloat16*>(smem_raw + kTileB);

  // the longest causal rows first
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int h_kv = h / (hq / hkv);
  const long long q_stride = static_cast<long long>(hq) * D;
  const long long kv_stride = static_cast<long long>(hkv) * D;
  const long long q_off = (static_cast<long long>(b) * seq_len * hq + h) * D;
  const long long kv_off = (static_cast<long long>(b) * seq_len * hkv + h_kv) * D;
  const float* lse_bh = lse + (static_cast<long long>(b) * hq + h) * seq_len;
  float* delta_bh = delta + (static_cast<long long>(b) * hq + h) * seq_len;

  // the key tiles these rows reach
  const int k_lo = window > 0 ? max(0, q_start - window + 1) : 0;
  const int k_hi = causal ? min(seq_len, q_start + kTile) : seq_len;
  const int t0 = k_lo / kTile;
  const int n_tiles = (k_hi + kTile - 1) / kTile - t0;   // >= 1
  const auto load_kv = [&](int i) {
    load_rows<D, kTile>(s_k + (i & 1) * kTileB, k + kv_off, (t0 + i) * kTile,
                        seq_len, kv_stride);
    load_rows<D, kTile>(s_v + (i & 1) * kTileB, v + kv_off, (t0 + i) * kTile,
                        seq_len, kv_stride);
    cp_async_commit();
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_rows<D, kTile>(s_q, q + q_off, q_start, seq_len, q_stride);
  load_rows<D, kTile>(s_do, dout + q_off, q_start, seq_len, q_stride);
  cp_async_commit();
  load_kv(0);
  cp_async_wait<1>();   // Q and dO are in; the first K and V may still fly
  __syncthreads();

  // delta = rowsum(dO o O) for the block's rows, 8 rows a warp
  for (int rr = 0; rr < kTile / kWarps; ++rr) {
    const int r = warp * (kTile / kWarps) + rr;
    const int qpos = q_start + r;
    float acc = 0.f;
    if (qpos < seq_len) {
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(do_ptr[r * T::kLd + d]) *
               __bfloat162float(o[q_off + qpos * q_stride + d]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = lse_base2(lse_bh, qpos, seq_len);
      if (qpos < seq_len) delta_bh[qpos] = acc;
    }
  }

  // warp (wm, wn): rows 16 wm; score columns 32 wn; dQ columns wn D / 2
  const int wm = warp % 4, wn = warp / 4;
  float acc[T::kDqNt][4];
#pragma unroll
  for (int j = 0; j < T::kDqNt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      load_kv(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile i's K and V (and delta_s, lse_s) are in
    const int k_start = (t0 + i) * kTile;
    const uint32_t k_buf = s_k + (i & 1) * kTileB;
    const uint32_t v_buf = s_v + (i & 1) * kTileB;

    float s[4][4], dp[4][4];
    warp_abt<4, D>(s, s_q + wm * 16 * kLdB, k_buf + wn * 32 * kLdB, kLdB, lane);
    warp_abt<4, D>(dp, s_do + wm * 16 * kLdB, v_buf + wn * 32 * kLdB, kLdB, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 + lane / 4 + 8 * half;
      const float m2 = lse_s[r], dl = delta_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + 8 * j + 2 * (lane % 4);
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = allowed_pair(q_start + r, k_start + c + e, seq_len, causal, window);
          const float p = ok ? exp2_ftz(fmaf(s[j][2 * half + e], scale_log2, -m2)) : 0.f;
          ds[e] = p * (dp[j][2 * half + e] - dl);
        }
        *reinterpret_cast<__nv_bfloat162*>(ds_ptr + r * kLdS + c) =
            __floats2bfloat162_rn(ds[0], ds[1]);
      }
    }
    __syncthreads();
    warp_ab<T::kDqNt, kTile>(acc, s_ds + wm * 16 * kLdS * 2, kLdS * 2,
                             k_buf + wn * (D / 2) * 2, kLdB, lane);
    __syncthreads();   // dS and this K, V buffer are overwritten next
  }
  store_rows<T::kDqNt>(dq + q_off, acc, q_start + wm * 16, wn * (D / 2), seq_len,
                       q_stride, scale, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const __nv_bfloat16* __restrict__ dout,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int seq_len,
    int hq, int hkv, int causal, int window, float scale, float scale_log2) {
  using T = Shape<D>;
  constexpr int kRows = T::kKeyRows;
  constexpr int kLdB = T::kLd * 2;
  constexpr int kTileB = kTile * kLdB;
  extern __shared__ unsigned char smem_raw[];
  // K, V; Q and dO in two buffers each (query tile i + 1 loads while tile i
  // is computed); P^T, dS^T; the query rows' LSE and delta, two buffers
  const uint32_t s_k = smem_addr(smem_raw);
  const uint32_t s_v = s_k + kRows * kLdB;
  const uint32_t s_q = s_v + kRows * kLdB;    // + buffer x kTileB
  const uint32_t s_do = s_q + 2 * kTileB;     // + buffer x kTileB
  const uint32_t s_p = s_do + 2 * kTileB;
  const uint32_t s_ds = s_p + kRows * kLdS * 2;
  unsigned char* score_raw = smem_raw + 2 * kRows * kLdB + 4 * kTileB;
  __nv_bfloat16* p_ptr = reinterpret_cast<__nv_bfloat16*>(score_raw);
  __nv_bfloat16* ds_ptr = p_ptr + kRows * kLdS;
  float* lse_s = reinterpret_cast<float*>(score_raw + 2 * kRows * kLdS * 2);  // [2][64]
  float* delta_s = lse_s + 2 * kTile;                                         // [2][64]

  const int key_start = blockIdx.x * kRows;   // the longest causal columns first
  const int h_kv = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const long long q_stride = static_cast<long long>(hq) * D;
  const long long kv_stride = static_cast<long long>(hkv) * D;
  const long long kv_off = (static_cast<long long>(b) * seq_len * hkv + h_kv) * D;

  // the query tiles that reach these keys, in every head of the KV group:
  // item i is head h_kv * group + i / n_tiles, query tile t0 + i % n_tiles
  const int q_lo = causal ? key_start : 0;
  const int q_hi = window > 0 ? min(seq_len, key_start + kRows - 1 + window) : seq_len;
  const int t0 = q_lo / kTile;
  const int n_tiles = (q_hi + kTile - 1) / kTile - t0;   // >= 1
  const int n_items = group * n_tiles;
  // Issues item i's loads into buffer i & 1: Q and dO by cp.async (then
  // committed), the rows' LSE and delta by the first 64 threads.
  const auto load_item = [&](int i) {
    const int h = h_kv * group + i / n_tiles;
    const int q_start = (t0 + i % n_tiles) * kTile;
    const long long q_off = (static_cast<long long>(b) * seq_len * hq + h) * D;
    load_rows<D, kTile>(s_q + (i & 1) * kTileB, q + q_off, q_start, seq_len, q_stride);
    load_rows<D, kTile>(s_do + (i & 1) * kTileB, dout + q_off, q_start, seq_len,
                        q_stride);
    cp_async_commit();
    if (threadIdx.x < kTile) {
      const long long bh = (static_cast<long long>(b) * hq + h) * seq_len;
      const int qpos = q_start + threadIdx.x;
      lse_s[(i & 1) * kTile + threadIdx.x] = lse_base2(lse + bh, qpos, seq_len);
      delta_s[(i & 1) * kTile + threadIdx.x] = qpos < seq_len ? delta[bh + qpos] : 0.f;
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // warp (wm, wn): key rows 16 wm; score columns wn 64 / kWn; dK, dV columns
  // wn D / kWn
  const int wm = warp % T::kWm, wn = warp / T::kWm;
  constexpr int kScoreCols = kTile / T::kWn;
  constexpr int kAccCols = D / T::kWn;

  load_rows<D, kRows>(s_k, k + kv_off, key_start, seq_len, kv_stride);
  load_rows<D, kRows>(s_v, v + kv_off, key_start, seq_len, kv_stride);
  load_item(0);   // commits K and V with item 0's Q and dO

  float acc_dk[T::kAccNt][4], acc_dv[T::kAccNt][4];
#pragma unroll
  for (int j = 0; j < T::kAccNt; ++j) {
    acc_dk[j][0] = acc_dk[j][1] = acc_dk[j][2] = acc_dk[j][3] = 0.f;
    acc_dv[j][0] = acc_dv[j][1] = acc_dv[j][2] = acc_dv[j][3] = 0.f;
  }

  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) {
      load_item(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // item i's Q, dO, LSE and delta are in
    const int q_start = (t0 + i % n_tiles) * kTile;
    const uint32_t q_buf = s_q + (i & 1) * kTileB;
    const uint32_t do_buf = s_do + (i & 1) * kTileB;
    const float* lse_i = lse_s + (i & 1) * kTile;
    const float* delta_i = delta_s + (i & 1) * kTile;

    float st[T::kScoreNt][4], dpt[T::kScoreNt][4];
    warp_abt<T::kScoreNt, D>(st, s_k + wm * 16 * kLdB, q_buf + wn * kScoreCols * kLdB,
                             kLdB, lane);
    warp_abt<T::kScoreNt, D>(dpt, s_v + wm * 16 * kLdB, do_buf + wn * kScoreCols * kLdB,
                             kLdB, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 + lane / 4 + 8 * half;   // key row
#pragma unroll
      for (int j = 0; j < T::kScoreNt; ++j) {
        const int c = wn * kScoreCols + 8 * j + 2 * (lane % 4);   // query column
        float pv[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = allowed_pair(q_start + c + e, key_start + r, seq_len,
                                       causal, window);
          pv[e] = ok ? exp2_ftz(fmaf(st[j][2 * half + e], scale_log2, -lse_i[c + e]))
                     : 0.f;
          ds[e] = pv[e] * (dpt[j][2 * half + e] - delta_i[c + e]);
        }
        *reinterpret_cast<__nv_bfloat162*>(p_ptr + r * kLdS + c) =
            __floats2bfloat162_rn(pv[0], pv[1]);
        *reinterpret_cast<__nv_bfloat162*>(ds_ptr + r * kLdS + c) =
            __floats2bfloat162_rn(ds[0], ds[1]);
      }
    }
    __syncthreads();
    warp_ab<T::kAccNt, kTile>(acc_dv, s_p + wm * 16 * kLdS * 2, kLdS * 2,
                              do_buf + wn * kAccCols * 2, kLdB, lane);
    warp_ab<T::kAccNt, kTile>(acc_dk, s_ds + wm * 16 * kLdS * 2, kLdS * 2,
                              q_buf + wn * kAccCols * 2, kLdB, lane);
    __syncthreads();   // the score tiles and this item's buffers are overwritten next
  }
  store_rows<T::kAccNt>(dk + kv_off, acc_dk, key_start + wm * 16, wn * kAccCols,
                        seq_len, kv_stride, scale, lane);
  store_rows<T::kAccNt>(dv + kv_off, acc_dv, key_start + wm * 16, wn * kAccCols,
                        seq_len, kv_stride, 1.f, lane);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int batch, int seq_len, int hq, int hkv, int causal,
           int window, cudaStream_t stream) {
  using T = Shape<D>;
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kDqSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kDkvSmem);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  using bf16 = __nv_bfloat16;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid_dq((seq_len + kTile - 1) / kTile, hq, batch);
  flash_attention_bwd_dq_kernel<D><<<grid_dq, kThreads, T::kDqSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o), lse,
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), delta, seq_len, hq,
      hkv, causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkv((seq_len + T::kKeyRows - 1) / T::kKeyRows, hkv, batch);
  flash_attention_bwd_dkv_kernel<D><<<grid_dkv, kThreads, T::kDkvSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lse, delta, static_cast<const bf16*>(dout),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq_len, hq, hkv, causal,
      window, scale, scale_log2);
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
// (k's shape) in bf16, and delta, (B, Hq, S) fp32 scratch.  Launches the dq
// kernel, then the dkv kernel, on `stream`.  Returns the first failing
// launch's cudaError_t (0 on success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* delta, int batch,
                        int seq_len, int hq, int hkv, int head_dim, int causal,
                        int window, void* stream) {
  if (batch <= 0 || seq_len <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_FA_BWD(D)                                                       \
  bwd::launch<D>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, seq_len, hq, hkv, \
                 causal, window, s)
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
