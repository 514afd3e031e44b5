// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out, fp32 softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel, the pl.pallas_call at :127; padding wrapper
// kernels/ops.py::flash_attention).  Same function: exact attention with an
// online softmax; running max m, row sum l and the output accumulator in
// fp32; GQA by reading KV head h / (Hq / Hkv); masks causal, sliding window
// (0 <= q - k < window) or bidirectional, plus the key bound k < S; rows
// whose every key is masked give 0 (the l == 0 guard).
//
// What bounds it on an H100: at the gemma3-1b prefill shapes (B 4, S 2048,
// Hq 4, Hkv 1, D 256) one call does ~1.5e10 (window 512) to ~3.4e10 (global)
// tensor-core FLOPs against ~42 MB of Q, K, V and O, so it is bound by
// operations, not bytes (see PERF.md for the numbers).
//
// What the design does about that:
// * The products QK^T and PV run on the tensor cores (mma.sync m16n8k16,
//   bf16 operands, fp32 accumulators).  A block of 4 warps owns 64 query
//   rows of one (batch, head); each warp owns 16 rows, so the softmax row
//   statistics stay in registers and need only quad shuffles.
// * The TPU's sequential KV grid axis becomes a loop inside the block.
//   Its bounds replace the Pallas tile skip (pl.when(reachable)): key tiles
//   run from max(0, q_start - window + 1) to q_end (causal), so the work
//   done is the mask's, not S^2.
// * K and V tiles are staged in shared memory once per block and read by
//   all 4 warps; the V copy (cp.async) is in flight while QK^T runs.
// * The ragged edge (S not a multiple of 64) is zero-filled by cp.async and
//   masked; nothing is padded in device memory.
// * Query tiles are launched last-first, so the long causal rows start
//   early and the short ones fill the tail.
// * At D = 256 the Q, K and V tiles take 99 KB, above the 48 KB static
//   limit: the shared memory is dynamic, raised per instantiation with
//   cudaFuncSetAttribute.  Rows are padded by 16 bytes so that ldmatrix
//   reads of 8 rows hit 8 different bank groups.
// Left for later: wgmma, TMA and warp specialisation, a double-buffered
// K/V ring, and a persistent grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).  Plain C
// interface, loaded with ctypes; the kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;  // query rows per block (16 per warp)
constexpr int kBlockK = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Finite stand-in for -inf (the Pallas kernel's NEG_INF): a row that has
// seen only masked keys keeps m finite, so exp2(m_old - m_new) is never nan.
constexpr float kMaskedScore = -1.0e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with valid == false nothing is read and the
// 16 bytes of shared memory are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies rows [row0, row0 + 64) of one head into a padded shared tile;
// rows at or beyond seq_len are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* head,
                                          int64_t row_stride, int row0,
                                          int seq_len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = D + 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int ch = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < seq_len;
    const bf16* src = head + (valid ? row * row_stride + ch * 8 : 0);
    cp_async_16(tile + r * kStride + ch * 8, src, valid);
  }
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int seq_len,
                                        int causal, int window) {
  return kpos < seq_len && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v, bf16* __restrict__ o,
                               int seq_len, int hq, int hkv, int causal,
                               int window, float scale_log2) {
  static_assert(kBlockQ == kBlockK, "load_tile serves Q, K and V tiles");
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;  // padded row, in elements
  constexpr int kNBlocks = kBlockK / 8;
  constexpr int kDBlocks = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_k = s_q + kBlockQ * kStride;
  bf16* s_v = s_k + kBlockK * kStride;

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // last tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (hq / hkv);
  const int q_start = q_tile * kBlockQ;

  const int64_t q_row_stride = static_cast<int64_t>(hq) * D;
  const int64_t kv_row_stride = static_cast<int64_t>(hkv) * D;
  const bf16* q_head = q + (static_cast<int64_t>(b) * seq_len * hq + h) * D;
  const bf16* k_head = k + (static_cast<int64_t>(b) * seq_len * hkv + h_kv) * D;
  const bf16* v_head = v + (static_cast<int64_t>(b) * seq_len * hkv + h_kv) * D;
  bf16* o_head = o + (static_cast<int64_t>(b) * seq_len * hq + h) * D;

  // Key tiles this query tile can reach (the Pallas kernel's tile skip).
  int k_lo = 0;
  int k_hi = seq_len;
  if (window > 0) k_lo = max(0, q_start - window + 1);
  if (causal) k_hi = min(seq_len, q_start + kBlockQ);
  const int t_lo = k_lo / kBlockK;
  const int t_hi = (k_hi + kBlockK - 1) / kBlockK;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad_row = lane / 4;  // row within the 8-row half of the warp
  const int quad_col = lane % 4;
  const int row_a = q_start + warp * 16 + quad_row;  // and row_a + 8

  // Copies run one step ahead of the products.  Every step commits exactly
  // one cp.async group (empty when there is nothing left to load), so
  // "wait until one group is pending" always means "the older tile is in".
  load_tile<D>(s_q, q_head, q_row_stride, q_start, seq_len);
  cp_async_commit();
  if (t_lo < t_hi) load_tile<D>(s_k, k_head, kv_row_stride, t_lo * kBlockK, seq_len);
  cp_async_commit();
  if (t_lo < t_hi) load_tile<D>(s_v, v_head, kv_row_stride, t_lo * kBlockK, seq_len);
  cp_async_commit();

  float acc[kDBlocks][4];
#pragma unroll
  for (int j = 0; j < kDBlocks; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kMaskedScore, kMaskedScore};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int t = t_lo; t < t_hi; ++t) {
    const int k_start = t * kBlockK;
    const bool has_next = t + 1 < t_hi;
    // A tile needs the mask only where it crosses the sequence end, the
    // diagonal or the window's far edge; the rest of the band skips it.
    const bool needs_mask =
        k_start + kBlockK > seq_len ||
        (causal && k_start + kBlockK - 1 > q_start) ||
        (window > 0 && k_start < q_start + kBlockQ - window);
    cp_async_wait<1>();  // Q and K(t) are in; V(t) may be in flight
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kNBlocks][4];
#pragma unroll
    for (int n = 0; n < kNBlocks; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, s_q + (warp * 16 + lane % 16) * kStride + kk * 16 +
                         (lane / 16) * 8);
#pragma unroll
      for (int nb = 0; nb < kBlockK / 16; ++nb) {
        uint32_t bk[4];
        ldmatrix_x4(bk, s_k + (nb * 16 + (lane / 16) * 8 + lane % 8) * kStride +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * nb], a, bk[0], bk[1]);
        mma_bf16(s[2 * nb + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with s_k: fetch K(t + 1)
    if (has_next)
      load_tile<D>(s_k, k_head, kv_row_stride, k_start + kBlockK, seq_len);
    cp_async_commit();

    // Mask, then the online softmax in base 2 (scale folded with log2 e).
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row_a + (e / 2) * 8;
        const int kpos = k_start + n * 8 + 2 * quad_col + (e % 2);
        s[n][e] = !needs_mask || allowed(qpos, kpos, seq_len, causal, window)
                      ? s[n][e] * scale_log2
                      : kMaskedScore;
        m_new[e / 2] = fmaxf(m_new[e / 2], s[n][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      const float alpha = exp2f(m[r] - m_new[r]);
      m[r] = m_new[r];
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < kDBlocks; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < kNBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked entries contribute 0 even while m is still kMaskedScore
        const float p =
            s[n][e] == kMaskedScore ? 0.f : exp2f(s[n][e] - m[e / 2]);
        s[n][e] = p;
        l[e / 2] += p;
      }
    }

    cp_async_wait<1>();  // V(t) is in; K(t + 1) may be in flight
    __syncthreads();

    // O += P V; P goes from the S accumulators straight to A fragments.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, s_v + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                        kStride +
                                  dn * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dn], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with s_v: fetch V(t + 1)
    if (has_next)
      load_tile<D>(s_v, v_head, kv_row_stride, k_start + kBlockK, seq_len);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the block, even with no key tile

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] == 0.f ? 1.f : 1.f / l[r];  // the l == 0 guard
    const int qpos = row_a + r * 8;
    if (qpos >= seq_len) continue;
    bf16* out_row = o_head + qpos * q_row_stride;
#pragma unroll
    for (int j = 0; j < kDBlocks; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out_row + j * 8 + 2 * quad_col) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq_len, int hq, int hkv, int causal, int window,
           cudaStream_t stream) {
  const int smem = (kBlockQ + 2 * kBlockK) * (D + 8) * sizeof(bf16);
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_fwd_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, hq, batch);
  const float scale_log2 = rsqrtf(static_cast<float>(D)) * 1.4426950408889634f;
  flash_attention_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), seq_len, hq, hkv,
      causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, S, Hq, D); k, v: (B, S, Hkv, D); all contiguous bf16 on one
// device.  Returns the launch's cudaError_t (0 on success).  The head dims
// compiled here are HEAD_DIMS in repro_torch/kernels/flash_attention.py.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int batch, int seq_len, int hq, int hkv, int head_dim,
                        int causal, int window, void* stream) {
  if (batch <= 0 || seq_len <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, o, batch, seq_len, hq, hkv, causal, window, s);
    case 32: return launch<32>(q, k, v, o, batch, seq_len, hq, hkv, causal, window, s);
    case 80: return launch<80>(q, k, v, o, batch, seq_len, hq, hkv, causal, window, s);
    case 128: return launch<128>(q, k, v, o, batch, seq_len, hq, hkv, causal, window, s);
    case 256: return launch<256>(q, k, v, o, batch, seq_len, hq, hkv, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
