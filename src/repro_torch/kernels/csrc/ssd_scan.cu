// Mamba2 SSD chunked scan for Hopper (sm_90a): bf16 x, B, C; fp32 log-decay;
// fp32 states; bf16 y and final state.
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
// Two kernels, split where the work changes its shape:
// * ssd_chunk_state: one block per (c, h, b) computes state_c with the
//   tensor cores (mma.sync m16n8k16, bf16 operands, fp32 sums) into an
//   fp32 (B, H, C, P, N) buffer, and exp(total_c) into a (B, H, C) one.
//   The last block of each (b, h) to finish (an atomic count per (b, h))
//   then passes the states along the chunks, in place, so the buffer ends
//   up holding prev_c, and writes the final state.  It is the state half
//   of _intra_kernel and the host scan.
// * ssd_chunk_scan: one block per (64-row tile, c, (b, h)) computes its 64
//   rows of y: the inter-chunk term C . prev_c^T, then the intra-chunk term
//   tile by tile as in flash attention (S = C B^T masked by the decay, then
//   S X), the next B and x tiles loading while the current one is used.
//   y_intra never leaves the chip: it is the Y half of _intra_kernel fused
//   with _inter_kernel.
//
// What bounds it on an H100: at the mamba2-780m prefill shape (B 4, S 2048,
// H 48, P 64, N 128, Q 256) the function must move ~110 MB (x and y in
// bf16, B, C, log_a, the final state) and do ~20 GFLOP, so it is bound by
// bytes (~33 us).  This design moves about 2.4x that: x is read by both
// kernels, and the fp32 chunk states are written, passed and read once.
// The Pallas design's fp32 y_intra round trip (~200 MB) is gone.
//
// Precision.  C . B^T multiplies bf16 inputs, exact in fp32 sums.  The three
// products whose left operand is fp32 in the reference (scores * decay,
// x * exp(total - cum), and the state prev) split that operand into two
// bf16 parts, hi = bf16(v) and lo = bf16(v - hi), and run one mma on each:
// about 16 bits of mantissa instead of bf16's 8, at twice the tensor-core
// work, which is not what bounds this function.
//
// The decay is masked before the exponent: exp(cum_i - cum_j) is evaluated
// only where j <= i (and j < Q), since the masked entries have positive
// exponents and overflow.
//
// Any Q <= 256 is taken: rows past Q are zero-filled by cp.async and masked.
// Left for later: wgmma and TMA, and one fused kernel that keeps x on chip
// between the two passes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).  Plain C
// interface, loaded with ctypes; the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // rows per tile: 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunk = 2 * kThreads;  // chunk_cumsum: two rows a thread

struct Params {
  const bf16* x;            // (B, S, H, P), strides x_s*
  const float* la;          // (B, S, H), strides la_s*
  const bf16* b;            // (B, S, G, N), strides b_s*
  const bf16* c;            // (B, S, G, N), strides c_s*
  float* states;            // (B, H, C, P, N) contiguous
  float* decay;             // (B, H, C) contiguous: exp(total_c)
  const float* init;        // (B, H, P, N) contiguous, or null: zeros
  int* counters;            // (B, H) zeros: chunk_state's finished blocks
  bf16* y;                  // (B, S, H, P) contiguous
  bf16* final_state;        // (B, H, P, N) contiguous
  int batch, seq, heads, groups, q, n_chunks;
  int64_t x_sb, x_ss, x_sh, la_sb, la_ss, la_sh;
  int64_t b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) fp32 pair -> its bf16 part and the bf16 of the remainder.
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& big,
                                           uint32_t& small) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 hf = __bfloat1622float2(h);
  big = as_u32(h);
  small = as_u32(__floats2bfloat162_rn(lo - hf.x, hi - hf.y));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Copies rows [row0, row0 + 64) of a (rows, COLS) view with row stride
// `stride` (elements) into a shared tile with rows padded by 8 elements;
// rows at or beyond n_rows are zero-filled.
template <int COLS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          int64_t stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = COLS / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int ch = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < n_rows;
    cp_async_16(tile + r * (COLS + 8) + ch * 8,
                src + (valid ? row * stride + ch * 8 : 0), valid);
  }
}

// cum[r] = la[0] + ... + la[r] for r < q (inclusive, fp32); rows past q
// count la = 0.  la is one head's column, `stride` floats between rows.
// Two rows a thread, a shuffle scan over each warp, then the warps' totals.
__device__ void chunk_cumsum(float* cum, float* warp_total, const float* la,
                             int64_t stride, int q) {
  const int t = threadIdx.x;
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
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += warp_total[w];
  cum[2 * t] = base + excl + v0;
  cum[2 * t + 1] = cum[2 * t] + v1;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Kernel 1: chunk states, then the state passing.  Grid (C, H, B); warp w
// owns state rows p in [16w, 16w + 16) and all N columns:
// state = (x * w)^T B over the chunk's rows, with w_j = exp(total - cum_j).
// ---------------------------------------------------------------------------
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_kernel(const Params prm) {
  static_assert(P % 16 == 0 && N % 16 == 0 && P / 16 <= kWarps, "tile shape");
  __shared__ float weight[kMaxChunk];
  __shared__ float warp_total[kWarps];
  __shared__ bool is_last;
  __shared__ __align__(16) bf16 s_x[kTile * (P + 8)];
  __shared__ __align__(16) bf16 s_b[kTile * (N + 8)];

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (prm.heads / prm.groups);
  const int q = prm.q;
  const int64_t bh = static_cast<int64_t>(b) * prm.heads + h;
  const int64_t row0 = static_cast<int64_t>(c) * q;
  const bf16* x = prm.x + b * prm.x_sb + row0 * prm.x_ss + h * prm.x_sh;
  const bf16* bm = prm.b + b * prm.b_sb + row0 * prm.b_ss + g * prm.b_sg;
  const float* la = prm.la + b * prm.la_sb + h * prm.la_sh;

  chunk_cumsum(weight, warp_total, la + row0 * prm.la_ss, prm.la_ss, q);
  const float total = weight[q - 1];
  if (threadIdx.x == 0)
    prm.decay[bh * prm.n_chunks + c] = expf(total);
  __syncthreads();  // every thread has read total before it is overwritten
  for (int j = threadIdx.x; j < kMaxChunk; j += kThreads)
    weight[j] = j < q ? expf(total - weight[j]) : 0.f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool active = warp < P / 16;
  float acc[N / 8][4];
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j0 = 0; j0 < q; j0 += kTile) {
    load_tile<P>(s_x, x, prm.x_ss, j0, q);
    load_tile<N>(s_b, bm, prm.b_ss, j0, q);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        // A = x^T (rows p, k = j): transposed loads of the [j][p] tile
        uint32_t a[4], a_hi[4], a_lo[4];
        ldmatrix_x4_trans(a, s_x + (kk * 16 + (lane / 16) * 8 + lane % 8) * (P + 8) +
                                 warp * 16 + ((lane / 8) % 2) * 8);
        const int j = j0 + kk * 16 + 2 * (lane % 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jr = j + (r / 2) * 8;  // registers 2, 3 hold k + 8
          const float2 v = unpack_bf16(a[r]);
          split_bf16(v.x * weight[jr], v.y * weight[jr + 1], a_hi[r], a_lo[r]);
        }
#pragma unroll
        for (int nb = 0; nb < N / 16; ++nb) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, s_b + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                          (N + 8) +
                                    nb * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * nb], a_hi, bv[0], bv[1]);
          mma_bf16(acc[2 * nb], a_lo, bv[0], bv[1]);
          mma_bf16(acc[2 * nb + 1], a_hi, bv[2], bv[3]);
          mma_bf16(acc[2 * nb + 1], a_lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the tiles
  }

  float* states = prm.states + bh * prm.n_chunks * P * N;
  if (active) {
    float* out = states + static_cast<int64_t>(c) * P * N;
    const int p = warp * 16 + lane / 4;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const int col = n * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(out + p * N + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(out + (p + 8) * N + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }

  // The last block of this (b, h) to get here passes the states along the
  // chunks (threadFenceReduction: publish, count, and the last one reads).
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(prm.counters + bh, 1) == prm.n_chunks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // states[c] <- prev_c in place; each thread owns the same float4s of
  // every chunk's (P, N) state and carries their running value.
  constexpr int kVec = (P * N + 4 * kThreads - 1) / (4 * kThreads);
  float4 run[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int e = (v * kThreads + threadIdx.x) * 4;
    run[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (prm.init && e < P * N)
      run[v] = *reinterpret_cast<const float4*>(prm.init + bh * P * N + e);
  }
  for (int cc = 0; cc < prm.n_chunks; ++cc) {
    float* st = states + static_cast<int64_t>(cc) * P * N;
    // Other blocks' writes: loaded past L1.  All of a chunk's loads are
    // issued before its first store, since each __stcg orders the memory
    // accesses around it: one memory latency a chunk, not one a float4.
    const float seg = __ldcg(prm.decay + bh * prm.n_chunks + cc);
    float4 s[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int e = (v * kThreads + threadIdx.x) * 4;
      if (e < P * N) s[v] = __ldcg(reinterpret_cast<const float4*>(st + e));
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int e = (v * kThreads + threadIdx.x) * 4;
      if (e >= P * N) continue;
      __stcg(reinterpret_cast<float4*>(st + e), run[v]);
      run[v] = make_float4(run[v].x * seg + s[v].x, run[v].y * seg + s[v].y,
                           run[v].z * seg + s[v].z, run[v].w * seg + s[v].w);
    }
  }
  bf16* fin = prm.final_state + bh * P * N;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int e = (v * kThreads + threadIdx.x) * 4;
    if (e >= P * N) continue;
    *reinterpret_cast<__nv_bfloat162*>(fin + e) =
        __floats2bfloat162_rn(run[v].x, run[v].y);
    *reinterpret_cast<__nv_bfloat162*>(fin + e + 2) =
        __floats2bfloat162_rn(run[v].z, run[v].w);
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: outputs.  Grid (row tiles of Q, C, B * H).  Shared memory
// (dynamic): the C tile of the block's rows and two buffers each of a B and
// an x tile.  prev_c comes from the passed states in fp32, straight from
// global memory into the B fragments, split into bf16 hi + lo.
// ---------------------------------------------------------------------------
template <int P, int N>
struct ScanSmem {
  static constexpr int kC = kTile * (N + 8);   // bf16 elements
  static constexpr int kB = kTile * (N + 8);
  static constexpr int kX = kTile * (P + 8);
  static constexpr int kBytes = (kC + 2 * (kB + kX)) * 2;
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_scan_kernel(const Params prm) {
  static_assert(P % 16 == 0 && N % 16 == 0, "tile shape");
  using L = ScanSmem<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const s_c = reinterpret_cast<bf16*>(smem_raw);
  // buffer k (0 or 1) of the B and x tiles; computed, not indexed from an
  // array, which would put the array in local memory
  auto s_b = [s_c](int k) { return s_c + L::kC + k * (L::kB + L::kX); };
  auto s_x = [s_c](int k) { return s_c + L::kC + k * (L::kB + L::kX) + L::kB; };
  __shared__ float cum[kMaxChunk];
  __shared__ float warp_total[kWarps];

  const int tile = gridDim.x - 1 - blockIdx.x;  // long rows first
  const int c = blockIdx.y;
  const int64_t bh = blockIdx.z;
  const int b = blockIdx.z / prm.heads;
  const int h = blockIdx.z % prm.heads;
  const int g = h / (prm.heads / prm.groups);
  const int q = prm.q;
  const int i0 = tile * kTile;  // first row of this tile within the chunk
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad_row = lane / 4;
  const int quad_col = lane % 4;
  const int row_a = i0 + warp * 16 + quad_row;  // and row_a + 8

  const int64_t row0 = static_cast<int64_t>(c) * q;
  const bf16* cm = prm.c + b * prm.c_sb + row0 * prm.c_ss + g * prm.c_sg;
  const bf16* bm = prm.b + b * prm.b_sb + row0 * prm.b_ss + g * prm.b_sg;
  const bf16* x = prm.x + b * prm.x_sb + row0 * prm.x_ss + h * prm.x_sh;
  load_tile<N>(s_c, cm, prm.c_ss, i0, q);
  load_tile<N>(s_b(0), bm, prm.b_ss, 0, q);
  load_tile<P>(s_x(0), x, prm.x_ss, 0, q);
  cp_async_commit();
  chunk_cumsum(cum, warp_total,
               prm.la + b * prm.la_sb + row0 * prm.la_ss + h * prm.la_sh,
               prm.la_ss, q);
  cp_async_wait_all();
  __syncthreads();

  // Inter-chunk term: y = (C prev^T) exp(cum_i), prev as hi + lo.
  float y[P / 8][4];
#pragma unroll
  for (int n = 0; n < P / 8; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
  {
    const float* prev = prm.states + (bh * prm.n_chunks + c) * P * N;
#pragma unroll 1
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, s_c + (warp * 16 + lane % 16) * (N + 8) + kk * 16 + (lane / 16) * 8);
      const int n0 = kk * 16 + 2 * quad_col;
#pragma unroll
      for (int nb = 0; nb < P / 8; ++nb) {
        // B[k = n][col = p] = prev[p][n]: two consecutive n per register
        const float* row = prev + (nb * 8 + quad_row) * N + n0;
        const float2 v0 = __ldg(reinterpret_cast<const float2*>(row));
        const float2 v1 = __ldg(reinterpret_cast<const float2*>(row + 8));
        uint32_t hi0, lo0, hi1, lo1;
        split_bf16(v0.x, v0.y, hi0, lo0);
        split_bf16(v1.x, v1.y, hi1, lo1);
        mma_bf16(y[nb], a, hi0, hi1);
        mma_bf16(y[nb], a, lo0, lo1);
      }
    }
    // rows past q read cum[q..], which hold cum[q - 1]: finite, unwritten
    const float ea = expf(cum[row_a]);
    const float eb = expf(cum[row_a + 8]);
#pragma unroll
    for (int n = 0; n < P / 8; ++n) {
      y[n][0] *= ea;
      y[n][1] *= ea;
      y[n][2] *= eb;
      y[n][3] *= eb;
    }
  }

  // Intra-chunk term over the key tiles up to this tile's diagonal; tile
  // u + 1 loads into the other buffer while tile u is used.
  for (int u = 0; u <= tile; ++u) {
    const int j0 = u * kTile;
    if (u < tile) {
      load_tile<N>(s_b((u + 1) % 2), bm, prm.b_ss, j0 + kTile, q);
      load_tile<P>(s_x((u + 1) % 2), x, prm.x_ss, j0 + kTile, q);
    }
    cp_async_commit();
    const bf16* sb = s_b(u % 2);
    const bf16* sx = s_x(u % 2);

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, s_c + (warp * 16 + lane % 16) * (N + 8) + kk * 16 +
                         (lane / 16) * 8);
#pragma unroll
      for (int nb = 0; nb < kTile / 16; ++nb) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sb + (nb * 16 + (lane / 16) * 8 + lane % 8) * (N + 8) +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * nb], a, bk[0], bk[1]);
        mma_bf16(s[2 * nb + 1], a, bk[2], bk[3]);
      }
    }
    // decay, masked before the exponent
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row_a + (e / 2) * 8;
        const int j = j0 + n * 8 + 2 * quad_col + (e % 2);
        s[n][e] = j <= i && j < q ? s[n][e] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    // y += S x, S as hi + lo
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], a_hi[0], a_lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], a_hi[1], a_lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], a_hi[2], a_lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], a_hi[3], a_lo[3]);
#pragma unroll
      for (int dn = 0; dn < P / 16; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sx + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                       (P + 8) +
                                  dn * 16 + (lane / 16) * 8);
        mma_bf16(y[2 * dn], a_hi, bv[0], bv[1]);
        mma_bf16(y[2 * dn], a_lo, bv[0], bv[1]);
        mma_bf16(y[2 * dn + 1], a_hi, bv[2], bv[3]);
        mma_bf16(y[2 * dn + 1], a_lo, bv[2], bv[3]);
      }
    }
    cp_async_wait_all();  // tile u + 1 is in
    __syncthreads();      // and every warp is done with tile u's buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_a + r * 8;
    if (i >= q) continue;
    bf16* out = prm.y + ((b * static_cast<int64_t>(prm.seq) + row0 + i) * prm.heads + h) * P;
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * quad_col) =
          __floats2bfloat162_rn(y[n][2 * r], y[n][2 * r + 1]);
  }
}

template <int P, int N>
int launch_state(const Params& prm, cudaStream_t stream) {
  const dim3 grid(prm.n_chunks, prm.heads, prm.batch);
  ssd_chunk_state_kernel<P, N><<<grid, kThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

template <int P, int N>
int launch_scan(const Params& prm, cudaStream_t stream) {
  const int smem = ScanSmem<P, N>::kBytes;
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const dim3 grid((prm.q + kTile - 1) / kTile, prm.n_chunks,
                  prm.batch * prm.heads);
  ssd_chunk_scan_kernel<P, N><<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

// dims: batch, seq, heads, groups, head_dim P, state_dim N, Q, then the
// element strides of dims 0-2 of x, log_a, B and C (12 values).
bool fill(Params& prm, const long long* d, int& p, int& n) {
  prm.batch = static_cast<int>(d[0]);
  prm.seq = static_cast<int>(d[1]);
  prm.heads = static_cast<int>(d[2]);
  prm.groups = static_cast<int>(d[3]);
  p = static_cast<int>(d[4]);
  n = static_cast<int>(d[5]);
  prm.q = static_cast<int>(d[6]);
  prm.x_sb = d[7], prm.x_ss = d[8], prm.x_sh = d[9];
  prm.la_sb = d[10], prm.la_ss = d[11], prm.la_sh = d[12];
  prm.b_sb = d[13], prm.b_ss = d[14], prm.b_sg = d[15];
  prm.c_sb = d[16], prm.c_ss = d[17], prm.c_sg = d[18];
  if (prm.batch <= 0 || prm.seq <= 0 || prm.groups <= 0 || prm.q <= 0 ||
      prm.q > kMaxChunk || prm.seq % prm.q != 0 ||
      prm.heads % prm.groups != 0 || prm.seq / prm.q > 65535 ||
      static_cast<long long>(prm.batch) * prm.heads > 65535)
    return false;
  prm.n_chunks = prm.seq / prm.q;
  return true;
}

}  // namespace

// The (P, N) pairs compiled here are HEAD_STATE_DIMS in
// repro_torch/kernels/ssd_scan.py.  Each function returns the launch's
// cudaError_t (0 on success).
#define SSD_DISPATCH(FN)                                       \
  if (p == 64 && n == 128) return FN<64, 128>(prm, s);         \
  if (p == 64 && n == 64) return FN<64, 64>(prm, s);           \
  if (p == 64 && n == 16) return FN<64, 16>(prm, s);           \
  if (p == 16 && n == 16) return FN<16, 16>(prm, s);           \
  return cudaErrorInvalidValue;

extern "C" {

// states (B, H, C, P, N) fp32, holding prev_c (the state entering chunk
// c), and final_state (B, H, P, N) bf16 <- x, log_a, B and the initial
// state (fp32, or null for zeros).  Workspace: decay, B * H * C fp32;
// counters, B * H int32 zeros.
int ssd_chunk_state(const void* x, const void* log_a, const void* b,
                    const void* init, void* states, void* final_state,
                    void* decay, void* counters, const long long* dims,
                    void* stream) {
  Params prm = {};
  int p, n;
  if (!fill(prm, dims, p, n)) return cudaErrorInvalidValue;
  prm.x = static_cast<const bf16*>(x);
  prm.la = static_cast<const float*>(log_a);
  prm.b = static_cast<const bf16*>(b);
  prm.init = static_cast<const float*>(init);
  prm.states = static_cast<float*>(states);
  prm.final_state = static_cast<bf16*>(final_state);
  prm.decay = static_cast<float*>(decay);
  prm.counters = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SSD_DISPATCH(launch_state)
}

// y (B, S, H, P) bf16 <- x, log_a, B, C and the passed states (prev_c)
// from ssd_chunk_state.
int ssd_chunk_scan(const void* x, const void* log_a, const void* b,
                   const void* c, const void* states, void* y,
                   const long long* dims, void* stream) {
  Params prm = {};
  int p, n;
  if (!fill(prm, dims, p, n)) return cudaErrorInvalidValue;
  prm.x = static_cast<const bf16*>(x);
  prm.la = static_cast<const float*>(log_a);
  prm.b = static_cast<const bf16*>(b);
  prm.c = static_cast<const bf16*>(c);
  prm.states = static_cast<float*>(const_cast<void*>(states));
  prm.y = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SSD_DISPATCH(launch_scan)
}

}  // extern "C"
