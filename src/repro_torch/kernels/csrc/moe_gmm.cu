// Grouped (ragged) expert matmul for Hopper (sm_90a): y[t] = x[t] @ w[e(t)]
// for rows sorted by expert; bf16 in, fp32 sums, bf16 out.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:66 (grouped_matmul;
// body _gmm_kernel :57, pack pass _pack :25, the pl.pallas_call at :92; jit
// wrapper kernels/ops.py::grouped_matmul).  Same function: x (T, d) rows
// sorted by expert, w (E, d, f), group_sizes (E,) summing to T; an expert
// with no rows contributes nothing.
//
// What bounds it on an H100: at olmoe-1b-7b prefill (T = 4 x 2048 x 8 =
// 65536 rows, d 2048, f 1024, E 64) one call does 2 T d f = 2.7e11 FLOPs
// (0.278 ms at 989 TFLOP/s) against 671 MB of x, w and y (0.200 ms at
// 3.35 TB/s): bound by operations.  At decode (32 rows over 64 experts,
// ~25 of them with rows) it must read only the non-empty experts' weights,
// ~100 MB a call, and is bound by bytes.
//
// What the design does about that:
// * The TPU packed the rows so that each expert's segment filled whole
//   row blocks (a static worst case of T + E*BT rows), then gathered the
//   result back.  Here nothing is packed: a block owns one 128-row tile of
//   one expert and one 128-column tile of the output; rows past the
//   group's end are zero-filled by cp.async and never stored.
// * The grid is the host-known worst case, (ceil(T/128) + E) row tiles x
//   ceil(f/128) column tiles.  Each block reads the E group sizes from the
//   device, prefix-sums them in shared memory (one warp scan), and finds
//   its expert by binary search over the cumulative tile counts; blocks
//   past the last real tile exit at once.  So the host never reads the
//   group sizes (no synchronisation), and an empty expert gets no tile and
//   reads none of its weights.
// * Products on the tensor cores: mma.sync m16n8k16, bf16 operands, fp32
//   accumulators.  8 warps in a 2 x 4 layout, each 64 x 32 outputs; K in
//   steps of 32 through a 3-stage cp.async ring in shared memory, so two
//   k-steps of copies are in flight while one is multiplied.
// * Blocks are numbered column tile fastest: the column tiles of one row
//   tile run together and share its rows in L2, and an expert's weight
//   slab (4 MB at olmoe) is reused by its row tiles while it is in L2.
// * Rows are padded by 16 bytes in shared memory so that ldmatrix reads of
//   8 rows hit 8 different bank groups.
// Left for later: wgmma, TMA and warp specialisation, a persistent grid,
// and gate and up fused into one pass over x.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).  Plain C
// interface, loaded with ctypes; the kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // rows of a tile (all of one expert)
constexpr int kBN = 128;  // output columns of a tile
constexpr int kBK = 32;   // depth of one k-step
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kWM = kBM / kWarpsM;  // 64 rows a warp
constexpr int kWN = kBN / kWarpsN;  // 32 columns a warp
constexpr int kMT = kWM / 16;       // m16 tiles a warp
constexpr int kNT = kWN / 8;        // n8 tiles a warp
constexpr int kStages = 3;
constexpr int kAStride = kBK + 8;  // padded rows, in elements
constexpr int kBStride = kBN + 8;
constexpr int kATile = kBM * kAStride;
constexpr int kBTile = kBK * kBStride;
constexpr int kSmemBytes = kStages * (kATile + kBTile) * sizeof(bf16);
// Most experts the group table in shared memory holds (MAX_EXPERTS in
// repro_torch/kernels/moe_gmm.py).
constexpr int kMaxExperts = 512;

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

__global__ void __launch_bounds__(kThreads)
    grouped_matmul_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ w,
                          const int* __restrict__ group_sizes,
                          bf16* __restrict__ y, int rows, int k_dim,
                          int n_dim, int experts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_a = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_b = s_a + kStages * kATile;
  // Inclusive prefix sums over the experts of their rows and row tiles.
  __shared__ int s_row_end[kMaxExperts];
  __shared__ int s_tile_end[kMaxExperts];

  const int tid = threadIdx.x;
  for (int e = tid; e < experts; e += kThreads) {
    // clamped, so that sizes that do not sum to T never reach past x or y
    s_row_end[e] = min(max(group_sizes[e], 0), rows);
  }
  __syncthreads();
  if (tid < 32) {
    int row_carry = 0;
    int tile_carry = 0;
    for (int base = 0; base < experts; base += 32) {
      const int e = base + tid;
      int size = e < experts ? s_row_end[e] : 0;
      int tiles = (size + kBM - 1) / kBM;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int size_up = __shfl_up_sync(0xffffffffu, size, off);
        const int tiles_up = __shfl_up_sync(0xffffffffu, tiles, off);
        if (tid >= off) {
          size += size_up;
          tiles += tiles_up;
        }
      }
      if (e < experts) {
        s_row_end[e] = min(row_carry + size, rows);
        s_tile_end[e] = tile_carry + tiles;
      }
      row_carry = min(row_carry + __shfl_sync(0xffffffffu, size, 31), rows);
      tile_carry += __shfl_sync(0xffffffffu, tiles, 31);
    }
  }
  __syncthreads();

  const int col_tiles = (n_dim + kBN - 1) / kBN;
  const int row_tile = blockIdx.x / col_tiles;
  const int n0 = (blockIdx.x % col_tiles) * kBN;
  if (row_tile >= s_tile_end[experts - 1]) return;  // past the last real tile
  // The expert of this row tile: the first e with s_tile_end[e] > row_tile
  // (never an empty expert, whose count equals its predecessor's).
  int lo = 0;
  int hi = experts - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s_tile_end[mid] > row_tile)
      hi = mid;
    else
      lo = mid + 1;
  }
  const int e = lo;
  const int first_tile = e > 0 ? s_tile_end[e - 1] : 0;
  const int group_start = e > 0 ? s_row_end[e - 1] : 0;
  const int row0 = group_start + (row_tile - first_tile) * kBM;
  const int row_end = s_row_end[e];
  const bf16* w_e = w + static_cast<int64_t>(e) * k_dim * n_dim;

  const int k_steps = (k_dim + kBK - 1) / kBK;
  // Copies one k-step of the row tile (A) and of the expert's weight (B)
  // into a stage; rows past the group and columns past f or d are zeros.
  auto load_stage = [&](int stage, int step) {
    const int k0 = step * kBK;
    bf16* sa = s_a + stage * kATile;
    bf16* sb = s_b + stage * kBTile;
#pragma unroll
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = i % (kBK / 8);
      const int row = row0 + r;
      const int k = k0 + c * 8;
      const bool valid = row < row_end && k < k_dim;
      cp_async_16(sa + r * kAStride + c * 8,
                  valid ? x + static_cast<int64_t>(row) * k_dim + k : x, valid);
    }
#pragma unroll
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8);
      const int c = i % (kBN / 8);
      const int k = k0 + r;
      const int n = n0 + c * 8;
      const bool valid = k < k_dim && n < n_dim;
      cp_async_16(sb + r * kBStride + c * 8,
                  valid ? w_e + static_cast<int64_t>(k) * n_dim + n : w,
                  valid);
    }
  };

  // Every step commits exactly one cp.async group (empty past the last
  // k-step), so "at most kStages - 2 pending" means "this step's is in".
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_steps) load_stage(s, s);
    cp_async_commit();
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int warp_m = warp / kWarpsN;
  const int warp_n = warp % kWarpsN;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int step = 0; step < k_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tiles are in; every warp is done with
                      // the stage the next copy overwrites
    const int ahead = step + kStages - 1;
    if (ahead < k_steps) load_stage(ahead % kStages, ahead);
    cp_async_commit();

    const bf16* sa = s_a + (step % kStages) * kATile;
    const bf16* sb = s_b + (step % kStages) * kBTile;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4(a[mt], sa + (warp_m * kWM + mt * 16 + lane % 16) * kAStride +
                               kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int nb = 0; nb < kNT / 2; ++nb) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sb + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                      kBStride +
                                  warp_n * kWN + nb * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * nb], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * nb + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + warp_m * kWM + mt * 16 + lane / 4 + r * 8;
      if (row >= row_end) continue;
      bf16* out_row = y + static_cast<int64_t>(row) * n_dim;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + warp_n * kWN + nt * 8 + 2 * (lane % 4);
        if (col < n_dim)  // f is a multiple of 8: col + 1 < f as well
          *reinterpret_cast<__nv_bfloat162*>(out_row + col) =
              __floats2bfloat162_rn(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// x: (rows, k_dim), w: (experts, k_dim, n_dim), y: (rows, n_dim), all
// contiguous bf16; group_sizes: (experts,) int32 on the device.  k_dim and
// n_dim multiples of 8 (16-byte rows).  Returns the launch's cudaError_t
// (0 on success).
int grouped_matmul(const void* x, const void* w, const void* group_sizes,
                   void* y, int rows, int k_dim, int n_dim, int experts,
                   void* stream) {
  if (rows <= 0 || k_dim <= 0 || n_dim <= 0 || experts <= 0 ||
      experts > kMaxExperts || k_dim % 8 || n_dim % 8)
    return cudaErrorInvalidValue;
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const long long row_tiles = (rows + kBM - 1) / kBM + experts;
  const long long blocks = row_tiles * ((n_dim + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grouped_matmul_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(y), rows,
      k_dim, n_dim, experts);
  return cudaGetLastError();
}

}  // extern "C"
