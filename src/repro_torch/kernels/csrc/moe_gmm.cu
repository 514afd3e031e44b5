// Grouped (ragged) expert matmul for Hopper (sm_90a) and its gradient:
//   forward      y[t]  = x[t] @ w[e(t)]          (grouped_matmul)
//   dx           dx[t] = dy[t] @ w[e(t)]^T       (grouped_matmul_dx)
//   dw           dw[e] = x_e^T @ dy_e            (grouped_matmul_dw)
// for rows sorted by expert; bf16 in, fp32 sums, bf16 out.
//
// The forward replaces the TPU kernel src/repro/kernels/moe_gmm.py:66
// (grouped_matmul; body _gmm_kernel :57, pack pass _pack :25, the
// pl.pallas_call at :92; jit wrapper kernels/ops.py::grouped_matmul).  Same
// function: x (T, d) rows sorted by expert, w (E, d, f), group_sizes (E,)
// summing to T; an expert with no rows contributes nothing.  dx and dw are
// its gradient, which the reference gets by differentiating
// jax.lax.ragged_dot (src/repro/models/moe.py:161-163) with XLA: no Pallas
// kernel of its own.
//
// What bounds them on an H100: at olmoe-1b-7b training (T = 4 x 2048 x 8 =
// 65536 rows, d 2048, f 1024, E 64) each call does 2 T d f = 2.7e11 FLOPs
// (0.278 ms at 989 TFLOP/s) against 671 MB of operands and output read
// and written once (0.200 ms at 3.35 TB/s): bound by operations, so the
// tensor cores must be kept busy.
// At decode (32 rows over 64 experts, ~30 of them with rows) the forward
// does 1.3e8 FLOPs against the non-empty experts' weights, ~126 MB
// (0.038 ms): bound by bytes, so it must read only those weights, with
// enough loads in flight to stream them at the memory's rate.
//
// What the design does about that (the forward; dx and dw below):
// * A block computes 128 x 256 output tiles (at BN 128 each product needs
//   4/3 the operand bytes, and a build of it was slower at every shape).
//   Products by wgmma m64n256k16 (bf16 operands, fp32 accumulators in
//   registers), both operands read from shared memory: x K-major, w as it
//   lies (N-major, the instruction's transpose flag for B).
// * Operands arrive by TMA into a ring of kStages (3) stages, each one
//   k-step (64 deep, 128 bytes of bf16: the 128-byte swizzle) of a 128-row
//   tile of x and a 64 x BN slab of the expert's weight.  x is a 2-D
//   tensor map (d, T): a tile starts at any row; rows past T come in as
//   zeros, rows past the group's end (the next expert's) are loaded and
//   never stored.  w is a 3-D map (f, d, E), so a K tail (d not a multiple
//   of 64) is zero-filled inside the expert and never reads expert e + 1.
// * Warp specialisation: one producer warpgroup (one thread issues every
//   load; setmaxnreg.dec to 40 registers) and two consumer warpgroups
//   (64 rows of the tile each; setmaxnreg.inc to 232), handing stages over
//   by mbarriers: "full" (TMA bytes arrived) and "empty" (every consumer
//   warp's wgmmas on the stage have finished).  No block-wide barrier
//   after set-up.
// * A persistent grid: min(#SMs, worst-case tiles) blocks.  Each block
//   reads the E group sizes from the device and prefix-sums rows and row
//   tiles in shared memory (one warp scan), then walks the tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ... up to the real count, which
//   only the device knows; a tile finds its expert by binary search.  So
//   the host never reads the group sizes (no synchronisation) and an
//   empty expert gets no tile and has none of its weights read.  The ring's
//   barrier phases run on across tiles.  Column tiles of one row tile are
//   neighbours in the walk, so the blocks working at one time share a few
//   row tiles of x and one or two experts' weights in L2.
// * The epilogue rounds the fp32 sums to bf16 (__floats2bfloat162_rn)
//   into a buffer in shared memory laid out as the TMA store of y reads
//   it: 64 x 64 boxes with the 128-byte swizzle, which also spreads the
//   fragment's stores over 32 banks.  A warpgroup whose 64 rows all lie
//   in the group (row < row_end; the rows past it are another tile's)
//   then stores them by TMA, cut at f and T by the tensor map; the stores
//   drain while the next tile is multiplied, and the producer is already
//   loading that tile's stages.  Only where a group ends inside the 64
//   rows do its threads store the rows that are the tile's, 16 bytes at a
//   time.  Stores straight from the fragment (4 bytes, 8 rows a warp
//   instruction) would keep the tensor cores waiting.  No split-K, no
//   atomics: the output is deterministic.
// * The ring gets 3 stages, not 4: the epilogue's buffer (66 KB) takes the
//   fourth's room.
//
// dx and dw, redesigned for what held them back.  The first design (dx the
// forward's kernel with w read K-major; dw the same structure over
// (expert, d-tile, f-tile) tiles) ran at 0.45-0.52 ms a call at olmoe's
// training shape, 54-62% of the bound.  Measured by clock64 phases and
// text-patched variants (scripts/gmm_phases.py, H100 at 700 W): its
// consumers waited for full stages 47-49% of their cycles, a build without
// loads ran 13-15% faster, one without the epilogue 7-10% faster, and one
// without the epilogue but with its buffer's room given to a fourth stage
// as fast as the one without loads.  So the loads' latency (3 stages of 48
// KB in flight) and the epilogue (its TMA stores wait behind the
// producer's loads at the TMA unit) hold the tensor cores; the epilogue's
// share of the tile is no case for a ping-pong schedule, whose 128 x 128
// tiles would read 1.33x the bytes per product.  What the redesign does:
// * 4 stages: the fragment is stored straight from registers
//   (store_fragment), so the 66 KB staging buffer goes to the ring.  (A
//   buffer kept beside 4 stages does not fit; the tile's last stage held
//   as the buffer, with the stores issued by a warp of their own, left the
//   ring short of that stage for too long: slower at dx.)
// * Two blocks a cluster (__cluster_dims__, on neighbouring SMs) take two
//   tiles that multiply by the same 256-wide operand, and each loads half
//   of that operand's stage (two of its four 64-wide boxes) by a TMA
//   multicast into both blocks' shared memory: 32 KB of L2 reads a block a
//   stage for the same 48 KB in shared memory.  dw pairs d-tiles 2p and
//   2p + 1 of one (expert, f-tile), so they share dy_e's rows (and their
//   K, the expert's rows, is the same); dx pairs row tiles 2p and 2p + 1 of
//   one column tile, which share w[e]'s slab when one expert holds both
//   (with ~8 row tiles an expert, most pairs; else each block loads its own
//   slab).  The pair's K is the same either way (f for dx), so the two
//   blocks' rings run in step.  With 4 stages the clusters are 5-15%
//   faster than single blocks.
// * A stage is written into both blocks, so each consumer warp frees it in
//   both (lanes 0 and 1 arrive on the empty barrier at the same offset in
//   each block, 16 arrivals a phase); a block's full barrier counts the
//   bytes of its own loads and of the other block's multicast (its
//   expect_tx may come after some of them: the transaction count goes
//   below zero until then).  The producer's last act waits for every stage
//   once more, so no arrival from the other block is still to come when a
//   block exits; the blocks meet at a cluster barrier after set-up, before
//   any load or arrival reaches the other's barriers.
// * Odd counts: dx's last pair may lack its second row tile (a phantom: the
//   first's rows and slab again, never stored); dw's last pair of d-tiles
//   may lie past d (no x loaded, nothing stored: at qwen2-moe's down
//   projection, f 1408, 11 d-tiles).
// * dx has a kernel of its own (the forward's template no longer reads w
//   two ways); both keep the 128 x 256 tile and the static persistent walk
//   (cluster c takes cluster tiles c, c + clusters, ...): at olmoe's
//   shapes a walk of ~2,000-4,000 tiles over 66 clusters leaves under a
//   round of tail.
//
// dw, grouped_matmul_dw_kernel: numbered expert slowest, then the f-tile,
// then the pair of d-tiles, so the clusters working at one time share one
// or two experts' rows of x and dy in L2; the count is known on the host
// (E x d-tile pairs x f-tiles).  K runs over the expert's rows [off[e],
// off[e] + size[e]) in steps of 64, each a TMA load starting at any row.
// A = x_e^T is M-major (two 64 x 64 boxes of x, one a consumer warpgroup:
// the transpose flag for A), B = dy_e N-major (four 64 x 64 boxes, as w in
// the forward).  The last step of an expert whose size is not a multiple
// of 64 holds the next expert's rows (or zeros past T): each consumer
// warpgroup zeroes them in its box of x and in two of the four boxes of dy
// (in its own block's copy), then both meet at a named barrier before any
// wgmma reads the stage; so a row of another expert never enters the sum.
// (8.5% of the consumers' cycles; a warp of the producer warpgroup that
// zeroed the rows once the stage landed, the consumers waiting for it,
// cost them 15%.)
// An empty expert has no k-step: its tiles store the zeroed accumulators,
// so its slab is exactly zero without the caller filling dw.  Every
// element is summed by one block in row order: no split-K, no atomics,
// deterministic (a gang member's dw has the same bits alone and with
// others folded into the expert axis).  At olmoe's training shape there
// are 64 x 8 x 4 = 2048 cluster tiles.
//
// dx, grouped_matmul_dx_kernel: dy's rows K-major as x in the forward, and
// B = w[e]^T with K = f and N = d, so w's rows lie K-major, wgmma's native
// B layout: no transposed copy of w.  Rows past a group's end (the next
// expert's) are loaded and never stored, as in the forward; one block sums
// each element: deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).  Plain C
// interface, loaded with ctypes; the kernels allocate nothing.  The tensor
// maps are encoded on the host for every call (x moves) by hopper.cuh's
// encoder, which finds the driver's through the runtime
// (cudaGetDriverEntryPoint), so nothing beyond the runtime is linked.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;              // rows of a tile: 64 a consumer warpgroup
constexpr int kBN = 256;              // output columns of a tile
constexpr int kBK = 64;               // depth of a k-step: 128 bytes of bf16
constexpr int kChunkN = 64;           // columns of one TMA box of w (128 bytes)
constexpr int kConsumers = 2;         // consumer warpgroups
constexpr int kCluster = 2;           // dx and dw: blocks a cluster
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kATile = kBM * kBK * 2;                 // bytes of x a stage
constexpr int kWChunk = kBK * kChunkN * 2;            // bytes of one w box
constexpr int kBTile = kBN * kBK * 2;                 // bytes of w a stage
constexpr int kStageBytes = kATile + kBTile;
// The epilogue's bf16 tile: for each consumer warpgroup, BN / 64 boxes of
// 64 rows x 64 columns (128 bytes a row, 128-byte swizzle), as the TMA
// store of y reads them.
constexpr int kOutBox = 64 * kChunkN * 2;
constexpr int kOutBytes = kConsumers * (kBN / kChunkN) * kOutBox;
// Stages of the forward's ring: 3 (48 KB each) fit beside it in 227 KB.
constexpr int kStages = 3;
// + 1024 bytes to align the ring
constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + 1024;
// dx and dw store from registers, so their ring takes the buffer's room: 4
// stages.
constexpr int kBwdStages = 4;
constexpr int kBwdSmemBytes = kBwdStages * kStageBytes + 1024;
// Most experts the group table in shared memory holds (MAX_EXPERTS in
// repro_torch/kernels/moe_gmm.py).
constexpr int kMaxExperts = 512;
static_assert(kSmemBytes <= 227 * 1024 && kBwdSmemBytes <= 227 * 1024, "shared memory");
static_assert(kATile % 1024 == 0 && kWChunk % 1024 == 0, "swizzle atoms");
static_assert(kATile == kConsumers * kWChunk, "dw: one 64 x 64 box of x a warpgroup");

using namespace hopper;

// d (64 x 256, fp32, the wgmma fragment) += a (64 x 16) * b (16 x 256),
// both from shared memory; kTransA / kTransB 1 reads that operand MN-major
// (the instruction's transpose flags), 0 K-major; with accumulate == 0,
// d = a * b.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_tile(float (&d)[128], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA),
        "n"(kTransB));
}


// -- the tile walks ------------------------------------------------------------

// Inclusive prefix sums over the experts of their rows (clamped to `rows`,
// so that sizes that do not sum to T never reach past x or y) and of their
// 128-row tiles, into shared memory: every thread reads, one warp scans.
__device__ __forceinline__ void group_ends(const int* group_sizes, int experts,
                                           int rows, int* s_row_end,
                                           int* s_tile_end) {
  const int tid = threadIdx.x;
  for (int e = tid; e < experts; e += kThreads)
    s_row_end[e] = min(max(group_sizes[e], 0), rows);
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
}

// Where a tile of the forward's or dx's walk lies: its expert, first row,
// the end of the expert's rows and its first output column.
struct Tile {
  int e, row0, row_end, n0;
};

// Row tile `row_tile` of the experts' row tiles in order (n0 left 0).
__device__ __forceinline__ Tile locate_row(int row_tile, int experts,
                                           const int* s_row_end,
                                           const int* s_tile_end) {
  // the first e with s_tile_end[e] > row_tile (never an empty expert, whose
  // count equals its predecessor's)
  int lo = 0;
  int hi = experts - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s_tile_end[mid] > row_tile)
      hi = mid;
    else
      lo = mid + 1;
  }
  Tile t;
  t.e = lo;
  const int first_tile = lo > 0 ? s_tile_end[lo - 1] : 0;
  const int group_start = lo > 0 ? s_row_end[lo - 1] : 0;
  t.row0 = group_start + (row_tile - first_tile) * kBM;
  t.row_end = s_row_end[lo];
  t.n0 = 0;
  return t;
}

// Tile `tile` of the forward's walk: numbered column tile fastest.
__device__ __forceinline__ Tile locate(int tile, int col_tiles, int experts,
                                       const int* s_row_end,
                                       const int* s_tile_end) {
  Tile t = locate_row(tile / col_tiles, experts, s_row_end, s_tile_end);
  t.n0 = (tile % col_tiles) * kBN;
  return t;
}

// This block's tile of dx's cluster tile `tile`: the cluster's two blocks
// take row tiles 2p and 2p + 1 (rank 0 and 1) of the same column tile,
// numbered column tile fastest.  `shared` when both row tiles are one
// expert's: then they multiply by the same slab of w, and each block loads
// half of it into both.  Where the row tiles are odd in number, the last
// pair's second is a phantom: its partner's rows and slab, nothing stored.
struct PairTile {
  Tile t;
  bool shared;
};

__device__ __forceinline__ PairTile locate_pair(int tile, int col_tiles,
                                                int row_tiles, uint32_t rank,
                                                int experts,
                                                const int* s_row_end,
                                                const int* s_tile_end) {
  const int pair = tile / col_tiles;
  const Tile first = locate_row(kCluster * pair, experts, s_row_end, s_tile_end);
  Tile last = first;   // the pair's second row tile, where kCluster is 2
  if (kCluster > 1 && kCluster * pair + 1 < row_tiles)
    last = locate_row(kCluster * pair + 1, experts, s_row_end, s_tile_end);
  else if (kCluster > 1)
    last.row_end = last.row0;   // the phantom: no row of it is stored
  PairTile p;
  p.t = rank == 0 ? first : last;
  p.t.n0 = (tile % col_tiles) * kBN;
  p.shared = first.e == last.e;
  return p;
}

// This block's tile of dw's cluster tile `tile`: its expert, first output
// row (of d) and column (of f), and the expert's rows of x and dy [start,
// end).  The cluster's two blocks take d-tiles 2p and 2p + 1 (rank 0 and
// 1) of one expert and f-tile, so they multiply by the same rows of dy and
// each loads half of them into both.  Numbered expert slowest, then the
// f-tile, the pair of d-tiles fastest; where the d-tiles are odd in
// number, the last pair's second lies past d: it loads no x and stores
// nothing.
struct SlabTile {
  int e, m0, n0, start, end;
};

__device__ __forceinline__ SlabTile locate_slab(int tile, int m_pairs,
                                                int n_tiles, uint32_t rank,
                                                const int* s_row_end) {
  SlabTile t;
  t.e = tile / (m_pairs * n_tiles);
  const int rest = tile % (m_pairs * n_tiles);
  t.n0 = (rest / m_pairs) * kBN;
  t.m0 = ((rest % m_pairs) * kCluster + rank) * kBM;
  t.start = t.e > 0 ? s_row_end[t.e - 1] : 0;
  t.end = s_row_end[t.e];
  return t;
}

// `consumer_warps`: the arrivals that free a stage (every consumer warp of
// the block, or of both blocks of a cluster).
template <int kRing>
__device__ __forceinline__ void init_ring(uint64_t* full_bar,
                                          uint64_t* empty_bar,
                                          int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// A consumer warp gives a stage back to both blocks of its cluster (lane r
// arrives in block r, all at once): the stage's loads write into both, so
// neither may refill it before both have read it.
__device__ __forceinline__ void release_in_cluster(uint64_t* empty_bar, int stage,
                                                   int lane) {
  if (lane < kCluster) mbar_arrive_cluster(smem_addr(&empty_bar[stage]), lane);
}

// The producer's last act in a cluster kernel: takes every stage once more,
// so the consumers of both blocks have released all this block's loads and
// no arrival from the other block is still to come when it exits.
__device__ __forceinline__ void drain_ring(uint64_t* empty_bar, int it) {
  for (int s = 0; s < kBwdStages; ++s, ++it)
    mbar_wait(smem_addr(&empty_bar[it % kBwdStages]), ((it / kBwdStages) & 1) ^ 1);
}

// Rounds a consumer warpgroup's fp32 fragment to bf16 into its 64 rows of
// the epilogue's buffer: fragment element 4j + r holds row 16 warp +
// lane / 4 (+ 8 for r >= 2) and columns 8j + 2 (lane % 4) (+ 1 for odd
// r); column 8j lies in box j / 8, at 16-byte chunk j % 8 of its row,
// which the 128-byte swizzle moves to chunk (j % 8) ^ (row % 8).
__device__ __forceinline__ void stage_out(const float (&acc)[kBN / 2],
                                          unsigned char* out_ptr, int warp,
                                          int lane) {
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          out_ptr + (j / 8) * kOutBox + (r0 + 8 * half) * 128 +
          (((j % 8) ^ (r0 % 8)) * 16) + (lane % 4) * 4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                acc[4 * j + 2 * half + 1]);
  }
}

// A barrier over the two consumer warpgroups (id 3; 1 and 2 are theirs).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

// dx's and dw's epilogue: a consumer warpgroup's fp32 fragment, rounded to
// bf16, stored straight from registers: rows [row0, row0 + 64) x columns
// [n0, n0 + kBN) of out (ld elements a row), those below row_end and n_dim
// only.  Fragment element 4j + r holds row 16 warp + lane / 4 (+ 8 for
// r >= 2) and columns 8j + 2 (lane % 4) (+ 1 for odd r); lanes 2i and 2i + 1
// swap one word of each pair of 8-column chunks, so each stores 8 bytes and
// a warp's store covers 32 bytes (a sector) of each of 8 rows.  No shared
// memory and no TMA: the ring keeps the room a staging buffer would take
// (a fourth stage), and no store waits behind the producer's loads at the
// TMA unit.
__device__ __forceinline__ void store_fragment(const float (&acc)[kBN / 2],
                                               bf16* __restrict__ out, int64_t ld,
                                               int row0, int row_end, int n0,
                                               int n_dim) {
  const int lane = threadIdx.x % 32;
  const bool odd = lane & 1;
  const int quad = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4 + 8 * half;
#pragma unroll
    for (int j = 0; j < kBN / 8; j += 2) {
      const uint32_t lo = pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      const uint32_t hi = pack_bf16(acc[4 * j + 4 + 2 * half], acc[4 * j + 5 + 2 * half]);
      const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
      // even lanes: chunk j from column 2 quad; odd: chunk j + 1 from
      // column 2 (quad - 1)
      const int col = n0 + 8 * j + (odd ? 8 + 2 * (quad - 1) : 2 * quad);
      if (row < row_end && col < n_dim)
        *reinterpret_cast<uint2*>(out + row * ld + col) =
            odd ? make_uint2(got, hi) : make_uint2(lo, got);
    }
  }
}

// -- y = x @ w[e] ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    grouped_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const __grid_constant__ CUtensorMap map_y,
                          const int* __restrict__ group_sizes,
                          bf16* __restrict__ y, int rows, int k_dim,
                          int n_dim, int experts) {
  extern __shared__ unsigned char smem_raw[];
  // Inclusive prefix sums over the experts of their rows and row tiles.
  __shared__ int s_row_end[kMaxExperts];
  __shared__ int s_tile_end[kMaxExperts];
  __shared__ uint64_t full_bar[kStages];
  __shared__ uint64_t empty_bar[kStages];
  // The 128-byte swizzle repeats every 1024 bytes: stages start on it.
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x;
  init_ring<kStages>(full_bar, empty_bar, kConsumers * 4);
  group_ends(group_sizes, experts, rows, s_row_end, s_tile_end);

  const int col_tiles = (n_dim + kBN - 1) / kBN;
  const int tiles = s_tile_end[experts - 1] * col_tiles;
  const int k_steps = (k_dim + kBK - 1) / kBK;
  const int wg = tid / 128;

  // One if/else on the warpgroup, never rejoined: ptxas honours setmaxnreg
  // only so.
  if (wg == kConsumers) {
    // -- producer: one thread issues every TMA load ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      prefetch_tensormap(&map_x);
      prefetch_tensormap(&map_w);
      int it = 0;  // k-steps loaded so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Tile t = locate(tile, col_tiles, experts, s_row_end, s_tile_end);
        // boxes of w wholly past the output's columns would load only zeros:
        // skip them (their columns are never stored)
        const int chunks =
            min(kBN / kChunkN, (n_dim - t.n0 + kChunkN - 1) / kChunkN);
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int stage = it % kStages;
          const uint32_t full = smem_addr(&full_bar[stage]);
          mbar_wait(smem_addr(&empty_bar[stage]), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full, kATile + chunks * kWChunk);
          const uint32_t a = ring + stage * kStageBytes;
          tma_load_2d(a, &map_x, full, ks * kBK, t.row0);
          // w[e] lies (K, N): 64 of its columns a box
          for (int c = 0; c < chunks; ++c)
            tma_load_3d(a + kATile + c * kWChunk, &map_w, full,
                        t.n0 + c * kChunkN, ks * kBK, t.e);
        }
      }
    }
  } else {
    // -- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    // this warpgroup's 64 rows of the epilogue's tile
    const uint32_t out =
        ring + kStages * kStageBytes + wg * (kBN / kChunkN) * kOutBox;
    unsigned char* out_ptr = smem_raw + (out - smem_addr(smem_raw));
    float acc[kBN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile t = locate(tile, col_tiles, experts, s_row_end, s_tile_end);
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int stage = it % kStages;
        mbar_wait(smem_addr(&full_bar[stage]), (it / kStages) & 1);
        const uint32_t a = ring + stage * kStageBytes + wg * (64 * kBK * 2);
        const uint32_t b = ring + stage * kStageBytes + kATile;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // x: K-major rows of 128 bytes, 8-row swizzle atoms 1024 bytes
          // apart (SBO); a 16-deep slice starts 32 bytes further along.
          // w[e]: N-major, rows of 64 columns 128 bytes apart, 8-row atoms
          // 1024 bytes apart (SBO), the 64-column boxes kWChunk apart (LBO);
          // a 16-deep slice starts 16 rows further down.
          wgmma_tile<0, 1>(acc, smem_desc(a + kk * 32, 16, 1024),
                           smem_desc(b + kk * 16 * 128, kWChunk, 1024),
                           ks > 0 || kk > 0);
        }
        wgmma_commit();
        fence_acc(acc);
        // the previous k-step's wgmmas are done: give its stage back
        wgmma_wait<1>();
        if (ks > 0 && lane == 0)
          mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0)
        mbar_arrive(smem_addr(&empty_bar[(it + kStages - 1) % kStages]));

      // Epilogue: round to bf16 into shared memory, then TMA stores of the
      // warpgroup's 64 rows (cut at the columns and T by the tensor map)
      // if they all lie in the group, else 16-byte stores of the rows that
      // do.  The TMA stores run on while the next tile is multiplied; the
      // buffer is written again only once they have read it.
      if (tid % 128 == 0) bulk_wait_read();
      warpgroup_sync(1 + wg);
      stage_out(acc, out_ptr, warp, lane);
      fence_async_shared();
      warpgroup_sync(1 + wg);
      const int row0 = t.row0 + wg * 64;
      if (row0 + 64 <= t.row_end) {
        if (tid % 128 == 0) {
          for (int b = 0; b < kBN / kChunkN && t.n0 + b * kChunkN < n_dim; ++b)
            tma_store_2d(&map_y, out + b * kOutBox, t.n0 + b * kChunkN, row0);
          bulk_commit();
        }
      } else {
        // the group ends inside these 64 rows: 64 rows x BN / 8 chunks
        for (int i = tid % 128; i < 64 * (kBN / 8); i += 128) {
          const int r = i / (kBN / 8);
          const int j = i % (kBN / 8);
          const int col = t.n0 + j * 8;
          if (row0 + r < t.row_end && col < n_dim)
            *reinterpret_cast<uint4*>(y + static_cast<int64_t>(row0 + r) *
                                              n_dim + col) =
                *reinterpret_cast<const uint4*>(
                    out_ptr + (j / 8) * kOutBox + r * 128 +
                    (((j % 8) ^ (r % 8)) * 16));
        }
      }
    }
    if (tid % 128 == 0) bulk_wait();  // the buffer outlives the stores
  }
}

// -- dx = dy @ w[e]^T -------------------------------------------------------------

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    grouped_matmul_dx_kernel(const __grid_constant__ CUtensorMap map_dy,
                             const __grid_constant__ CUtensorMap map_w,
                             const int* __restrict__ group_sizes,
                             bf16* __restrict__ dx, int rows, int k_dim,
                             int n_dim, int experts) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_row_end[kMaxExperts];
  __shared__ int s_tile_end[kMaxExperts];
  __shared__ uint64_t full_bar[kBwdStages];
  __shared__ uint64_t empty_bar[kBwdStages];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  init_ring<kBwdStages>(full_bar, empty_bar, kCluster * kConsumers * 4);
  group_ends(group_sizes, experts, rows, s_row_end, s_tile_end);
  // the other block's barriers exist before any load or arrival reaches them
  cluster_sync();

  const int row_tiles = s_tile_end[experts - 1];
  const int col_tiles = (n_dim + kBN - 1) / kBN;
  const int tiles = (row_tiles + kCluster - 1) / kCluster * col_tiles;   // the cluster tiles
  const int k_steps = (k_dim + kBK - 1) / kBK;
  const int wg = tid / 128;
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      // -- producer: dy's 128 rows, and w's slab (256 of its rows, K-major):
      // the half of it that is this block's into both blocks when shared --
      prefetch_tensormap(&map_dy);
      prefetch_tensormap(&map_w);
      int it = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        const PairTile p = locate_pair(tile, col_tiles, row_tiles, rank, experts,
                                       s_row_end, s_tile_end);
        const int chunks =
            min(kBN / kChunkN, (n_dim - p.t.n0 + kChunkN - 1) / kChunkN);
        const int c_first = p.shared ? rank * (kBN / kChunkN / kCluster) : 0;
        const int c_end =
            p.shared ? min(chunks, c_first + kBN / kChunkN / kCluster) : chunks;
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int stage = it % kBwdStages;
          const uint32_t full = smem_addr(&full_bar[stage]);
          mbar_wait(smem_addr(&empty_bar[stage]), ((it / kBwdStages) & 1) ^ 1);
          mbar_expect_tx(full, kATile + chunks * kWChunk);
          const uint32_t a = ring + stage * kStageBytes;
          tma_load_2d(a, &map_dy, full, ks * kBK, p.t.row0);
          // w[e] lies (N, K): 64 of its rows (output columns) a box
          for (int c = c_first; c < c_end; ++c) {
            if (p.shared)
              tma_load_3d_multicast(a + kATile + c * kWChunk, &map_w, full,
                                    ks * kBK, p.t.n0 + c * kChunkN, p.t.e,
                                    (1u << kCluster) - 1);
            else
              tma_load_3d(a + kATile + c * kWChunk, &map_w, full, ks * kBK,
                          p.t.n0 + c * kChunkN, p.t.e);
          }
        }
      }
      drain_ring(empty_bar, it);
    }
  } else {
    // -- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = tid % 32;
    float acc[kBN / 2];
    int it = 0;
    for (int tile = cluster; tile < tiles; tile += clusters) {
      const PairTile p = locate_pair(tile, col_tiles, row_tiles, rank, experts,
                                     s_row_end, s_tile_end);
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int stage = it % kBwdStages;
        mbar_wait(smem_addr(&full_bar[stage]), (it / kBwdStages) & 1);
        const uint32_t a = ring + stage * kStageBytes + wg * (64 * kBK * 2);
        const uint32_t b = ring + stage * kStageBytes + kATile;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // dy and w[e]^T both K-major rows of 128 bytes, 8-row swizzle
          // atoms 1024 bytes apart (SBO), w's 256 rows contiguous (its
          // four boxes follow each other); a 16-deep slice starts 32
          // bytes further along.  So no transposed copy of w.
          wgmma_tile<0, 0>(acc, smem_desc(a + kk * 32, 16, 1024),
                           smem_desc(b + kk * 32, 16, 1024), ks > 0 || kk > 0);
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        if (ks > 0) release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);
      store_fragment(acc, dx, n_dim, p.t.row0 + wg * 64, p.t.row_end, p.t.n0, n_dim);
    }
  }
}

// -- dw[e] = x_e^T @ dy_e -------------------------------------------------------

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    grouped_matmul_dw_kernel(const __grid_constant__ CUtensorMap map_x,
                             const __grid_constant__ CUtensorMap map_dy,
                             const int* __restrict__ group_sizes,
                             bf16* __restrict__ dw, int rows, int m_dim,
                             int n_dim, int experts) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_row_end[kMaxExperts];
  __shared__ int s_tile_end[kMaxExperts];
  __shared__ uint64_t full_bar[kBwdStages];
  __shared__ uint64_t empty_bar[kBwdStages];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* const smem = smem_raw - smem_addr(smem_raw);   // + a shared address

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  init_ring<kBwdStages>(full_bar, empty_bar, kCluster * kConsumers * 4);
  group_ends(group_sizes, experts, rows, s_row_end, s_tile_end);
  cluster_sync();

  const int m_pairs = ((m_dim + kBM - 1) / kBM + kCluster - 1) / kCluster;
  const int n_tiles = (n_dim + kBN - 1) / kBN;
  const int tiles = experts * m_pairs * n_tiles;   // the cluster tiles
  const int wg = tid / 128;
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      // -- producer: a stage is 64 rows of the expert: two 64 x 64 boxes of
      // x (d columns m0 ..), and of the four of dy (f columns n0 ..) the
      // two that are this block's, into both blocks ------------------------
      prefetch_tensormap(&map_x);
      prefetch_tensormap(&map_dy);
      int it = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        const SlabTile t = locate_slab(tile, m_pairs, n_tiles, rank, s_row_end);
        // boxes wholly past d or f would load only zeros: skip them
        const int a_boxes = max(0, min(kConsumers, (m_dim - t.m0 + 63) / 64));
        const int chunks =
            min(kBN / kChunkN, (n_dim - t.n0 + kChunkN - 1) / kChunkN);
        const int c_first = rank * (kBN / kChunkN / kCluster);
        const int c_end = min(chunks, c_first + kBN / kChunkN / kCluster);
        for (int row = t.start; row < t.end; row += kBK, ++it) {
          const int stage = it % kBwdStages;
          const uint32_t full = smem_addr(&full_bar[stage]);
          mbar_wait(smem_addr(&empty_bar[stage]), ((it / kBwdStages) & 1) ^ 1);
          mbar_expect_tx(full, (a_boxes + chunks) * kWChunk);
          const uint32_t a = ring + stage * kStageBytes;
          for (int c = 0; c < a_boxes; ++c)
            tma_load_2d(a + c * kWChunk, &map_x, full, t.m0 + c * 64, row);
          for (int c = c_first; c < c_end; ++c)
            tma_load_2d_multicast(a + kATile + c * kWChunk, &map_dy, full,
                                  t.n0 + c * kChunkN, row, (1u << kCluster) - 1);
        }
      }
      drain_ring(empty_bar, it);
    }
  } else {
    // -- consumers: warpgroup wg owns rows [m0 + 64 wg, + 64) of d ----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = tid % 32;
    float acc[kBN / 2];
    int it = 0;
    for (int tile = cluster; tile < tiles; tile += clusters) {
      const SlabTile t = locate_slab(tile, m_pairs, n_tiles, rank, s_row_end);
      // every step accumulates; an empty expert stores these zeros
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      for (int row = t.start; row < t.end; row += kBK, ++it) {
        const int stage = it % kBwdStages;
        mbar_wait(smem_addr(&full_bar[stage]), (it / kBwdStages) & 1);
        const uint32_t a = ring + stage * kStageBytes + wg * kWChunk;
        const uint32_t b = ring + stage * kStageBytes + kATile;
        const int valid = t.end - row;
        if (valid < kBK) {
          // The stage's rows [valid, 64) are past the expert's end: zero
          // them in this warpgroup's box of x and in boxes 2 wg, 2 wg + 1
          // of dy (a row keeps its 128 bytes under the swizzle; this
          // block's copy of the stage only), then wait for the other
          // warpgroup's half before either reads the stage.
          unsigned char* stage_ptr = smem + ring + stage * kStageBytes;
          const int chunks_a_box = (kBK - valid) * 8;  // 16-byte chunks
          for (int i = tid % 128; i < 3 * chunks_a_box; i += 128) {
            const int box = i / chunks_a_box;
            const int box_off = box == 0
                                    ? wg * kWChunk
                                    : kATile + (2 * wg + box - 1) * kWChunk;
            *reinterpret_cast<uint4*>(stage_ptr + box_off + valid * 128 +
                                      (i % chunks_a_box) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          fence_async_shared();
          consumers_sync();
        }
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // x_e^T: M-major (64 d-columns of 128 bytes a row of x, the
          // transpose flag), dy_e: N-major like w in the forward; 8-row
          // atoms 1024 bytes apart (SBO), boxes kWChunk apart (LBO); a
          // 16-deep slice starts 16 rows further down.
          wgmma_tile<1, 1>(acc, smem_desc(a + kk * 16 * 128, kWChunk, 1024),
                           smem_desc(b + kk * 16 * 128, kWChunk, 1024), 1);
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        if (row > t.start)
          release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (t.end > t.start)
        release_in_cluster(empty_bar, (it + kBwdStages - 1) % kBwdStages, lane);
      // every row of the tile is the expert's, cut at d and f
      store_fragment(acc, dw + static_cast<int64_t>(t.e) * m_dim * n_dim, n_dim,
                     t.m0 + wg * 64, m_dim, t.n0, n_dim);
    }
  }
}

// -- host ----------------------------------------------------------------------

// Per kernel and device: the blocks that run at once (the SM count for the
// forward; two blocks for each cluster that fits, for dx and dw), once the
// kernel's shared memory limit has been raised there.
constexpr int kMaxDevices = 64;
enum KernelId { kForward, kDx, kDw, kKernelIds };
int device_blocks[kKernelIds][kMaxDevices];

cudaError_t prepare(const void* kernel, KernelId id, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (device_blocks[id][dev] == 0) {
    const int smem = id == kForward ? kSmemBytes : kBwdSmemBytes;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int count = 0;
    if (id == kForward) {
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    } else {
      cudaLaunchConfig_t config = {};
      config.gridDim = dim3(kCluster);
      config.blockDim = dim3(kThreads);
      config.dynamicSmemBytes = smem;
      err = cudaOccupancyMaxActiveClusters(&count, kernel, &config);
      count *= kCluster;
    }
    if (err != cudaSuccess) return err;
    if (count <= 0) return cudaErrorInvalidConfiguration;
    device_blocks[id][dev] = count;
  }
  *blocks = device_blocks[id][dev];
  return cudaSuccess;
}

bool bad_shape(int rows, int k_dim, int n_dim, int experts) {
  return rows <= 0 || k_dim <= 0 || n_dim <= 0 || experts <= 0 ||
         experts > kMaxExperts || k_dim % 8 || n_dim % 8;
}

// The most row tiles a walk can have: each expert with rows adds at most
// one partial row tile.
long long worst_row_tiles(int rows, int experts) {
  return (rows + kBM - 1) / kBM + (experts < rows ? experts : rows);
}

// The tensor map of a row kernel's a (rows, k_dim), read in 128 x 64 boxes
// (x for y, dy for dx).
bool encode_rows(CUtensorMap* map_a, const void* a, int rows, int k_dim) {
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(k_dim),
                                static_cast<cuuint64_t>(rows)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(k_dim) * 2};
  const cuuint32_t a_box[2] = {kBK, kBM};
  return encode(map_a, a, 2, a_dims, a_strides, a_box);
}

}  // namespace

extern "C" {

// x: (rows, k_dim), w: (experts, k_dim, n_dim), y: (rows, n_dim), all
// contiguous bf16, 16-byte aligned; group_sizes: (experts,) int32 on the
// device.  k_dim and n_dim multiples of 8 (16-byte rows).  Returns the
// launch's cudaError_t (0 on success).
int grouped_matmul(const void* x, const void* w, const void* group_sizes,
                   void* y, int rows, int k_dim, int n_dim, int experts,
                   void* stream) {
  if (bad_shape(rows, k_dim, n_dim, experts)) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(grouped_matmul_kernel);
  int sms = 0;
  cudaError_t err = prepare(kernel, kForward, &sms);
  if (err != cudaSuccess) return err;

  CUtensorMap map_x, map_w, map_y;
  // w innermost first: (n_dim, k_dim, E), 64 columns x 64 rows a box
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(n_dim),
                                static_cast<cuuint64_t>(k_dim),
                                static_cast<cuuint64_t>(experts)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(n_dim) * 2,
                                   static_cast<cuuint64_t>(k_dim) * n_dim * 2};
  const cuuint32_t w_box[3] = {kChunkN, kBK, 1};
  // y (rows, n_dim) written in 64 x 64 boxes
  const cuuint64_t y_dims[2] = {static_cast<cuuint64_t>(n_dim),
                                static_cast<cuuint64_t>(rows)};
  const cuuint64_t y_strides[1] = {static_cast<cuuint64_t>(n_dim) * 2};
  const cuuint32_t y_box[2] = {kChunkN, 64};
  if (!encode_rows(&map_x, x, rows, k_dim) ||
      !encode(&map_w, w, 3, w_dims, w_strides, w_box) ||
      !encode(&map_y, y, 2, y_dims, y_strides, y_box))
    return cudaErrorInvalidValue;

  const long long worst = worst_row_tiles(rows, experts) * ((n_dim + kBN - 1) / kBN);
  const int blocks = static_cast<int>(worst < sms ? worst : sms);
  grouped_matmul_kernel<<<blocks, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, map_y, static_cast<const int*>(group_sizes),
      static_cast<bf16*>(y), rows, k_dim, n_dim, experts);
  return cudaGetLastError();
}

// dx = dy @ w[e]^T: dy (rows, f), w (experts, d, f), dx (rows, d); the
// same requirements.
int grouped_matmul_dx(const void* dy, const void* w, const void* group_sizes,
                      void* dx, int rows, int d, int f, int experts,
                      void* stream) {
  if (bad_shape(rows, f, d, experts)) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(grouped_matmul_dx_kernel);
  int fit = 0;
  cudaError_t err = prepare(kernel, kDx, &fit);
  if (err != cudaSuccess) return err;

  CUtensorMap map_dy, map_w;
  // w innermost first: (f, d, E), 64 of f x 64 of d a box
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(f),
                                static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(experts)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(f) * 2,
                                   static_cast<cuuint64_t>(d) * f * 2};
  const cuuint32_t w_box[3] = {kBK, kChunkN, 1};
  if (!encode_rows(&map_dy, dy, rows, f) ||
      !encode(&map_w, w, 3, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;

  const long long worst = kCluster *
                          ((worst_row_tiles(rows, experts) + kCluster - 1) / kCluster) *
                          ((d + kBN - 1) / kBN);
  const int blocks = static_cast<int>(worst < fit ? worst : fit);
  grouped_matmul_dx_kernel<<<blocks, kThreads, kBwdSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      map_dy, map_w, static_cast<const int*>(group_sizes),
      static_cast<bf16*>(dx), rows, f, d, experts);
  return cudaGetLastError();
}

// dw[e] = x_e^T @ dy_e: x (rows, d), dy (rows, f), dw (experts, d, f), every
// element written (an empty expert's slab with zeros); the same
// requirements.
int grouped_matmul_dw(const void* x, const void* dy, const void* group_sizes,
                      void* dw, int rows, int d, int f, int experts,
                      void* stream) {
  if (bad_shape(rows, d, f, experts)) return cudaErrorInvalidValue;
  int fit = 0;
  cudaError_t err = prepare(
      reinterpret_cast<const void*>(grouped_matmul_dw_kernel), kDw, &fit);
  if (err != cudaSuccess) return err;

  CUtensorMap map_x, map_dy;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(rows)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint64_t dy_dims[2] = {static_cast<cuuint64_t>(f),
                                 static_cast<cuuint64_t>(rows)};
  const cuuint64_t dy_strides[1] = {static_cast<cuuint64_t>(f) * 2};
  const cuuint32_t box[2] = {64, kBK};
  if (!encode(&map_x, x, 2, x_dims, x_strides, box) ||
      !encode(&map_dy, dy, 2, dy_dims, dy_strides, box))
    return cudaErrorInvalidValue;

  const int m_pairs = ((d + kBM - 1) / kBM + kCluster - 1) / kCluster;
  const long long worst = static_cast<long long>(kCluster) * experts * m_pairs *
                          ((f + kBN - 1) / kBN);
  const int blocks = static_cast<int>(worst < fit ? worst : fit);
  grouped_matmul_dw_kernel<<<blocks, kThreads, kBwdSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      map_x, map_dy, static_cast<const int*>(group_sizes),
      static_cast<bf16*>(dw), rows, d, f, experts);
  return cudaGetLastError();
}

}  // extern "C"
