// Grouped matmul (kernel B3) for Hopper (sm_90a): the expert FFNs of a
// MoE layer over expert-sorted rows, on the tensor cores.
//
// Replaces: src/repro/models/moe.py:109-112, `jax.lax.ragged_dot` in
// `moe_mlp_dense` (no Pallas kernel: XLA's grouped matmul on the TPU).
//
// What it computes: ragged_dot's function.  lhs (M, K), rhs (G, K, N) and
// group_sizes (G,) int32; the groups are contiguous runs of rows in group
// order, so out[r] = lhs[r] @ rhs[g] for the rows r of group g, and rows
// past the sum of group_sizes are written as zeros.  Float32 in and out
// (the reference casts both sides to float32).  Negative sizes count as 0
// and rows are clamped to M.  No size is read on the host: every CTA
// derives the work list from the sizes on the device.
//
// Precision: error-compensated TF32 ("3xTF32").  Each operand x is split
// into big = tf32(x) (10 mantissa bits, rounded half away from zero, as
// cvt.rna.tf32.f32) and small = tf32(x - big) (x - big is exact in
// float32), and the tensor cores accumulate small·big + big·small +
// big·big; the dropped small·small term is ~2^-22 of the product.  Plain
// TF32 misses the 1e-5 · max|out| tolerance (3e-4 at the decode widths);
// 3xTF32 with exact sums lands near 8e-8.  The tensor cores add in float32
// but truncate, and 3·K/8 accumulating wgmmas into one sum drift by
// several ulps (too near the 1e-5 tolerance at K = 1024 in a trial), so
// each 32-deep K stage starts a fresh partial sum (scale-d = 0) and the
// consumer adds it to a float32 register sum once the stage is done.  A
// bf16 copy of the weights would be another function.  Infinite inputs
// give NaN (inf - inf in the split).
//
// Design.  Work items are (group, row tile of <= 32 rows, 64-column N
// tile); item w is row tile w / NT of the flattened groups and N tile
// w % NT.  Two CTAs an SM walk the items w = blockIdx.x, += gridDim.x.
// - The product is computed transposed, outT = W_g^T · lhs^T, so the 64
//   weight columns fill wgmma's M = 64 side and the group's rows are its N
//   side: m64nNk8 with N in {8, 16, 32}, the least that holds the tile's
//   rows (a decode group's <= 8 rows take n8, not a padded 64).
// - Both operands come from shared memory, K-major without swizzle (tf32
//   wgmma takes no other layout): core matrices of 8 rows x 16 bytes,
//   [k chunk of 4][row][4], a big and a small copy of each, in two
//   buffers: a stage starts with wait_group 0 and ends its staging with a
//   named barrier, so when a warp rewrites a buffer every warp has seen
//   the wgmmas that read it two stages before complete.  The consumer
//   warpgroup fills them: each thread reads four K rows of one weight
//   column from the stage (a warp reads one contiguous row) and the rows'
//   16-byte chunks, splits them and stores 16-byte units.
// - A producer warp streams each stage through two rings behind mbarriers:
//   the weights as one TMA box of 32 K rows x 64 columns, the rows as one
//   box of 8 or 32 rows x 32 K with TMA's 128-byte swizzle, which puts the
//   8 rows a store phase reads on distinct banks.  Boxes zero what lies
//   past K, N and M.  The tensor maps hold the operands' addresses, so the
//   launcher encodes them each call; they are cached by address, shape and
//   box (a map is a function of these), so a decode step's 72 weight
//   tensors are encoded once.  Where an operand is not 16-byte aligned or
//   its rows are not a multiple of 16 bytes, its ring is filled by 4-byte
//   cp.async copies, each lane arriving through cp.async.mbarrier.arrive.
//   The rings run on across items, so the next item's operands arrive
//   during this item's epilogue.
// - The item list: each warp walks the sizes 32 groups at a time (a warp
//   scan of sizes and row tiles), keeping a cursor, so a CTA reads the
//   sizes O(G) times in all.  After its items the consumer warpgroup zeroes
//   its share of the rows past the groups.
// - What the card showed while this was designed (PERF.md §6): wgmma
//   with register A operands was serialized by ptxas (C7512, register
//   pressure); one 1-D bulk copy a 256-byte weight row, and 16-byte
//   cp.async copies from one warp, fed the ring far below the memory
//   rate; with TMA boxes the consumer warpgroup's own chain (waits,
//   splits, proxy fence, barrier, 12 wgmma issues) sets a stage's pace
//   with one warp a scheduler, so a second CTA an SM (32-row tiles,
//   ≈ 108 KiB of shared memory each) runs a second chain beside it
//   (`tools/gmm_variants.py one trace` times and traces the one-CTA
//   layout); mma.sync fragments read from the rings at decode were
//   slower than this path.
//
// Bound on this card: bytes at decode, bytes or tensor operations at
// prefill.  The least traffic is lhs and out once plus each non-empty
// group's K x N weights once: at decode (8 slots x top-8 = 64 rows over 32
// experts) that is ≈ 56-58 MiB, ≈ 0.017 ms at 3.35 TB/s.  The tensor-core
// work is 3 x 2·rows·K·N at 495 TFLOP/s (TF32, dense): 0.026 ms at the
// 4096-row prefill shape, whose bytes (≈ 92 MB) take 0.028 ms.  Each
// weight element is read once per row tile, so a group of r rows reads its
// weights ceil(r / 32) times (from L2 after the first where its tiles run
// together).
//
// Kernel B6, the backward (ragged_dot's VJP, for MoE training; no Pallas
// kernel either: XLA differentiates ragged_dot on the TPU), is two launches
// a call, one a product, of its own kernel (`b6::kernel`, below): d_lhs and
// d_rhs both on wgmma in 3xTF32, 128 x 128 output tiles over two consumer
// warpgroups fed by two that split the operands (see the note above it for
// the design, its bound and what the card showed).  It shares this
// engine's PTX wrappers, split and item list.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kTileN = 64;       // weight columns an item (wgmma M)
constexpr int kKB = 32;          // K rows a stage
constexpr int kRowTile = 32;     // rows an item, at most (wgmma N)
constexpr int kWStages = 5;      // weight ring depth
constexpr int kLStages = 5;      // row ring depth
constexpr int kCtasPerSm = 2;   // CTAs an SM: two consumer chains an SM
constexpr int kLPitch = kKB;     // floats a staged row: 128 bytes, 16-byte chunks swizzled
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp

constexpr int kAChunkBytes = kTileN * 16;             // one 4-wide k chunk of A's 64 rows
constexpr int kBChunkBytes = kRowTile * 16;            // and of B's rows
constexpr int kABytes = (kKB / 4) * kAChunkBytes;      // 8 KiB: one A copy of a stage
constexpr int kBBytes = (kKB / 4) * kBChunkBytes;      // 4 KiB: one B copy
constexpr int kBuffers = 2;                            // operand buffers
constexpr int kBufBytes = 2 * kABytes + 2 * kBBytes;   // A big, A small, B big, B small
constexpr int kWStageBytes = kKB * kTileN * 4;         // 8 KiB: one weight stage
constexpr int kLStageBytes = kRowTile * kLPitch * 4;   // 4 KiB: one row stage
constexpr int kOffW = kBuffers * kBufBytes;
constexpr int kOffL = kOffW + kWStages * kWStageBytes;
constexpr int kOffBar = kOffL + kLStages * kLStageBytes;
constexpr int kSmemBytes = kOffBar + 2 * (kWStages + kLStages) * 8;  // 110,752 B

// -- PTX wrappers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// TMA box loads global -> shared; completion counted on `bar` in bytes
// (the whole box, zeros past the tensor's edge included).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A 4-byte asynchronous copy global -> shared (the path for operands TMA
// cannot address).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}

// This thread's arrival on `bar`, made when its earlier cp.async copies
// have landed (the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// wgmma fences and waits.
template <int C>
__device__ __forceinline__ void fence_operands(float (&d)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// TF32 rounding of x, half away from zero (cvt.rna.tf32.f32's result for
// finite x; +-inf stay), in two integer operations.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small + O(2^-22 |x|), both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes, the next 8 rows 128 bytes on (stride
// byte offset), the next 16 bytes of K `chunk` bytes on (leading byte
// offset).
__device__ __forceinline__ uint64_t op_desc(uint32_t addr, uint32_t chunk) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(chunk >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

// D (64 x N, float32, in registers) = scale_d · D + A (64 x 8 TF32) · B
// (8 x N TF32), both from shared memory.  D: d[4j + q] is row 16·warp + g
// + 8·(q / 2), column 8j + 2t + q % 2, g = lane / 4, t = lane % 4.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// -- the item list ------------------------------------------------------------------

// A warp's position in the groups: groups before `g` hold `rows` rows
// (unclamped) in `tiles` row tiles.
struct Cursor {
  int g = 0;
  long long rows = 0;
  long long tiles = 0;
};

struct Item {
  int g;
  long long row0;  // first row
  int count;       // rows, 1..tile_rows (0: an empty group's tile, where kept)
};

template <typename T>
__device__ __forceinline__ T warp_inclusive_sum(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Tiles of `tile_rows` rows that a group of `rows` rows makes; with
// `keep_empty` an empty group makes one tile of no rows (B6's d_rhs writes
// its zeros).
__device__ __forceinline__ long long group_tiles(int rows, int tile_rows, bool keep_empty) {
  const long long t = (rows + static_cast<long long>(tile_rows) - 1) / tile_rows;
  return keep_empty ? max(t, 1LL) : t;
}

// The 32 groups at the cursor: this lane's group's first row (clamped),
// rows (clamped) and the row tiles up to and including it.
struct Window {
  long long first, rows_incl, tiles_incl;
  int rows;
};

__device__ __forceinline__ Window window(const int* __restrict__ sizes, int G, long long M,
                                         const Cursor& c, int lane, int tile_rows,
                                         bool keep_empty) {
  const int g = c.g + lane;
  const long long s = g < G ? max(__ldg(sizes + g), 0) : 0;
  const long long incl = c.rows + warp_inclusive_sum(s, lane);
  const long long first = min(incl - s, M);
  const int rows = static_cast<int>(min(incl, M) - first);
  const long long tiles = g < G ? group_tiles(rows, tile_rows, keep_empty) : 0;
  return {first, incl, c.tiles + warp_inclusive_sum(tiles, lane), rows};
}

// Row tile t (a warp-uniform index, not below the cursor's earlier
// queries) of the flattened groups, in tiles of `tile_rows` rows.  Called
// by a whole warp.
__device__ __forceinline__ Item find_tile(const int* __restrict__ sizes, int G, long long M,
                                          Cursor& c, long long t, int lane,
                                          int tile_rows = kRowTile, bool keep_empty = false) {
  while (true) {
    const Window w = window(sizes, G, M, c, lane, tile_rows, keep_empty);
    const unsigned hit = __ballot_sync(0xffffffffu, c.g + lane < G && t < w.tiles_incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const long long tiles_incl = __shfl_sync(0xffffffffu, w.tiles_incl, src);
      const int rows = __shfl_sync(0xffffffffu, w.rows, src);
      const long long first = __shfl_sync(0xffffffffu, w.first, src);
      const long long tiles = group_tiles(rows, tile_rows, keep_empty);
      const int tile = static_cast<int>(t - (tiles_incl - tiles));
      return {c.g + src, first + static_cast<long long>(tile) * tile_rows,
              min(tile_rows, rows - tile * tile_rows)};
    }
    c.rows = __shfl_sync(0xffffffffu, w.rows_incl, 31);
    c.tiles = __shfl_sync(0xffffffffu, w.tiles_incl, 31);
    c.g += 32;
  }
}

// (row tiles, rows routed, clamped to M) over all groups.  Whole warp.
__device__ __forceinline__ void totals(const int* __restrict__ sizes, int G, long long M,
                                       int lane, long long& tiles, long long& rows,
                                       int tile_rows = kRowTile, bool keep_empty = false) {
  Cursor c;
  for (; c.g < G; c.g += 32) {
    const Window w = window(sizes, G, M, c, lane, tile_rows, keep_empty);
    c.rows = __shfl_sync(0xffffffffu, w.rows_incl, 31);
    c.tiles = __shfl_sync(0xffffffffu, w.tiles_incl, 31);
  }
  tiles = c.tiles;
  rows = min(c.rows, M);
}

// -- the consumer warpgroup -----------------------------------------------------------

struct Shared {
  unsigned char* base;
  // operand copies of buffer `buf`: 0 A big, 1 A small, 2 B big, 3 B small
  __device__ unsigned char* op(int buf, int which) const {
    return base + buf * kBufBytes + (which < 2 ? which * kABytes : 2 * kABytes +
                                                 (which - 2) * kBBytes);
  }
  __device__ float* w(int slot) const {
    return reinterpret_cast<float*>(base + kOffW + slot * kWStageBytes);
  }
  __device__ float* l(int slot) const {
    return reinterpret_cast<float*>(base + kOffL + slot * kLStageBytes);
  }
  // full and empty barriers of the weight ring, then of the row ring
  __device__ uint32_t bar(int i) const { return smem_addr(base + kOffBar + i * 8); }
  __device__ uint32_t full_w(int slot) const { return bar(slot); }
  __device__ uint32_t empty_w(int slot) const { return bar(kWStages + slot); }
  __device__ uint32_t full_l(int slot) const { return bar(2 * kWStages + slot); }
  __device__ uint32_t empty_l(int slot) const { return bar(2 * kWStages + kLStages + slot); }
};

// lhs (M, K), rhs (G, K, N) and out (M, N).
struct Params {
  CUtensorMap w_map;     // rhs as (G, K, N), boxes of 1 x 32 x 64
  CUtensorMap l_map8;    // lhs as (M, K), boxes of 8 x 32, 128-byte swizzle
  CUtensorMap l_map_tile;  // the same, boxes of kRowTile x 32
  const float* lhs;
  const float* rhs;
  const int* sizes;
  float* out;
  long long M;
  int K, N, G;
  bool w_tma;   // the maps hold: rhs 16-byte aligned and N % 4 == 0
  bool l_tma;   // lhs 16-byte aligned and K % 4 == 0
};

// Float offset of row r, column k in a row stage: 128-byte rows whose
// 16-byte chunks are swizzled by the row (TMA's 128-byte swizzle).
__device__ __forceinline__ int row_offset(int r, int k) {
  return r * kLPitch + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

__device__ __forceinline__ void store_split(unsigned char* big, unsigned char* small, int unit,
                                            float4 v) {
  uint4 b, s;
  split_tf32(v.x, b.x, s.x);
  split_tf32(v.y, b.y, s.y);
  split_tf32(v.z, b.z, s.z);
  split_tf32(v.w, b.w, s.w);
  reinterpret_cast<uint4*>(big)[unit] = b;
  reinterpret_cast<uint4*>(small)[unit] = s;
}

// The rows of one stage (128-byte rows, swizzled) into the B copies.  Unit
// u is row (u >> 6) · 8 + (u & 7), k chunk (u >> 3) & 7: the 8 lanes of a
// phase read one chunk of 8 rows, which the swizzle puts on distinct
// banks, and write 128 contiguous bytes.  Rows past `count` and K past
// `kvalid` are 0.
template <int NI>
__device__ __forceinline__ void store_rows(const Shared& sh, int buf, const float* l, int count,
                                           int kvalid, int tid) {
  constexpr int kUnits = NI * 8;
#pragma unroll
  for (int i = 0; i < (kUnits + kConsumers - 1) / kConsumers; ++i) {
    const int u = tid + i * kConsumers;
    if (u < kUnits) {
      const int r = (u >> 6) * 8 + (u & 7), c = (u >> 3) & 7, k = 4 * c;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < count) {
        x = *reinterpret_cast<const float4*>(l + row_offset(r, k));
        if (k >= kvalid) x.x = 0.f;
        if (k + 1 >= kvalid) x.y = 0.f;
        if (k + 2 >= kvalid) x.z = 0.f;
        if (k + 3 >= kvalid) x.w = 0.f;
      }
      store_split(sh.op(buf, 2), sh.op(buf, 3), c * kRowTile + r, x);
    }
  }
}

// A weight stage (kKB rows x 64 columns, N-major) into the A copies, read
// transposed: thread tid takes weight column m = tid % 64 and k chunks tid
// / 64 + 2i.
__device__ __forceinline__ void store_weights(const Shared& sh, int buf, const float* w,
                                              int kvalid, int tid) {
  const int m = tid & 63;
#pragma unroll
  for (int i = 0; i < kKB / 8; ++i) {
    const int c = (tid >> 6) + 2 * i, k = 4 * c;
    float4 x;
    x.x = k < kvalid ? w[k * kTileN + m] : 0.f;
    x.y = k + 1 < kvalid ? w[(k + 1) * kTileN + m] : 0.f;
    x.z = k + 2 < kvalid ? w[(k + 2) * kTileN + m] : 0.f;
    x.w = k + 3 < kvalid ? w[(k + 3) * kTileN + m] : 0.f;
    store_split(sh.op(buf, 0), sh.op(buf, 1), c * kTileN + m, x);
  }
}

template <int C>
__device__ __forceinline__ void add_into(float (&sum)[C], float (&part)[C]) {
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < C; ++i) sum[i] += part[i];
}

// One stage of an item, K block b: the stage's rows and weights go from
// the rings into buffer ring % 2, split, and the stage's 12 wgmmas (3 a k8
// step: small·big, big·small, big·big) write the partial sum `part` as one
// group.  Before that, the previous stage's partial is added to `sum`
// once its wgmmas are done: reading accumulators while a wgmma runs makes
// ptxas serialize every wgmma (C7514), and a stage's wgmmas take little
// of its time beside the splits.
template <int NI>
__device__ __forceinline__ void consume_stage(const Shared& sh, const Params& p, const Item& it,
                                              float (&part)[NI / 2], float (&sum)[NI / 2],
                                              int b, uint32_t& ring, int tid) {
  wgmma_wait<0>();  // this warp's previous stage is done
  if (b >= 1) add_into(sum, part);
  const int buf = ring % kBuffers, kvalid = min(kKB, p.K - b * kKB);
  const int ls = ring % kLStages, ws = ring % kWStages;
  mbar_wait(sh.full_l(ls), (ring / kLStages) & 1);
  store_rows<NI>(sh, buf, sh.l(ls), it.count, kvalid, tid);
  mbar_arrive(sh.empty_l(ls));
  mbar_wait(sh.full_w(ws), (ring / kWStages) & 1);
  store_weights(sh, buf, sh.w(ws), kvalid, tid);
  mbar_arrive(sh.empty_w(ws));
  ++ring;
  fence_async_shared();
  consumer_sync();  // the buffer written by every warp; every warp past its wait

  const uint64_t a_big = op_desc(smem_addr(sh.op(buf, 0)), kAChunkBytes);
  const uint64_t a_small = a_big + (kABytes >> 4);
  const uint64_t b_big = op_desc(smem_addr(sh.op(buf, 2)), kBChunkBytes);
  const uint64_t b_small = b_big + (kBBytes >> 4);
  fence_operands(part);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kKB / 8; ++j) {  // a k8 step is two 4-wide k chunks
    const uint64_t sa = (j * 2 * kAChunkBytes) >> 4, sb = (j * 2 * kBChunkBytes) >> 4;
    wgmma_tf32<NI>(part, a_small + sa, b_big + sb, j > 0);
    wgmma_tf32<NI>(part, a_big + sa, b_small + sb, 1);
    wgmma_tf32<NI>(part, a_big + sa, b_big + sb, 1);
  }
  wgmma_commit();
}

template <int NI>
__device__ __forceinline__ void consume_item(const Shared& sh, const Params& p, const Item& it,
                                             int n0, uint32_t& ring, int tid) {
  float sum[NI / 2], part[NI / 2];
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) sum[i] = 0.f;
  const int nkb = (p.K + kKB - 1) / kKB;
  for (int b = 0; b < nkb; ++b) consume_stage<NI>(sh, p, it, part, sum, b, ring, tid);
  wgmma_wait<0>();
  add_into(sum, part);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) {
    const int col = n0 + 16 * warp + g + 8 * ((i >> 1) & 1);
    const int r = 8 * (i >> 2) + 2 * t + (i & 1);
    if (r < it.count && col < p.N) p.out[(it.row0 + r) * p.N + col] = sum[i];
  }
}

// -- the kernel -----------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
grouped_matmul_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Shared sh{smem};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    // full: one arrival (with the bytes) for a TMA box, else one cp.async
    // arrival a producer lane
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(sh.full_w(s), p.w_tma ? 1 : 32);
      mbar_init(sh.empty_w(s), kConsumers);
    }
    for (int s = 0; s < kLStages; ++s) {
      mbar_init(sh.full_l(s), p.l_tma ? 1 : 32);
      mbar_init(sh.empty_l(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  long long total_tiles, total_rows;
  totals(p.sizes, p.G, p.M, lane, total_tiles, total_rows);
  const int nt = (p.N + kTileN - 1) / kTileN;
  const int nkb = (p.K + kKB - 1) / kKB;
  const long long items = total_tiles * nt;
  Cursor cur;
  uint32_t ring = 0;

  if (warp == kConsumers / 32) {  // the producer: each stage's weights and rows
    for (long long w = blockIdx.x; w < items; w += gridDim.x) {
      const Item it = find_tile(p.sizes, p.G, p.M, cur, w / nt, lane);
      const int n0 = static_cast<int>(w % nt) * kTileN;
      const int cols = min(kTileN, p.N - n0);
      const float* wsrc = p.rhs + static_cast<long long>(it.g) * p.K * p.N + n0;
      const float* lsrc = p.lhs + it.row0 * p.K;
      for (int b = 0; b < nkb; ++b, ++ring) {
        const int k0 = b * kKB, kvalid = min(kKB, p.K - k0);
        const int ws = ring % kWStages, ls = ring % kLStages;
        mbar_wait(sh.empty_w(ws), ((ring / kWStages) & 1) ^ 1);
        const uint32_t wdst = smem_addr(sh.w(ws));
        if (p.w_tma) {  // one 32 x 64 box, zeros past K and N
          if (lane == 0) {
            mbar_arrive_expect_tx(sh.full_w(ws), kWStageBytes);
            tma_load_3d(wdst, &p.w_map, n0, k0, it.g, sh.full_w(ws));
          }
        } else {
          for (int i = lane; i < kvalid * kTileN; i += 32) {
            const int r = i / kTileN, c = i % kTileN;
            if (c < cols) {
              cp_async4(wdst + (r * kTileN + c) * 4,
                        wsrc + static_cast<long long>(k0 + r) * p.N + c);
            }
          }
          cp_async_arrive(sh.full_w(ws));
        }
        mbar_wait(sh.empty_l(ls), ((ring / kLStages) & 1) ^ 1);
        const uint32_t ldst = smem_addr(sh.l(ls));
        if (p.l_tma) {  // one box of 8 or kRowTile rows; rows past the tile are ignored
          if (lane == 0) {
            const bool small = it.count <= 8;
            mbar_arrive_expect_tx(sh.full_l(ls), (small ? 8 : kRowTile) * kLPitch * 4);
            tma_load_2d(ldst, small ? &p.l_map8 : &p.l_map_tile, k0, static_cast<int>(it.row0),
                        sh.full_l(ls));
          }
        } else {
          for (int i = lane; i < it.count * kKB; i += 32) {
            const int r = i / kKB, c = i % kKB;
            if (c < kvalid) {
              cp_async4(ldst + row_offset(r, c) * 4,
                        lsrc + static_cast<long long>(r) * p.K + k0 + c);
            }
          }
          cp_async_arrive(sh.full_l(ls));
        }
      }
    }
    return;
  }

  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const Item it = find_tile(p.sizes, p.G, p.M, cur, w / nt, lane);
    const int n0 = static_cast<int>(w % nt) * kTileN;
    if (it.count <= 8) consume_item<8>(sh, p, it, n0, ring, tid);
    else if (it.count <= 16) consume_item<16>(sh, p, it, n0, ring, tid);
    else consume_item<32>(sh, p, it, n0, ring, tid);
  }
  // the rows past the groups: zeros, split over the CTAs
  const long long tail = (p.M - total_rows) * p.N;
  float* z = p.out + total_rows * p.N;
  for (long long i = static_cast<long long>(blockIdx.x) * kConsumers + tid; i < tail;
       i += static_cast<long long>(gridDim.x) * kConsumers) {
    z[i] = 0.f;
  }
}

// -- kernel B6: the backward, on the tensor cores ----------------------------------
//
// Replaces the VJP of `jax.lax.ragged_dot` in `moe_mlp_dense`
// (src/repro/models/moe.py:109-112; XLA differentiates it on the TPU, no
// Pallas kernel).  Two launches a call, both of one kernel template,
// `b6::kernel<kDrhs>`:
// - d_lhs[r] = g[r] · rhs[e(r)]^T (kDrhs false): an item is a group's row
//   tile of <= 128 rows and a 128-wide K tile; the contraction is N.
// - d_rhs[e] = lhs[rows_e]^T · g[rows_e] (kDrhs true): an item is a group
//   (all its rows), a 128-wide K tile and a <= 128-wide N tile; the
//   contraction is the group's rows.  Every group makes its items, so an
//   empty group's d_rhs is written as zeros.
// In both the product is D = A · B with A's 128 rows along K (wgmma M, two
// consumer warpgroups of 64) and B's n columns (wgmma N, n in {8, 16, 32,
// 64, 128}, the least that holds the item: d_lhs's rows, d_rhs's N tile,
// so a decode group of <= 8 rows takes n8), the contraction in 32-deep
// stages, 3xTF32 with a fresh partial sum a stage added to a float32
// register sum, as B3 (a stage's wgmmas skip the k8 steps past the
// group's rows or past N).  Operands are staged in shared memory K-major
// (tf32 wgmma takes no other layout), a big and a small copy each.
//
// Warp specialisation: a CTA of four warpgroups, one CTA an SM (192 KiB of
// shared memory), `setmaxnreg` giving the consumers 160 registers a thread
// and the split warpgroups 96.  Warpgroups 0 and 1 only run wgmmas (12 a
// stage each) and the epilogue.  Warpgroups 2 and 3 split, taking the
// stages in turn (2 the even ones, 3 the odd), each with its own TMA slot
// and operand buffer: it waits for its slot's two boxes, reads A into
// registers, waits for the consumers to free its buffer, splits and stores
// A's TF32 big and small parts, reads B, refills its slot with its next
// stage (its first warp: the copies two stages ahead, walking the same
// items with its own cursor), then splits and stores B and arrives on the
// buffer's barrier.  d_rhs transposes both operands in the split (each box
// holds 32 rows of lhs or g, row-major, and the contraction runs down the
// rows); d_lhs reads them as they come (each box holds 32 contiguous N of
// 128 weight rows or of the item's rows, with TMA's 128-byte swizzle).  So
// one warpgroup's waits and stores overlap the other's split and the
// consumers' wgmmas, and a stage's split (32 x (128 + n) floats) serves
// 128 x n outputs: 0.5 split floats an output a stage at n = 128, against
// B3's 1.5.  Where TMA cannot address an operand (a base not 16-byte
// aligned, rows not a multiple of 16 bytes) the first warp fills the slot
// with 4-byte cp.async copies instead.
//
// Bound on this card: each product is 3 x 2·rows·K·N TF32 tensor
// operations, ≈ 0.052 ms at granite's training shape (8192 rows, K 1024,
// N 512) at 495 TFLOP/s; bytes 0.03-0.04 ms a product.  Shared memory is
// the next limit: at n = 128 a stage's wgmmas read 144 KiB (A and B, three
// times, by two warpgroups), its split reads 32 KiB and writes 64 KiB, and
// TMA writes 32 KiB: ≈ 2,200 cycles at 128 B a cycle against ≈ 1,540
// cycles of tensor work.
//
// What the card showed while this was designed (`tools/gmm_variants.py
// --b6`, PERF.md §6): with one split warpgroup and a three-slot ring its
// chain of waits, loads and stores set each stage's pace; two split
// warpgroups on the same stage spent much of a stage in barriers and
// waits on each other; a split whose loads each sat behind a branch
// (skipping the chunks past a stage's depth) ran one load at a time;
// loading both operands before waiting for the buffer spilled and lost;
// 64-wide N tiles (`n64`) take about a quarter longer, and 152 or 168
// consumer registers (`regs152`, `regs168`) move the time by a few
// percent either way.  A hot group (Zipf sizes: half the rows on one
// group) makes d_rhs items many times the mean CTA's load, so d_rhs takes
// about twice its time on routed sizes; splitting such a group's rows over
// several items, each summing into a scratch slot and the last one summing
// the slots, was built and measured no faster (its scratch traffic and
// synchronisation ate the balance it bought), so it is not kept.
namespace b6 {

constexpr int kMT = 128;         // K rows an item (wgmma M: two warpgroups of 64)
constexpr int kNT = 128;         // wgmma N at most: d_rhs's N tile, d_lhs's row tile
constexpr int kKB = 32;          // contraction a stage
constexpr int kBufs = 2;         // operand buffers, and TMA slots: one of each a split warpgroup
constexpr int kMma = 256;        // consumer threads: two warpgroups
constexpr int kSplit = 256;      // split threads: two warpgroups
constexpr int kThreads = kMma + kSplit;
constexpr int kMmaRegs = 160;    // registers a thread after setmaxnreg: 256 x 160 + 256 x 96
constexpr int kSplitRegs = 96;   // = 65,536, the SM's file
constexpr int kSrcBytes = kKB * kMT * 4;       // 16 KiB: one operand's box of a stage (kNT <= kMT)
constexpr int kOpBytes = kKB / 4 * kMT * 16;   // 16 KiB: one TF32 copy of an operand
constexpr int kBufBytes = 4 * kOpBytes;        // A big, A small, B big, B small
constexpr int kOffRing = kBufs * kBufBytes;    // 128 KiB
constexpr int kOffBar = kOffRing + kBufs * 2 * kSrcBytes;  // 192 KiB
constexpr int kBarriers = 3 * kBufs;
constexpr int kSmemBytes = kOffBar + kBarriers * 8;   // 196,656 B
constexpr int kWholeGroup = 1 << 30;  // d_rhs's row tile: a group's rows, all of them

// B6's K and N: lhs (M, K), rhs (G, K, N), g (M, N).
struct Params {
  CUtensorMap a_map;     // d_rhs: lhs, boxes of 32 rows x 128; d_lhs: rhs (G, K, N), 1 x 128 x 32
  CUtensorMap b_map[3];  // g: d_rhs boxes of 32 rows x 128 ([0]); d_lhs 8, 32, 128 rows x 32
  const float* a;        // d_rhs: lhs; d_lhs: rhs
  const float* g;
  const int* sizes;
  float* out;            // d_rhs (G, K, N); d_lhs (M, K)
  long long M;
  int K, N, G;
  bool a_tma, b_tma;     // the maps hold (else 4-byte cp.async copies)
};

struct Smem {
  unsigned char* base;
  // operand copies of buffer `buf`: 0 A big, 1 A small, 2 B big, 3 B small
  __device__ unsigned char* op(int buf, int which) const {
    return base + buf * kBufBytes + which * kOpBytes;
  }
  // the ring's boxes: 0 A's source, 1 B's
  __device__ float* src(int slot, int which) const {
    return reinterpret_cast<float*>(base + kOffRing + (2 * slot + which) * kSrcBytes);
  }
  __device__ uint32_t bar(int i) const { return smem_addr(base + kOffBar + i * 8); }
  __device__ uint32_t full(int slot) const { return bar(slot); }  // both boxes landed
  __device__ uint32_t op_full(int buf) const { return bar(kBufs + buf); }
  __device__ uint32_t op_empty(int buf) const { return bar(2 * kBufs + buf); }
};

// An item: the group's row tile `it`, its K tile at k0, d_rhs's N tile at
// n0, its stages and wgmma N.
struct Work {
  Item it;
  int k0, n0, stages, n;
};

// The least wgmma N of 8, 16, 32, 64 and 128 that holds x <= kNT columns.
__device__ __forceinline__ int pick_n(int x) {
  return x <= 8 ? 8 : x <= 16 ? 16 : x <= 32 ? 32 : x <= 64 ? 64 : 128;
}

// Item w (items per row tile: `per`; d_rhs's N tiles: `nt`).  Whole warp.
template <bool kDrhs>
__device__ __forceinline__ Work work_of(const Params& p, Cursor& c, long long w, int per, int nt,
                                        int lane) {
  Work x;
  x.it = find_tile(p.sizes, p.G, p.M, c, w / per, lane, kDrhs ? kWholeGroup : kNT, kDrhs);
  const int sub = static_cast<int>(w % per);
  if constexpr (kDrhs) {
    x.k0 = (sub / nt) * kMT;
    x.n0 = (sub % nt) * kNT;
    x.stages = (x.it.count + kKB - 1) / kKB;
    x.n = pick_n(min(kNT, p.N - x.n0));
  } else {
    x.k0 = sub * kMT;
    x.n0 = 0;
    x.stages = (p.N + kKB - 1) / kKB;
    x.n = pick_n(x.it.count);
  }
  return x;
}

// A position in this CTA's stages (items w = blockIdx.x, += gridDim.x,
// each of x.stages stages; items of no stage skipped).  Whole warp.
template <bool kDrhs>
struct Walker {
  Cursor c;
  long long w, items;
  int per, nt, s;
  Work x;
  bool valid;

  __device__ __forceinline__ Walker(const Params& p, int per_, int nt_, long long items_, int lane)
      : w(blockIdx.x), items(items_), per(per_), nt(nt_), s(-1) {
    if (w < items) x = work_of<kDrhs>(p, c, w, per, nt, lane);
    advance(p, lane);
  }

  __device__ __forceinline__ void advance(const Params& p, int lane) {
    ++s;
    while (w < items && s >= x.stages) {
      w += gridDim.x;
      s = 0;
      if (w < items) x = work_of<kDrhs>(p, c, w, per, nt, lane);
    }
    valid = w < items;
  }
};

// -- the copies: stage s of item x into slot `slot` (a split warpgroup's first warp) --

template <bool kDrhs>
__device__ __forceinline__ void issue_stage(const Smem& sh, const Params& p, const Work& x, int s,
                                            int slot, int lane) {
  const uint32_t da = smem_addr(sh.src(slot, 0)), db = smem_addr(sh.src(slot, 1));
  if constexpr (kDrhs) {  // 32 rows of lhs (K tile) and of g (N tile), row-major
    const long long r0 = x.it.row0 + static_cast<long long>(s) * kKB;
    const int rows = min(kKB, x.it.count - s * kKB);
    if (p.a_tma) {
      if (lane == 0) {
        mbar_arrive_expect_tx(sh.full(slot), kKB * kMT * 4);
        tma_load_2d(da, &p.a_map, x.k0, static_cast<int>(r0), sh.full(slot));
      }
    } else {
      const int cols = min(kMT, p.K - x.k0);
      for (int i = lane; i < rows * kMT; i += 32) {
        const int r = i / kMT, c = i % kMT;
        if (c < cols) cp_async4(da + (r * kMT + c) * 4, p.a + (r0 + r) * p.K + x.k0 + c);
      }
      cp_async_arrive(sh.full(slot));
    }
    if (p.b_tma) {
      if (lane == 0) {
        mbar_arrive_expect_tx(sh.full(slot), kKB * kNT * 4);
        tma_load_2d(db, &p.b_map[0], x.n0, static_cast<int>(r0), sh.full(slot));
      }
    } else {
      const int cols = min(kNT, p.N - x.n0);
      for (int i = lane; i < rows * kNT; i += 32) {
        const int r = i / kNT, c = i % kNT;
        if (c < cols) cp_async4(db + (r * kNT + c) * 4, p.g + (r0 + r) * p.N + x.n0 + c);
      }
      cp_async_arrive(sh.full(slot));
    }
  } else {  // 32 N of 128 weight rows and of the item's rows, 128-byte swizzled rows
    const int c0 = s * kKB, kvalid = min(kKB, p.N - c0);
    if (p.a_tma) {
      if (lane == 0) {
        mbar_arrive_expect_tx(sh.full(slot), kKB * kMT * 4);
        tma_load_3d(da, &p.a_map, c0, x.k0, x.it.g, sh.full(slot));
      }
    } else {
      const int rows = min(kMT, p.K - x.k0);
      const float* w = p.a + (static_cast<long long>(x.it.g) * p.K + x.k0) * p.N + c0;
      for (int i = lane; i < rows * kKB; i += 32) {
        const int m = i / kKB, c = i % kKB;
        if (c < kvalid)
          cp_async4(da + row_offset(m, c) * 4, w + static_cast<long long>(m) * p.N + c);
      }
      cp_async_arrive(sh.full(slot));
    }
    if (p.b_tma) {
      if (lane == 0) {
        const int box = x.n <= 8 ? 0 : x.n <= 32 ? 1 : 2;
        mbar_arrive_expect_tx(sh.full(slot), (box == 0 ? 8 : box == 1 ? 32 : kNT) * kKB * 4);
        tma_load_2d(db, box == 0 ? &p.b_map[0] : box == 1 ? &p.b_map[1] : &p.b_map[2], c0,
                    static_cast<int>(x.it.row0), sh.full(slot));
      }
    } else {
      const float* rows = p.g + x.it.row0 * p.N + c0;
      for (int i = lane; i < x.it.count * kKB; i += 32) {
        const int r = i / kKB, c = i % kKB;
        if (c < kvalid)
          cp_async4(db + row_offset(r, c) * 4, rows + static_cast<long long>(r) * p.N + c);
      }
      cp_async_arrive(sh.full(slot));
    }
  }
}

// -- the split warpgroup ------------------------------------------------------------

// Rows k..k+3 of column `col` of a row-major box of `pitch` floats, rows
// at or past `live` zero (loaded all the same: no load is conditional).
__device__ __forceinline__ float4 column4(const float* src, int pitch, int k, int col, int live) {
  const float a = src[k * pitch + col], b = src[(k + 1) * pitch + col];
  const float c = src[(k + 2) * pitch + col], d = src[(k + 3) * pitch + col];
  return make_float4(k < live ? a : 0.f, k + 1 < live ? b : 0.f, k + 2 < live ? c : 0.f,
                     k + 3 < live ? d : 0.f);
}

// Columns k..k+3 of row r of a 128-byte swizzled box, columns at or past
// `kvalid` zero.
__device__ __forceinline__ float4 row4(const float* src, int r, int k, int kvalid) {
  float4 v = *reinterpret_cast<const float4*>(src + row_offset(r, k));
  if (k >= kvalid) v.x = 0.f;
  if (k + 1 >= kvalid) v.y = 0.f;
  if (k + 2 >= kvalid) v.z = 0.f;
  if (k + 3 >= kvalid) v.w = 0.f;
  return v;
}

// The contraction's extent in stage s of item x: the item's rows (d_rhs)
// or N (d_lhs) left, at most kKB.  The split writes zeros past it; the
// wgmmas skip the k8 steps past it.
template <bool kDrhs>
__device__ __forceinline__ int stage_valid(const Params& p, const Work& x, int s) {
  return min(kKB, (kDrhs ? x.it.count : p.N) - s * kKB);
}

// Waits until a load's value has landed in its registers: the slot it was
// read from may be refilled once the warpgroup passes its barrier.
__device__ __forceinline__ void landed(const float4& v) {
  asm volatile("" :: "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// The split warpgroup sw's named barrier.
__device__ __forceinline__ void split_sync(int sw) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + sw) : "memory");
}

// Stage s of item x from slot `sw` into buffer `sw` (sw: the split
// warpgroup): A's unit (k chunk c, row m) at c · 128 + m, B's (c, column j)
// at c · N + j, each a 16-byte TF32 big and small part.  Thread ts takes
// A's row m = ts in every chunk (d_rhs: a warp reads 32 consecutive floats
// of a row; d_lhs: 32 consecutive rows' chunk, which the swizzle puts on
// distinct banks a phase) and B's units ts + 128i likewise.  No load or
// store is conditional: values past the stage's rows (d_rhs), past N or
// past the item's rows (d_lhs) are selected to zero, so the loads of an
// operand issue back to back.  An operand's loads all come before its
// stores (the stores could alias the loads as far as the compiler knows,
// so interleaved they would run one unit at a time).  `refill` runs once
// the warpgroup has read the slot, before B's stores; A's stores wait for
// the consumers to be done with the buffer (`k`: this warpgroup's stage
// count).
template <bool kDrhs, int N, typename Refill>
__device__ __forceinline__ void split_stage(const Smem& sh, const Params& p, const Work& x, int s,
                                            int sw, uint32_t k, int ts, Refill refill) {
  const float* sa = sh.src(sw, 0);
  const float* sb = sh.src(sw, 1);
  constexpr int kUnits = 8 * N, kBIters = (kUnits + 127) / 128;
  const bool b_units = kUnits >= 128 || ts < kUnits;  // N = 8: 64 units, half the threads
  const int valid = stage_valid<kDrhs>(p, x, s);
  float4 v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    v[c] = kDrhs ? column4(sa, kMT, 4 * c, ts, valid) : row4(sa, ts, 4 * c, valid);
  mbar_wait(sh.op_empty(sw), (k & 1) ^ 1);  // the consumers are done with the buffer
#pragma unroll
  for (int c = 0; c < 8; ++c) store_split(sh.op(sw, 0), sh.op(sw, 1), c * kMT + ts, v[c]);
  if (b_units) {
#pragma unroll
    for (int i = 0; i < kBIters; ++i) {
      const int u = ts + 128 * i;
      if constexpr (kDrhs) {
        v[i] = column4(sb, kNT, 4 * (u / N), u % N, valid);
      } else {
        const int r = (u >> 6) * 8 + (u & 7);
        v[i] = row4(sb, r, 4 * ((u >> 3) & 7), valid);
        if (r >= x.it.count) v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  if (b_units) {
#pragma unroll
    for (int i = 0; i < kBIters; ++i) landed(v[i]);
  }
  split_sync(sw);  // the warpgroup has read the slot
  refill();
  if (b_units) {
#pragma unroll
    for (int i = 0; i < kBIters; ++i) {
      const int u = ts + 128 * i;
      const int unit = kDrhs ? u : ((u >> 3) & 7) * N + (u >> 6) * 8 + (u & 7);
      store_split(sh.op(sw, 2), sh.op(sw, 3), unit, v[i]);
    }
  }
}

// -- the consumer warpgroups ----------------------------------------------------

// The stage in buffer `buf` into `part` (a fresh partial sum): warpgroup
// wg's 64 rows of A against B's N columns, 3 wgmmas a k8 step of the
// stage's depth D, waited for.
template <int N, int D>
__device__ __forceinline__ void mma_stage(const Smem& sh, int buf, int wg, float (&part)[N / 2]) {
  const uint64_t a_big = op_desc(smem_addr(sh.op(buf, 0)) + wg * 64 * 16, kMT * 16);
  const uint64_t a_small = a_big + (kOpBytes >> 4);
  const uint64_t b_big = op_desc(smem_addr(sh.op(buf, 2)), N * 16);
  const uint64_t b_small = b_big + (kOpBytes >> 4);
  fence_operands(part);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < D; ++j) {  // a k8 step is two 4-wide k chunks
    const uint64_t sa = (j * 2 * kMT * 16) >> 4, sb = (j * 2 * N * 16) >> 4;
    wgmma_tf32<N>(part, a_small + sa, b_big + sb, j > 0);
    wgmma_tf32<N>(part, a_big + sa, b_small + sb, 1);
    wgmma_tf32<N>(part, a_big + sa, b_big + sb, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(part);
}

// Item x's stages, then its epilogue.  D: sum[4j + q] is A's row 16·warp +
// g + 8·(q / 2) of the warpgroup's 64, B's column 8j + 2t + q % 2 (g = lane
// / 4, t = lane % 4): d_rhs stores sum[i], sum[i + 1] (i even) as one
// float2 where N is even.
template <bool kDrhs, int N>
__device__ __forceinline__ void mma_item(const Smem& sh, const Params& p, const Work& x,
                                         uint32_t& ring, int tid) {
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float sum[N / 2], part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = 0.f;
  for (int s = 0; s < x.stages; ++s, ++ring) {
    const int buf = ring % kBufs;
    mbar_wait(sh.op_full(buf), (ring / kBufs) & 1);
    // the stage's k8 steps, each case a whole wgmma sequence (none on a divergent path)
    switch ((stage_valid<kDrhs>(p, x, s) + 7) / 8) {
      case 1: mma_stage<N, 1>(sh, buf, wg, part); break;
      case 2: mma_stage<N, 2>(sh, buf, wg, part); break;
      case 3: mma_stage<N, 3>(sh, buf, wg, part); break;
      default: mma_stage<N, 4>(sh, buf, wg, part); break;
    }
    if (lane == 0) mbar_arrive(sh.op_empty(buf));
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum[i] += part[i];
  }

  const int gq = lane >> 2, t = lane & 3;
  const int k_row = x.k0 + wg * 64 + 16 * warp + gq;
  if constexpr (!kDrhs) {  // d_lhs[row0 + column][k]
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int k = k_row + 8 * ((i >> 1) & 1), r = 8 * (i >> 2) + 2 * t + (i & 1);
      if (r < x.it.count && k < p.K) p.out[(x.it.row0 + r) * p.K + k] = sum[i];
    }
    return;
  } else {  // d_rhs[g][k][n0 + column]
    float* o = p.out + x.it.g * static_cast<long long>(p.K) * p.N;
    const bool pairs = p.N % 2 == 0;
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
      const int k = k_row + 8 * ((i >> 1) & 1), n = x.n0 + 8 * (i >> 2) + 2 * t;
      float* d = o + static_cast<long long>(k) * p.N + n;
      if (k >= p.K || n >= p.N) continue;
      if (pairs) {
        *reinterpret_cast<float2*>(d) = make_float2(sum[i], sum[i + 1]);
      } else {
        d[0] = sum[i];
        if (n + 1 < p.N) d[1] = sum[i + 1];
      }
    }
  }
}

// -- the kernel ---------------------------------------------------------------------

template <bool kDrhs>
__global__ void __launch_bounds__(kThreads, 1) kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Smem sh{smem};
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int b = 0; b < kBufs; ++b) {
      mbar_init(sh.full(b), (p.a_tma ? 1 : 32) + (p.b_tma ? 1 : 32));  // an arrival a box or lane
      mbar_init(sh.op_full(b), 128);         // every thread of its split warpgroup
      mbar_init(sh.op_empty(b), kMma / 32);  // a lane of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  long long total_tiles, total_rows;
  totals(p.sizes, p.G, p.M, lane, total_tiles, total_rows, kDrhs ? kWholeGroup : kNT, kDrhs);
  const int kt = (p.K + kMT - 1) / kMT;
  const int nt = kDrhs ? (p.N + kNT - 1) / kNT : 1;
  const int per = kt * nt;  // items a row tile
  const long long items = total_tiles * per;

  if (tid >= kMma) {  // the split warpgroups: 0 the even stages, 1 the odd ones
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kSplitRegs));
    const int sw = (tid - kMma) >> 7, ts = (tid - kMma) & 127;
    const bool producer = ts < 32;  // the warpgroup's first warp fills its slot
    Walker<kDrhs> next(p, per, nt, items, lane);  // the warpgroup's next stage
    if (sw == 1) next.advance(p, lane);
    if (producer && next.valid) issue_stage<kDrhs>(sh, p, next.x, next.s, sw, lane);
    for (uint32_t k = 0; next.valid; ++k) {
      const Work x = next.x;
      const int s = next.s;
      next.advance(p, lane);
      next.advance(p, lane);
      mbar_wait(sh.full(sw), k & 1);
      auto refill = [&]() {
        if (producer && next.valid) issue_stage<kDrhs>(sh, p, next.x, next.s, sw, lane);
      };
      switch (x.n) {
        case 8: split_stage<kDrhs, 8>(sh, p, x, s, sw, k, ts, refill); break;
        case 16: split_stage<kDrhs, 16>(sh, p, x, s, sw, k, ts, refill); break;
        case 32: split_stage<kDrhs, 32>(sh, p, x, s, sw, k, ts, refill); break;
        case 64: split_stage<kDrhs, 64>(sh, p, x, s, sw, k, ts, refill); break;
        default: split_stage<kDrhs, 128>(sh, p, x, s, sw, k, ts, refill); break;
      }
      fence_async_shared();
      mbar_arrive(sh.op_full(sw));
    }
  } else {  // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kMmaRegs));
    Cursor cur;
    uint32_t ring = 0;  // stages consumed
    for (long long w = blockIdx.x; w < items; w += gridDim.x) {
      const Work x = work_of<kDrhs>(p, cur, w, per, nt, lane);
      switch (x.n) {
        case 8: mma_item<kDrhs, 8>(sh, p, x, ring, tid); break;
        case 16: mma_item<kDrhs, 16>(sh, p, x, ring, tid); break;
        case 32: mma_item<kDrhs, 32>(sh, p, x, ring, tid); break;
        case 64: mma_item<kDrhs, 64>(sh, p, x, ring, tid); break;
        default: mma_item<kDrhs, 128>(sh, p, x, ring, tid); break;
      }
    }
    if constexpr (!kDrhs) {  // d_lhs rows past the groups: zeros, split over the CTAs
      const long long tail = (p.M - total_rows) * p.K;
      float* z = p.out + total_rows * p.K;
      for (long long i = static_cast<long long>(blockIdx.x) * kMma + tid; i < tail;
           i += static_cast<long long>(gridDim.x) * kMma) {
        z[i] = 0.f;
      }
    }
  }
}

}  // namespace b6

struct DeviceSetup {
  bool done = false;
  int sms = 0;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Tensor maps hold the operand's address, so each call needs its own; they
// are cached by address, shape and box (a map is a function of these
// alone), so the 72 weight tensors of a decode step are encoded once.
struct MapSlot {
  const void* ptr = nullptr;
  cuuint64_t dims[3] = {0, 0, 0};
  cuuint32_t box[2] = {0, 0};
  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap map;
};

std::mutex g_map_mutex;
MapSlot g_maps[256];

// The map of the row-major float32 array at `ptr` with `rank` dims
// (innermost first) and a box of box[1] x box[0].  False where TMA cannot
// address it: a base not 16-byte aligned, an inner row not a multiple of
// 16 bytes, or a refused encoding.
bool tensor_map(CUtensorMap* out, const void* ptr, int rank, const cuuint64_t* dims,
                const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  static bool looked = false;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || (dims[0] * 4) % 16 != 0) return false;
  cuuint64_t d[3] = {dims[0], dims[1], rank == 3 ? dims[2] : 1};
  const size_t h = (reinterpret_cast<uintptr_t>(ptr) >> 8) ^ (d[0] * 131) ^ (d[1] * 31) ^ d[2] ^
                   (box[1] << 20);
  std::lock_guard<std::mutex> lock(g_map_mutex);
  MapSlot& slot = g_maps[h % 256];
  if (slot.ptr == ptr && slot.dims[0] == d[0] && slot.dims[1] == d[1] && slot.dims[2] == d[2] &&
      slot.box[0] == box[0] && slot.box[1] == box[1] && slot.swizzle == swizzle) {
    *out = slot.map;
    return true;
  }
  if (!looked) {
    looked = true;
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess) {
      encode = reinterpret_cast<EncodeTiled>(fn);
    }
  }
  if (encode == nullptr) return false;
  const cuuint64_t strides[2] = {d[0] * 4, d[0] * d[1] * 4};  // bytes, of dims 1 and 2
  const cuuint32_t box3[3] = {box[0], box[1], 1}, ones[3] = {1, 1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr), d, strides, box3,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  slot.ptr = ptr;
  for (int i = 0; i < 3; ++i) slot.dims[i] = d[i];
  slot.box[0] = box[0];
  slot.box[1] = box[1];
  slot.swizzle = swizzle;
  slot.map = *out;
  return true;
}

// Per device: the kernel's shared-memory attributes set, and the SM count.
template <typename Kernel>
int device_setup(DeviceSetup* setup, Kernel kernel, int smem_bytes, int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceSetup& s = setup[dev];
  if (!s.done) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess)  // the most shared memory a CTA can have
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    s.done = true;
  }
  sms = s.sms;
  return static_cast<int>(cudaSuccess);
}

// One launch of B3's engine.
int launch(const void* lhs, const void* rhs, const void* sizes, void* out, long long M, int K,
           int N, int G, void* stream) {
  if (M < 0 || K < 1 || N < 0 || G < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  static DeviceSetup setup[64];
  int sms = 0;
  const int err = device_setup(setup, grouped_matmul_kernel, kSmemBytes, sms);
  if (err != 0) return err;
  Params p;
  p.lhs = static_cast<const float*>(lhs);
  p.rhs = static_cast<const float*>(rhs);
  p.sizes = static_cast<const int*>(sizes);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.G = G;
  const cuuint64_t k64 = static_cast<cuuint64_t>(K), n64 = static_cast<cuuint64_t>(N);
  const cuuint64_t w_dims[3] = {n64, k64, static_cast<cuuint64_t>(G)};
  const cuuint32_t w_box[2] = {kTileN, kKB};
  p.w_tma = G > 0 && tensor_map(&p.w_map, rhs, 3, w_dims, w_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  const cuuint64_t l_dims[2] = {k64, static_cast<cuuint64_t>(M)};
  const cuuint32_t l_box8[2] = {kKB, 8}, l_box_tile[2] = {kKB, kRowTile};
  p.l_tma = tensor_map(&p.l_map8, lhs, 2, l_dims, l_box8, CU_TENSOR_MAP_SWIZZLE_128B) &&
            tensor_map(&p.l_map_tile, lhs, 2, l_dims, l_box_tile, CU_TENSOR_MAP_SWIZZLE_128B);
  grouped_matmul_kernel<<<sms * kCtasPerSm, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One launch of B6's kernel: a = lhs (d_rhs) or rhs (d_lhs), g (M, N); out
// (G, K, N) or (M, K).
template <bool kDrhs>
int launch_b6(const void* a, const void* g, const void* sizes, void* out, long long M, int K,
              int N, int G, void* stream) {
  using b6::kKB;
  using b6::kMT;
  using b6::kNT;
  if (M < 0 || K < 0 || N < 0 || G < 0 || (!kDrhs && N < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0 || N == 0 || (kDrhs ? G == 0 : M == 0)) return static_cast<int>(cudaSuccess);
  static DeviceSetup setup[64];
  int sms = 0;
  const int err = device_setup(setup, b6::kernel<kDrhs>, b6::kSmemBytes, sms);
  if (err != 0) return err;
  b6::Params p;
  p.a = static_cast<const float*>(a);
  p.g = static_cast<const float*>(g);
  p.sizes = static_cast<const int*>(sizes);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.G = G;
  const cuuint64_t k64 = static_cast<cuuint64_t>(K), n64 = static_cast<cuuint64_t>(N);
  const cuuint64_t g_dims[2] = {n64, static_cast<cuuint64_t>(M)};
  if constexpr (kDrhs) {  // row-major boxes of 32 rows
    const cuuint64_t a_dims[2] = {k64, static_cast<cuuint64_t>(M)};
    const cuuint32_t a_box[2] = {kMT, kKB}, b_box[2] = {kNT, kKB};
    p.a_tma = tensor_map(&p.a_map, a, 2, a_dims, a_box, CU_TENSOR_MAP_SWIZZLE_NONE);
    p.b_tma = tensor_map(&p.b_map[0], g, 2, g_dims, b_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {  // 32 N a row, swizzled
    const cuuint64_t a_dims[3] = {n64, k64, static_cast<cuuint64_t>(G)};
    const cuuint32_t a_box[2] = {kKB, kMT};
    const cuuint32_t b_box8[2] = {kKB, 8}, b_box32[2] = {kKB, 32}, b_box_nt[2] = {kKB, kNT};
    p.a_tma = G > 0 && tensor_map(&p.a_map, a, 3, a_dims, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
    p.b_tma = tensor_map(&p.b_map[0], g, 2, g_dims, b_box8, CU_TENSOR_MAP_SWIZZLE_128B) &&
              tensor_map(&p.b_map[1], g, 2, g_dims, b_box32, CU_TENSOR_MAP_SWIZZLE_128B) &&
              tensor_map(&p.b_map[2], g, 2, g_dims, b_box_nt, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  b6::kernel<kDrhs><<<sms, b6::kThreads, b6::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one grouped matmul on `stream`: lhs (M, K), rhs (G, K, N), sizes
// (G,) int32 and out (M, N), all contiguous, float32 but `sizes`, on the
// current device; any alignment (TMA boxes where the operand is 16-byte
// aligned with rows a multiple of 16 bytes, 4-byte cp.async copies
// elsewhere).  Every element of `out` is written.
// Returns a cudaError_t as an int (0 = launched); the caller checks shapes,
// types and devices.
int grouped_matmul_launch(const void* lhs, const void* rhs, const void* sizes, void* out,
                          long long M, int K, int N, int G, void* stream) {
  return launch(lhs, rhs, sizes, out, M, K, N, G, stream);
}

// B6's first product, d_lhs = g · rhs[e]^T row by row: g (M, N), rhs (G, K,
// N) as in the forward, out (M, K), rows past the groups zero.  Same
// conventions as grouped_matmul_launch.
int grouped_matmul_dlhs_launch(const void* g, const void* rhs, const void* sizes, void* out,
                               long long M, int K, int N, int G, void* stream) {
  return launch_b6<false>(rhs, g, sizes, out, M, K, N, G, stream);
}

// B6's second product, d_rhs[e] = lhs[rows_e]^T · g[rows_e]: lhs (M, K), g
// (M, N), out (G, K, N), a group with no rows exactly zero.  Every element
// of `out` is written; any alignment.
int grouped_matmul_drhs_launch(const void* lhs, const void* g, const void* sizes, void* out,
                               long long M, int K, int N, int G, void* stream) {
  return launch_b6<true>(lhs, g, sizes, out, M, K, N, G, stream);
}

const char* grouped_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
