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
// a call, one a product:
// - d_lhs[r] = g[r] · rhs[e(r)]^T is this engine with the weight's role
//   transposed (template flag kWT): the contraction runs along N, along
//   which each row of rhs[e] (K, N) is contiguous, so the weight box is
//   already K-major: a TMA box of 64 weight rows x 32 N with the 128-byte
//   swizzle (the row stage's layout), read by the consumer as 16-byte
//   chunks with no transposition.  The item list, rings, 3xTF32 split,
//   per-stage partial sums and the zeroed tail are B3's.
// - d_rhs[e] = lhs[rows_e]^T · g[rows_e] (K, N) reduces over a group's
//   rows: float32 FMAs on the CUDA cores (see the note above
//   grouped_matmul_drhs_kernel for its design and bound).
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
  int count;       // rows, 1..kRowTile
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

// The 32 groups at the cursor: this lane's group's first row (clamped),
// rows (clamped) and the row tiles up to and including it.
struct Window {
  long long first, rows_incl, tiles_incl;
  int rows;
};

__device__ __forceinline__ Window window(const int* __restrict__ sizes, int G, long long M,
                                         const Cursor& c, int lane) {
  const int g = c.g + lane;
  const long long s = g < G ? max(__ldg(sizes + g), 0) : 0;
  const long long incl = c.rows + warp_inclusive_sum(s, lane);
  const long long first = min(incl - s, M);
  const int rows = static_cast<int>(min(incl, M) - first);
  const long long tiles = (rows + kRowTile - 1) / kRowTile;
  return {first, incl, c.tiles + warp_inclusive_sum(tiles, lane), rows};
}

// Row tile t (a warp-uniform index, not below the cursor's earlier
// queries) of the flattened groups.  Called by a whole warp.
__device__ __forceinline__ Item find_tile(const int* __restrict__ sizes, int G, long long M,
                                          Cursor& c, long long t, int lane) {
  while (true) {
    const Window w = window(sizes, G, M, c, lane);
    const unsigned hit = __ballot_sync(0xffffffffu, c.g + lane < G && t < w.tiles_incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const long long tiles_incl = __shfl_sync(0xffffffffu, w.tiles_incl, src);
      const int rows = __shfl_sync(0xffffffffu, w.rows, src);
      const long long first = __shfl_sync(0xffffffffu, w.first, src);
      const long long tiles = (rows + kRowTile - 1) / kRowTile;
      const int tile = static_cast<int>(t - (tiles_incl - tiles));
      return {c.g + src, first + static_cast<long long>(tile) * kRowTile,
              min(kRowTile, rows - tile * kRowTile)};
    }
    c.rows = __shfl_sync(0xffffffffu, w.rows_incl, 31);
    c.tiles = __shfl_sync(0xffffffffu, w.tiles_incl, 31);
    c.g += 32;
  }
}

// (row tiles, rows routed, clamped to M) over all groups.  Whole warp.
__device__ __forceinline__ void totals(const int* __restrict__ sizes, int G, long long M,
                                       int lane, long long& tiles, long long& rows) {
  Cursor c;
  for (; c.g < G; c.g += 32) {
    const Window w = window(sizes, G, M, c, lane);
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

// K is the contraction and N the output width: B3's lhs (M, K), rhs (G, K,
// N) and out (M, N); for d_lhs (kWT) g (M, K), rhs read as (G, N, K) and
// out (M, N).
struct Params {
  CUtensorMap w_map;     // rhs as (G, K, N), boxes of 1 x 32 x 64; kWT: (G, N, K), 1 x 64 x 32
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

// A weight stage into the A copies: thread tid takes weight column m =
// tid % 64 and k chunks tid / 64 + 2i.  B3 (kWT false): the stage is kKB
// rows x 64 columns, N-major, read transposed.  d_lhs (kWT true): 64 rows
// of kKB contiguous K, swizzled as a row stage, read as 16-byte chunks (the
// 8 lanes of a phase read 8 rows' chunks on distinct banks).
template <bool kWT>
__device__ __forceinline__ void store_weights(const Shared& sh, int buf, const float* w,
                                              int kvalid, int tid) {
  const int m = tid & 63;
#pragma unroll
  for (int i = 0; i < kKB / 8; ++i) {
    const int c = (tid >> 6) + 2 * i, k = 4 * c;
    float4 x;
    if constexpr (kWT) {
      x = *reinterpret_cast<const float4*>(w + row_offset(m, k));
      if (k >= kvalid) x.x = 0.f;
      if (k + 1 >= kvalid) x.y = 0.f;
      if (k + 2 >= kvalid) x.z = 0.f;
      if (k + 3 >= kvalid) x.w = 0.f;
    } else {
      x.x = k < kvalid ? w[k * kTileN + m] : 0.f;
      x.y = k + 1 < kvalid ? w[(k + 1) * kTileN + m] : 0.f;
      x.z = k + 2 < kvalid ? w[(k + 2) * kTileN + m] : 0.f;
      x.w = k + 3 < kvalid ? w[(k + 3) * kTileN + m] : 0.f;
    }
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
template <bool kWT, int NI>
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
  store_weights<kWT>(sh, buf, sh.w(ws), kvalid, tid);
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

template <bool kWT, int NI>
__device__ __forceinline__ void consume_item(const Shared& sh, const Params& p, const Item& it,
                                             int n0, uint32_t& ring, int tid) {
  float sum[NI / 2], part[NI / 2];
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) sum[i] = 0.f;
  const int nkb = (p.K + kKB - 1) / kKB;
  for (int b = 0; b < nkb; ++b) consume_stage<kWT, NI>(sh, p, it, part, sum, b, ring, tid);
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

template <bool kWT>
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
      const float* wsrc = p.rhs + static_cast<long long>(it.g) * p.K * p.N +
                          (kWT ? static_cast<long long>(n0) * p.K : n0);
      const float* lsrc = p.lhs + it.row0 * p.K;
      for (int b = 0; b < nkb; ++b, ++ring) {
        const int k0 = b * kKB, kvalid = min(kKB, p.K - k0);
        const int ws = ring % kWStages, ls = ring % kLStages;
        mbar_wait(sh.empty_w(ws), ((ring / kWStages) & 1) ^ 1);
        const uint32_t wdst = smem_addr(sh.w(ws));
        if (p.w_tma) {  // one 32 x 64 box (kWT: 64 x 32), zeros past K and N
          if (lane == 0) {
            mbar_arrive_expect_tx(sh.full_w(ws), kWStageBytes);
            if constexpr (kWT) tma_load_3d(wdst, &p.w_map, k0, n0, it.g, sh.full_w(ws));
            else tma_load_3d(wdst, &p.w_map, n0, k0, it.g, sh.full_w(ws));
          }
        } else if constexpr (kWT) {
          for (int i = lane; i < kTileN * kKB; i += 32) {
            const int m = i / kKB, c = i % kKB;
            if (m < cols && c < kvalid) {
              cp_async4(wdst + row_offset(m, c) * 4,
                        wsrc + static_cast<long long>(m) * p.K + k0 + c);
            }
          }
          cp_async_arrive(sh.full_w(ws));
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
    if (it.count <= 8) consume_item<kWT, 8>(sh, p, it, n0, ring, tid);
    else if (it.count <= 16) consume_item<kWT, 16>(sh, p, it, n0, ring, tid);
    else consume_item<kWT, 32>(sh, p, it, n0, ring, tid);
  }
  // the rows past the groups: zeros, split over the CTAs
  const long long tail = (p.M - total_rows) * p.N;
  float* z = p.out + total_rows * p.N;
  for (long long i = static_cast<long long>(blockIdx.x) * kConsumers + tid; i < tail;
       i += static_cast<long long>(gridDim.x) * kConsumers) {
    z[i] = 0.f;
  }
}

// -- B6's d_rhs: d_rhs[e] = lhs[rows_e]^T · g[rows_e] ------------------------------
//
// The contraction is a group's rows, along which neither lhs (M, K) nor g
// (M, N) is contiguous, so both would need staging transposed for wgmma;
// this first kernel takes float32 FMAs on the CUDA cores instead (full
// float32, as the plain version).  Items are (group, 64-wide K tile,
// 64-wide N tile), group-major, every group included: a group with no rows
// writes exact zeros (granite's reduced config pads 8 experts to 16, so
// half its groups are always empty), so nothing assumes a zeroed output.
// A CTA of 256 threads walks its items w = blockIdx.x, += gridDim.x; per
// item it sums the sizes before the group on the device (no host read),
// then walks the group's rows in 32-row stages: each thread holds 8 values
// of each operand in registers while the stage before is summed, stores
// them to shared memory ([row][64], a warp's stores on 32 consecutive
// words), and adds 4 x 4 outputs a row from two 16-byte shared loads (the
// lhs load a broadcast).  Bound: 2·rows·K·N FMA operations, 0.13 ms at
// granite's training shape (8192 rows, K 1024, N 512) at 67 TFLOP/s, 2.5x
// the 3xTF32 tensor bound of the same product.  Imbalance: an expert with
// r rows makes K/64 · N/64 items of ceil(r / 32) stages each, and one
// expert can take thousands of the 8192 rows; its items are consecutive,
// so they land on as many different CTAs, and the launch ends when the
// CTAs that drew them do: a hot expert shows as a tail of at most one of
// its items (r / 32 stages) past the mean.
constexpr int kDTile = 64;       // K and N width of an item
constexpr int kDRows = 32;       // rows a stage
constexpr int kDThreads = 256;
constexpr int kDCtasPerSm = 3;

__global__ void __launch_bounds__(kDThreads, kDCtasPerSm)
grouped_matmul_drhs_kernel(const float* __restrict__ lhs, const float* __restrict__ g,
                           const int* __restrict__ sizes, float* __restrict__ out,
                           long long M, int K, int N, int G) {
  __shared__ __align__(16) float as[kDRows][kDTile];
  __shared__ __align__(16) float bs[kDRows][kDTile];
  __shared__ long long span[2];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lc = tid & 63, lr = tid >> 6;  // staging: column lc of rows lr + 4i
  const int kt = (K + kDTile - 1) / kDTile, nt = (N + kDTile - 1) / kDTile;
  const long long per_group = static_cast<long long>(kt) * nt;
  const long long items = per_group * G;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int e = static_cast<int>(w / per_group), t = static_cast<int>(w % per_group);
    const int k0 = (t / nt) * kDTile, n0 = (t % nt) * kDTile;
    if (tid < 32) {  // the group's first row: the sizes before it, summed by one warp
      long long s = 0;
      for (int i = tid; i < e; i += 32) s += max(__ldg(sizes + i), 0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (tid == 0) {
        span[0] = min(s, M);
        span[1] = min(s + max(__ldg(sizes + e), 0), M);
      }
    }
    __syncthreads();
    const long long first = span[0], end = span[1];
    const bool kin = k0 + lc < K, nin = n0 + lc < N;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float ra[8], rb[8];
    auto fetch = [&](long long r0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long row = r0 + lr + 4 * i;
        const bool live = row < end;
        ra[i] = live && kin ? __ldg(lhs + row * K + k0 + lc) : 0.f;
        rb[i] = live && nin ? __ldg(g + row * N + n0 + lc) : 0.f;
      }
    };
    if (first < end) fetch(first);
    for (long long r0 = first; r0 < end; r0 += kDRows) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        as[lr + 4 * i][lc] = ra[i];
        bs[lr + 4 * i][lc] = rb[i];
      }
      __syncthreads();
      if (r0 + kDRows < end) fetch(r0 + kDRows);  // the next stage, in flight while this one sums
#pragma unroll 8
      for (int r = 0; r < kDRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&as[r][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[r][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    float* o = out + (static_cast<long long>(e) * K + k0 + 4 * ty) * N + n0 + 4 * tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k0 + 4 * ty + i >= K) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + 4 * tx + j < N) o[static_cast<long long>(i) * N + j] = acc[i][j];
      }
    }
    __syncthreads();  // every thread has read `span` before the next item rewrites it
  }
}

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

// One launch of the engine: K is the contraction and N the output width
// (see Params); for kWT the weights are read as (G, N, K).
template <bool kWT>
int launch(const void* lhs, const void* rhs, const void* sizes, void* out, long long M, int K,
           int N, int G, void* stream) {
  if (M < 0 || K < 1 || N < 0 || G < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  static DeviceSetup setup[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceSetup& s = setup[dev];
  if (!s.done) {
    err = cudaFuncSetAttribute(grouped_matmul_kernel<kWT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)  // room for kCtasPerSm CTAs an SM
      err = cudaFuncSetAttribute(grouped_matmul_kernel<kWT>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    s.done = true;
  }
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
  const cuuint64_t w_dims[3] = {kWT ? k64 : n64, kWT ? n64 : k64, static_cast<cuuint64_t>(G)};
  const cuuint32_t w_box[2] = {kWT ? kKB : kTileN, kWT ? kTileN : kKB};
  p.w_tma = G > 0 && tensor_map(&p.w_map, rhs, 3, w_dims, w_box,
                                kWT ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  const cuuint64_t l_dims[2] = {k64, static_cast<cuuint64_t>(M)};
  const cuuint32_t l_box8[2] = {kKB, 8}, l_box_tile[2] = {kKB, kRowTile};
  p.l_tma = tensor_map(&p.l_map8, lhs, 2, l_dims, l_box8, CU_TENSOR_MAP_SWIZZLE_128B) &&
            tensor_map(&p.l_map_tile, lhs, 2, l_dims, l_box_tile, CU_TENSOR_MAP_SWIZZLE_128B);
  grouped_matmul_kernel<kWT><<<s.sms * kCtasPerSm, kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(p);
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
  return launch<false>(lhs, rhs, sizes, out, M, K, N, G, stream);
}

// B6's first product, d_lhs = g · rhs[e]^T row by row: g (M, N), rhs (G, K,
// N) as in the forward, out (M, K), rows past the groups zero.  Same
// conventions as grouped_matmul_launch.
int grouped_matmul_dlhs_launch(const void* g, const void* rhs, const void* sizes, void* out,
                               long long M, int K, int N, int G, void* stream) {
  return launch<true>(g, rhs, sizes, out, M, N, K, G, stream);
}

// B6's second product, d_rhs[e] = lhs[rows_e]^T · g[rows_e]: lhs (M, K), g
// (M, N), out (G, K, N), a group with no rows exactly zero.  Every element
// of `out` is written; any alignment.
int grouped_matmul_drhs_launch(const void* lhs, const void* g, const void* sizes, void* out,
                               long long M, int K, int N, int G, void* stream) {
  if (M < 0 || K < 0 || N < 0 || G < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0 || N == 0 || G == 0) return static_cast<int>(cudaSuccess);
  static DeviceSetup setup[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceSetup& s = setup[dev];
  if (!s.done) {
    err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    s.done = true;
  }
  const long long items = static_cast<long long>(G) * ((K + kDTile - 1) / kDTile) *
                          ((N + kDTile - 1) / kDTile);
  const long long ctas = static_cast<long long>(s.sms) * kDCtasPerSm;
  const int grid = static_cast<int>(items < ctas ? items : ctas);
  grouped_matmul_drhs_kernel<<<grid, kDThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(g),
      static_cast<const int*>(sizes), static_cast<float*>(out), M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}

const char* grouped_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
