// Segment-aggregate kernel for Hopper (sm_90a): fold (ticket, value) rows
// into a dense (G,) float32 accumulator that the wrapper fills with the
// kind's neutral.
//
// Replaces: src/repro/kernels/segment_agg.py, `segment_agg_pallas` →
// `_segment_kernel` (the Pallas TPU kernel of ExecutionPolicy.kernel="split"
// and of the scan_body route).
//
// What it computes: acc[t] (+)= v for every row with 0 <= t < G, where (+)
// is +, min or max; `count` adds 1.0 per row and reads no value.  Rows
// with t < 0 are parked and rows with t >= G dropped (the reference's
// scatter drops an out-of-range index; on the card it would write out of
// bounds).
//
// Bound on this card: bytes.  The least traffic is the tickets and values
// read once (8 B a row) plus each touched accumulator read and written
// once, over 3.35 TB/s.
//
// Design: two strategies, as in the reference.
//   scatter: persistent CTAs take tiles of kFoldThreads × kFoldRows rows.
//     Equal tickets fold before the device atomic, in two steps:
//       1. in the warp: __match_any_sync groups the lanes that hold one
//          ticket, and a shuffle tree over each group's ranks combines its
//          values into the group's lowest lane (count takes the group's
//          size), so a hot ticket costs one update per warp, not 32;
//       2. in the CTA: the lowest lanes fold into an open-addressed table in
//          shared memory keyed by ticket (shared atomicCAS on the key,
//          kFoldProbes probes, block-scope atomics on the accumulator).  A
//          ticket that finds no slot folds straight into device memory.
//     The table is flushed, one device atomic per live slot, when more than
//     half full after a tile and when the CTA ends: a hot key costs one
//     device atomic per CTA flush instead of one per row (the zipf chunk's
//     hot key takes about half the rows), and a CTA whose rows repeat few
//     tickets (the low class) flushes each once.  On distinct tickets the
//     warp step finds no group and costs a match and a vote, and a CTA
//     that finds a slot taken for nearly every row it folded (>= 31/32 of
//     at least kFoldThreads rows) folds into device memory directly from
//     then on.
//   onehot: the TPU puts a contended small-G fold on the MXU.  Here each
//     CTA keeps a private copy of the G accumulators in dynamic shared
//     memory, folds its rows with block-scope shared-memory atomics, and
//     flushes the entries it touched once with device-scope atomics.  It
//     takes G <= kMaxOnehotGroups (224 KiB of the 227 KiB a block may use).
//   serialized: one thread folds the rows in row order, one at a time.  It
//     replaces no Pallas kernel: its reference is core/updates.py
//     `serialized_update` (src/repro/core/updates.py:219, a
//     jax.lax.fori_loop), the paper's fine-grained-locking stand-in, which
//     exists to measure what full serialization costs; so one thread still
//     does every fold, and min / max replace the accumulator only when
//     v < a (v > a), as the plain row loop does.  Its bound is the folding
//     thread's latency, not bytes, so nothing else may wait on the fold:
//     no row's ticket, value or accumulator read may stand in line behind
//     the previous row's write (about 73 ns a row on an H100 80GB HBM3 at
//     700 W, one L2 round trip, when they went to device memory one after
//     the other).  One CTA: its warps 1.. stage the next tile of
//     kSerialTileRows tickets and values into shared memory (16-byte loads
//     where aligned) while thread 0 folds the current one (double
//     buffered, one barrier a tile).  As they stage, those warps clean the
//     tickets (a row outside [0, G) gets a ticket that folds nothing) and
//     mark, per 32-row block, the rows whose ticket an earlier row of the
//     block holds (one __match_any_sync a block).  When the G accumulators
//     fit beside the two tiles (G <= kMaxSerialSharedGroups, 208 KiB), the
//     plane lives in shared memory, loaded at the start and written back at
//     the end; above that it stays in device memory, rows still staged.
//     The folding thread takes a block at a time: it issues the reads of
//     its 32 accumulators together, then folds and stores the rows in row
//     order, reading a marked row's accumulator again after the earlier
//     row's store.  Each accumulator still sees its rows in row order, so
//     sums round as the row loop rounds them.  Rows that fold nothing
//     take slot G of the shared plane (zeroed at the start, never written
//     back), so the folding thread's common path has no predicate; the
//     ticket compares stay off the folding thread, which has no other warp
//     to hide them.
// Float min/max are integer atomics on the bits, split by the sign bit:
// non-negative floats order like their int bits, negative floats reversed
// as unsigned bits; correct against the ±inf neutrals and for -0.0.  The
// warp step compares in the same total order of bit patterns.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSum = 0, kCount = 1, kMin = 2, kMax = 3;
constexpr int kScatter = 0, kOnehot = 1, kSerialized = 2;
constexpr int kOnehotThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
// scatter: rows per thread per tile, and the CTA's fold table (a power of
// two of slots, a ticket and an accumulator each: 64 KiB)
constexpr int kFoldThreads = 512;
constexpr int kFoldRows = 4;
constexpr int kFoldSlots = 8192;
constexpr int kFoldProbes = 16;
constexpr int kMaxOnehotGroups = 56 * 1024;
// onehot: each CTA takes at least this many rows per group it may flush,
// so the flush stays a small share of the atomics
constexpr int kOnehotRowsPerGroup = 8;
// serialized: the rows of a staged tile (ticket + value: 8 KiB, two of
// them, and a repeat mask a 32-row block), the staging warps (one 128-row
// span each) beside the folding warp, and the largest G whose accumulator
// plane lives in shared memory beside the two tiles (208 + 16.25 of 227 KiB)
constexpr int kSerialTileRows = 1024;
constexpr int kSerialBlocks = kSerialTileRows / 32;          // repeat masks a tile
constexpr int kStagers = kSerialTileRows / 128;              // staging warps: a span each
constexpr int kSerialThreads = 32 * (1 + kStagers);
constexpr int kMaxSerialSharedGroups = 52 * 1024;
constexpr int kSerialTileBytes = 2 * (kSerialTileRows * 8 + kSerialBlocks * 4);

template <int Kind>
__device__ __forceinline__ float neutral() {
  return Kind == kMin ? INFINITY : (Kind == kMax ? -INFINITY : 0.0f);
}

// Device-scope fold into device memory.
template <int Kind>
__device__ __forceinline__ void fold_device(float* a, float v) {
  if (Kind == kSum || Kind == kCount) {
    atomicAdd(a, v);
  } else if (Kind == kMin) {
    if (!signbit(v)) atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
    else atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  } else {
    if (!signbit(v)) atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
    else atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  }
}

// Block-scope fold into the CTA's shared-memory copy.
template <int Kind>
__device__ __forceinline__ void fold_block(float* a, float v) {
  if (Kind == kSum || Kind == kCount) {
    atomicAdd_block(a, v);
  } else if (Kind == kMin) {
    if (!signbit(v)) atomicMin_block(reinterpret_cast<int*>(a), __float_as_int(v));
    else atomicMax_block(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  } else {
    if (!signbit(v)) atomicMax_block(reinterpret_cast<int*>(a), __float_as_int(v));
    else atomicMin_block(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  }
}

// The total order of float bit patterns that the sign-split atomics use:
// -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN.
__device__ __forceinline__ unsigned ordered_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int Kind>
__device__ __forceinline__ float combine(float a, float b) {
  if (Kind == kSum || Kind == kCount) return a + b;
  const unsigned ua = ordered_bits(a), ub = ordered_bits(b);
  return (Kind == kMin ? ua <= ub : ua >= ub) ? a : b;
}

// Combine v over each group of lanes that share a ticket (`peers`, this
// lane's group from __match_any_sync); the group's lowest lane gets the
// result.  A tree over the ranks within each group: at step k, a lane
// whose rank is a multiple of 2k takes the value of the lane k ranks
// above it.  Every lane of the warp calls it.
template <int Kind>
__device__ __forceinline__ float warp_fold(unsigned peers, float v, int lane) {
  const unsigned above = peers & ~((2u << lane) - 1u);  // peers of higher rank
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int size = __popc(peers);
  for (int k = 1; __any_sync(kFull, k < size); k <<= 1) {
    int src = lane;
    if ((rank & (2 * k - 1)) == 0 && rank + k < size) {
      unsigned m = above;
      for (int i = 1; i < k; ++i) m &= m - 1;  // drop the k-1 nearest
      src = __ffs(m) - 1;
    }
    const float y = __shfl_sync(kFull, v, src);
    if (src != lane) v = combine<Kind>(v, y);
  }
  return v;
}

// Fold (t, v) into the CTA's table (s_key: ticket or -1 free), or into
// device memory when kFoldProbes slots hold other tickets.  Returns 1 when
// it took a free slot.
template <int Kind>
__device__ __forceinline__ int fold_local(int* s_key, float* s_acc, float* acc, int t,
                                          float v) {
  int h = t & (kFoldSlots - 1);
  for (int q = 0; q < kFoldProbes; ++q) {
    int k = *static_cast<volatile int*>(s_key + h);
    int took = 0;
    if (k == -1) {
      k = atomicCAS_block(s_key + h, -1, t);
      if (k == -1) {
        took = 1;
        k = t;
      }
    }
    if (k == t) {
      fold_block<Kind>(s_acc + h, v);
      return took;
    }
    h = (h + 1) & (kFoldSlots - 1);
  }
  fold_device<Kind>(acc + t, v);
  return 0;
}

// Flush the CTA's table into device memory and empty it.  Called by every
// thread of the CTA after a __syncthreads.
template <int Kind>
__device__ __forceinline__ void flush_table(int* s_key, float* s_acc, int* s_entries,
                                            int* s_leads, float* acc) {
  for (int h = threadIdx.x; h < kFoldSlots; h += blockDim.x) {
    const int t = s_key[h];
    if (t < 0) continue;
    fold_device<Kind>(acc + t, s_acc[h]);
    s_key[h] = -1;
    s_acc[h] = neutral<Kind>();
  }
  __syncthreads();
  if (threadIdx.x == 0) *s_entries = *s_leads = 0;
  __syncthreads();
}

template <int Kind>
__global__ void __launch_bounds__(kFoldThreads) segment_scatter_kernel(
    const int* __restrict__ tickets, const float* __restrict__ values,
    float* __restrict__ acc, long long n, int G) {
  extern __shared__ int fold_smem[];
  int* s_key = fold_smem;                                       // (kFoldSlots,)
  float* s_acc = reinterpret_cast<float*>(fold_smem + kFoldSlots);  // (kFoldSlots,)
  __shared__ int s_entries, s_leads;  // since the last flush: slots taken, rows folded
  for (int h = threadIdx.x; h < kFoldSlots; h += blockDim.x) {
    s_key[h] = -1;
    s_acc[h] = neutral<Kind>();
  }
  if (threadIdx.x == 0) s_entries = s_leads = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(kFoldThreads) * kFoldRows;
  // set once a tile ends with nearly every row folded into the table since
  // the last flush in a slot of its own: the table saves no device atomic
  // there (distinct tickets), so the CTA flushes it and folds into device
  // memory directly from then on.  Every thread reads the tile's counters
  // between two barriers and no thread adds to them in between, so every
  // warp takes the same decision (and the same barriers).
  bool direct = false;
  for (long long base = blockIdx.x * tile; base < n; base += gridDim.x * tile) {
    int t[kFoldRows], took = 0, leads = 0;
    float v[kFoldRows];
#pragma unroll
    for (int j = 0; j < kFoldRows; ++j) {
      const long long r = base + j * kFoldThreads + threadIdx.x;
      t[j] = r < n ? tickets[r] : -1;
      v[j] = Kind == kCount || r >= n ? 1.0f : values[r];
    }
#pragma unroll
    for (int j = 0; j < kFoldRows; ++j) {
      const bool ok = t[j] >= 0 && t[j] < G;
      // rows outside [0, G) get a group of their own (a negative id)
      const unsigned peers = __match_any_sync(kFull, ok ? t[j] : -1 - lane);
      float x = v[j];
      if (__any_sync(kFull, peers != (1u << lane))) {
        x = Kind == kCount ? static_cast<float>(__popc(peers)) : warp_fold<Kind>(peers, x, lane);
      }
      if (ok && (peers & ((1u << lane) - 1u)) == 0) {
        if (direct) {
          fold_device<Kind>(acc + t[j], x);
        } else {
          took += fold_local<Kind>(s_key, s_acc, acc, t[j], x);
          ++leads;
        }
      }
    }
    if (direct) continue;
    // the tile's slots taken and rows folded, one shared add per warp
    took = __reduce_add_sync(kFull, took);
    leads = __reduce_add_sync(kFull, leads);
    if (lane == 0 && took != 0) atomicAdd_block(&s_entries, took);
    if (lane == 0 && leads != 0) atomicAdd_block(&s_leads, leads);
    __syncthreads();
    direct = s_leads >= kFoldThreads && s_entries * 32 >= s_leads * 31;
    const bool flush = direct || s_entries > kFoldSlots / 2;
    __syncthreads();  // every warp has read the counters
    if (flush) flush_table<Kind>(s_key, s_acc, &s_entries, &s_leads, acc);
  }
  __syncthreads();
  flush_table<Kind>(s_key, s_acc, &s_entries, &s_leads, acc);
}

template <int Kind>
__global__ void __launch_bounds__(kOnehotThreads) segment_onehot_kernel(
    const int* __restrict__ tickets, const float* __restrict__ values,
    float* __restrict__ acc, long long n, int G) {
  extern __shared__ float part[];  // (G,) this CTA's private accumulators
  for (int g = threadIdx.x; g < G; g += blockDim.x) part[g] = neutral<Kind>();
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const int t = tickets[r];
    if (t < 0 || t >= G) continue;
    fold_block<Kind>(part + t, Kind == kCount ? 1.0f : values[r]);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float p = part[g];
    if (p != neutral<Kind>()) fold_device<Kind>(acc + g, p);
  }
}

template <int Kind>
__device__ __forceinline__ float fold_one(float a, float v) {
  if (Kind == kSum || Kind == kCount) return __fadd_rn(a, Kind == kCount ? 1.0f : v);
  if (Kind == kMin) return v < a ? v : a;
  return v > a ? v : a;
}

// Stage rows [base, base + m) of the columns into a tile, by the staging
// warps (1..): warp w takes the 128-row spans w - 1, w - 1 + kStagers, ...
// of the tile, with 16-byte loads where the columns are aligned and the
// span is whole.  Then, per 32-row block, each ticket is cleaned (`skip`
// when outside [0, G) or past m) and the block's repeat mask is written:
// bit l when row l holds the ticket of an earlier row of the block.
template <int Kind>
__device__ __forceinline__ void stage_tile(const int* __restrict__ tickets,
                                           const float* __restrict__ values, long long base,
                                           int m, int G, int skip, bool vec, int* st,
                                           float* sv, unsigned* sflags) {
  const int lane = threadIdx.x & 31;
  for (int span = (threadIdx.x >> 5) - 1; span * 128 < m; span += kStagers) {
    const int r0 = span * 128 + 4 * lane;  // this lane's four rows of the span
    if (vec && span * 128 + 128 <= m) {
      *reinterpret_cast<int4*>(st + r0) =
          __ldg(reinterpret_cast<const int4*>(tickets + base + r0));
      if (Kind != kCount) {
        *reinterpret_cast<float4*>(sv + r0) =
            __ldg(reinterpret_cast<const float4*>(values + base + r0));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + e;
        st[r] = r < m ? __ldg(tickets + base + r) : -1;
        if (Kind != kCount) sv[r] = r < m ? __ldg(values + base + r) : 0.0f;
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = span * 128 + 32 * c + lane;
      const int t = st[r];
      const bool ok = r < m && t >= 0 && t < G;
      // rows that fold nothing get keys of their own: never a repeat
      const unsigned peers = __match_any_sync(kFull, ok ? t : -1 - lane);
      const unsigned repeat = __ballot_sync(kFull, (peers & ((1u << lane) - 1u)) != 0);
      st[r] = ok ? t : skip;
      if (lane == 0) sflags[r >> 5] = repeat;
    }
    __syncwarp();
  }
}

// The folding thread's fold of one staged 32-row block (cleaned tickets t,
// values v, repeat mask) into the accumulators `a`: the reads of all 32
// accumulators issued together, then the folds and stores in row order.  A
// row that repeats an earlier row's ticket reads its accumulator again,
// after that row's store, so each accumulator sees its rows in row order.
// kSharedAcc: `a` is the shared-memory plane, whose slot G takes the rows
// that fold nothing (no predicate a row); else device memory, where those
// rows hold -1 and touch nothing.
template <int Kind, bool kSharedAcc>
__device__ __forceinline__ void fold_block(const int* st, const float* sv, unsigned repeat,
                                           float* a) {
  int t[32];
  float v[32], cur[32];
#pragma unroll
  for (int q = 0; q < 32; q += 4) {
    const int4 t4 = *reinterpret_cast<const int4*>(st + q);
    t[q] = t4.x, t[q + 1] = t4.y, t[q + 2] = t4.z, t[q + 3] = t4.w;
    if (Kind != kCount) {
      const float4 v4 = *reinterpret_cast<const float4*>(sv + q);
      v[q] = v4.x, v[q + 1] = v4.y, v[q + 2] = v4.z, v[q + 3] = v4.w;
    } else {
      v[q] = v[q + 1] = v[q + 2] = v[q + 3] = 1.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) cur[j] = kSharedAcc || t[j] >= 0 ? a[t[j]] : 0.0f;
  if (repeat == 0) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (kSharedAcc || t[j] >= 0) a[t[j]] = fold_one<Kind>(cur[j], v[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float x = (repeat >> j) & 1u ? a[t[j]] : cur[j];
      if (kSharedAcc || t[j] >= 0) a[t[j]] = fold_one<Kind>(x, v[j]);
    }
  }
}

// Copy G floats between device and shared memory with the whole CTA, 16
// loads in flight a thread.
__device__ __forceinline__ void copy_plane(float* dst, const float* src, int G) {
  constexpr int kBatch = 16;
  for (int g = threadIdx.x; g < G; g += kSerialThreads * kBatch) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = g + u * kSerialThreads;
      x[u] = i < G ? src[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = g + u * kSerialThreads;
      if (i < G) dst[i] = x[u];
    }
  }
}

template <int Kind, bool kSharedAcc>
__global__ void __launch_bounds__(kSerialThreads) segment_serialized_kernel(
    const int* __restrict__ tickets, const float* __restrict__ values, float* __restrict__ acc,
    long long n, int G, bool vec) {
  extern __shared__ int serial_smem[];
  int* st = serial_smem;                                                          // (2, tile)
  float* sv = reinterpret_cast<float*>(serial_smem + 2 * kSerialTileRows);        // (2, tile)
  unsigned* sflags = reinterpret_cast<unsigned*>(serial_smem + 4 * kSerialTileRows);
  float* sacc = reinterpret_cast<float*>(serial_smem + 4 * kSerialTileRows +
                                         2 * kSerialBlocks);                      // (G + 1,)
  const int skip = kSharedAcc ? G : -1;  // the ticket of a row that folds nothing
  if (kSharedAcc) {
    copy_plane(sacc, acc, G);
    if (threadIdx.x == 0) sacc[G] = 0.0f;  // folded into, never written back
  }
  const long long tiles = (n + kSerialTileRows - 1) / kSerialTileRows;
  const auto rows_of = [&](long long k) {
    const long long left = n - k * kSerialTileRows;
    return static_cast<int>(left < kSerialTileRows ? left : kSerialTileRows);
  };
  if (threadIdx.x >= 32) {
    stage_tile<Kind>(tickets, values, 0, rows_of(0), G, skip, vec, st, sv, sflags);
  }
  __syncthreads();
  for (long long k = 0; k < tiles; ++k) {
    const int b = static_cast<int>(k & 1);
    if (threadIdx.x == 0) {
      const int m = rows_of(k);
      float* a = kSharedAcc ? sacc : acc;
      for (int blk = 0; blk * 32 < m; ++blk) {
        const int at = b * kSerialTileRows + 32 * blk;
        fold_block<Kind, kSharedAcc>(st + at, sv + at, sflags[b * kSerialBlocks + blk], a);
      }
    } else if (threadIdx.x >= 32 && k + 1 < tiles) {
      const int nb = 1 - b;
      stage_tile<Kind>(tickets, values, (k + 1) * kSerialTileRows, rows_of(k + 1), G, skip,
                       vec, st + nb * kSerialTileRows, sv + nb * kSerialTileRows,
                       sflags + nb * kSerialBlocks);
    }
    __syncthreads();
  }
  if (kSharedAcc) copy_plane(acc, sacc, G);
}

template <int Kind, bool kSharedAcc>
cudaError_t launch_serialized(const int* tickets, const float* values, float* acc, long long n,
                              int G, int dev, cudaStream_t stream) {
  static bool opted_in[64];
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (kSharedAcc && !opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_serialized_kernel<Kind, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSerialTileBytes + (kMaxSerialSharedGroups + 1) * 4);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(tickets) |
                     reinterpret_cast<uintptr_t>(values)) & 15u) == 0;
  const size_t smem = kSerialTileBytes + (kSharedAcc ? (static_cast<size_t>(G) + 1) * 4 : 0);
  segment_serialized_kernel<Kind, kSharedAcc><<<1, kSerialThreads, smem, stream>>>(
      tickets, values, acc, n, G, vec);
  return cudaGetLastError();
}

template <int Kind>
cudaError_t launch(int strategy, const int* tickets, const float* values, float* acc,
                   long long n, int G, int dev, int sms, cudaStream_t stream) {
  if (strategy == kSerialized) {
    return G <= kMaxSerialSharedGroups
               ? launch_serialized<Kind, true>(tickets, values, acc, n, G, dev, stream)
               : launch_serialized<Kind, false>(tickets, values, acc, n, G, dev, stream);
  }
  if (strategy == kScatter) {
    // the shared-memory opt-in and the occupancy, once per device
    static int per_sm_of[64];
    const size_t smem = static_cast<size_t>(kFoldSlots) * 2 * sizeof(int);
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (per_sm_of[dev] == 0) {
      int per_sm = 0;
      cudaError_t err = cudaFuncSetAttribute(segment_scatter_kernel<Kind>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, segment_scatter_kernel<Kind>, kFoldThreads, smem);
      }
      if (err != cudaSuccess) return err;
      per_sm_of[dev] = per_sm < 1 ? 1 : per_sm;
    }
    const int per_sm = per_sm_of[dev];
    const long long tile = static_cast<long long>(kFoldThreads) * kFoldRows;
    long long blocks = (n + tile - 1) / tile;
    const long long cap = static_cast<long long>(sms) * per_sm;
    if (blocks > cap) blocks = cap;
    segment_scatter_kernel<Kind><<<static_cast<int>(blocks), kFoldThreads, smem, stream>>>(
        tickets, values, acc, n, G);
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(segment_onehot_kernel<Kind>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_onehot_kernel<Kind>,
                                                      kOnehotThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long rows_per_cta =
      static_cast<long long>(G) * kOnehotRowsPerGroup > kOnehotThreads
          ? static_cast<long long>(G) * kOnehotRowsPerGroup
          : kOnehotThreads;
  long long blocks = (n + rows_per_cta - 1) / rows_per_cta;
  const long long cap = static_cast<long long>(sms) * per_sm;
  if (blocks > cap) blocks = cap;
  segment_onehot_kernel<Kind><<<static_cast<int>(blocks), kOnehotThreads, smem, stream>>>(
      tickets, values, acc, n, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one fold on `stream`.  `kind`: 0 sum, 1 count, 2 min, 3 max;
// `strategy`: 0 scatter, 1 onehot, 2 serialized.  Returns a cudaError_t as an int
// (0 = launched).  `acc` holds the accumulators the rows
// fold into (the kind's neutral for a fresh fold); the caller checks
// shapes, types and devices.
int segment_agg_launch(const void* tickets, const void* values, void* acc,
                       long long n, int G, int kind, int strategy, void* stream) {
  if (n < 0 || G < 0 || kind < kSum || kind > kMax ||
      (strategy != kScatter && strategy != kOnehot && strategy != kSerialized) ||
      (strategy == kOnehot && G > kMaxOnehotGroups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || G == 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* t = static_cast<const int*>(tickets);
  const float* v = static_cast<const float*>(values);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSum: err = launch<kSum>(strategy, t, v, a, n, G, dev, sms, s); break;
    case kCount: err = launch<kCount>(strategy, t, v, a, n, G, dev, sms, s); break;
    case kMin: err = launch<kMin>(strategy, t, v, a, n, G, dev, sms, s); break;
    default: err = launch<kMax>(strategy, t, v, a, n, G, dev, sms, s); break;
  }
  return static_cast<int>(err);
}

const char* segment_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
