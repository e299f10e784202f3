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
// Float min/max are integer atomics on the bits, split by the sign bit:
// non-negative floats order like their int bits, negative floats reversed
// as unsigned bits; correct against the ±inf neutrals and for -0.0.  The
// warp step compares in the same total order of bit patterns.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSum = 0, kCount = 1, kMin = 2, kMax = 3;
constexpr int kScatter = 0, kOnehot = 1;
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
cudaError_t launch(int strategy, const int* tickets, const float* values, float* acc,
                   long long n, int G, int dev, int sms, cudaStream_t stream) {
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
// `strategy`: 0 scatter, 1 onehot.  Returns a cudaError_t as an int
// (0 = launched).  The caller fills `acc` with the neutral and checks
// shapes, types and devices.
int segment_agg_launch(const void* tickets, const void* values, void* acc,
                       long long n, int G, int kind, int strategy, void* stream) {
  if (n < 0 || G < 0 || kind < kSum || kind > kMax ||
      (strategy != kScatter && strategy != kOnehot) ||
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
