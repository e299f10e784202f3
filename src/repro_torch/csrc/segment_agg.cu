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
//   scatter: a grid-stride loop over rows on enough CTAs to fill the card,
//     each row one device-scope atomic on the accumulator in device memory.
//   onehot: the TPU puts a contended small-G fold on the MXU.  Here each
//     CTA keeps a private copy of the G accumulators in dynamic shared
//     memory, folds its rows with block-scope shared-memory atomics, and
//     flushes the entries it touched once with device-scope atomics.  It
//     takes G <= kMaxOnehotGroups (224 KiB of the 227 KiB a block may use).
// Float min/max are integer atomics on the bits, split by the sign bit:
// non-negative floats order like their int bits, negative floats reversed
// as unsigned bits; correct against the ±inf neutrals and for -0.0.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSum = 0, kCount = 1, kMin = 2, kMax = 3;
constexpr int kScatter = 0, kOnehot = 1;
constexpr int kThreads = 256;
constexpr int kOnehotThreads = 512;
constexpr int kBlocksPerSm = 8;
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

template <int Kind>
__global__ void __launch_bounds__(kThreads) segment_scatter_kernel(
    const int* __restrict__ tickets, const float* __restrict__ values,
    float* __restrict__ acc, long long n, int G) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const int t = tickets[r];
    if (t < 0 || t >= G) continue;
    fold_device<Kind>(acc + t, Kind == kCount ? 1.0f : values[r]);
  }
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
                   long long n, int G, int sms, cudaStream_t stream) {
  if (strategy == kScatter) {
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
    if (blocks > cap) blocks = cap;
    segment_scatter_kernel<Kind><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
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
    case kSum: err = launch<kSum>(strategy, t, v, a, n, G, sms, s); break;
    case kCount: err = launch<kCount>(strategy, t, v, a, n, G, sms, s); break;
    case kMin: err = launch<kMin>(strategy, t, v, a, n, G, sms, s); break;
    default: err = launch<kMax>(strategy, t, v, a, n, G, sms, s); break;
  }
  return static_cast<int>(err);
}

const char* segment_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
