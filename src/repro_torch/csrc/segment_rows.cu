// Row segment sum (kernel B5) for Hopper (sm_90a): add whole float32 rows
// into the rows of a dense (G, d) accumulator named by their tickets.
//
// Replaces: src/repro/models/layers.py:150-154, `jax.ops.segment_sum` in
// `_ticketed_embed_bwd` (no Pallas kernel there: XLA's scatter-add on the
// TPU).  It is step 2 of the embedding gradient's GROUP BY token_id
// SUM(cotangent): the ticket kernel has numbered the token ids, this sums
// the cotangent rows in ticket space, and one index_add_ lands the sums in
// the (vocab, d) table.
//
// What it computes: out[t] += rows[r] for every row r whose ticket
// t = tickets[r] lies in [0, G); rows with t < 0 or t >= G are dropped (the
// reference sends them to a segment it drops).  rows (R, d) float32,
// tickets (R,) int32, out (G, d) float32, zeroed by the wrapper.  Float
// sums land in atomic order, so the result agrees with an ordered sum to
// float32 rounding, not bit for bit.
//
// Why one kernel: the segment kernel (segment_agg.cu) folds one (G,) plane
// a launch, so d = 1024 columns would take 1024 launches a training step.
//
// Bound on this card: bytes.  The least traffic is the rows and tickets
// read once and the G × d sums written once: at R = 1024, d = 1024 and
// G = 1024 (qwen3-0.6b, 8 × 128 tokens) 8 MiB, ≈ 0.0025 ms at 3.35 TB/s,
// so the launch itself (a few microseconds) rules.
//
// Design: a warp per row (a grid-stride loop over rows), its 32 lanes
// striding over the row's columns.  Where d % 4 == 0 and the pointers are
// 16-byte aligned (the wrapper decides), each lane loads 16 B and adds
// them with one float4 atomicAdd, which sm_90 has for device memory; else
// one float atomic a column.  A ticket outside [0, G) skips its row before
// any load.  Heavy hitters: rows of one ticket add into the same d floats,
// so a token holding a share s of the rows serializes about s·R atomics on
// each of its columns in the L2; at Zipf a = 1.2 token 0 holds ≈ 18% of
// the rows (≈ 184 of 1024), and the chip_smoke timing shows what that
// costs against the bound.  Folding a hot ticket's rows in shared memory
// first is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void add4(float4* dst, float4 v) {
#if __CUDA_ARCH__ >= 900
  atomicAdd(dst, v);  // one 16-byte reduction in the L2
#else
  float* d = reinterpret_cast<float*>(dst);
  atomicAdd(d, v.x);
  atomicAdd(d + 1, v.y);
  atomicAdd(d + 2, v.z);
  atomicAdd(d + 3, v.w);
#endif
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
segment_rows_kernel(const float* __restrict__ rows, const int* __restrict__ tickets,
                    float* __restrict__ out, long long R, int d, int G) {
  const int lane = threadIdx.x & 31;
  const long long first = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long stride = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long r = first; r < R; r += stride) {
    const int t = __ldg(tickets + r);
    if (t < 0 || t >= G) continue;  // the same for every lane of the warp
    const float* src = rows + r * d;
    float* dst = out + static_cast<long long>(t) * d;
    if constexpr (VEC) {
      const int d4 = d >> 2;
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4p = reinterpret_cast<float4*>(dst);
      for (int c = lane; c < d4; c += 32) add4(d4p + c, __ldg(s4 + c));
    } else {
      for (int c = lane; c < d; c += 32) atomicAdd(dst + c, __ldg(src + c));
    }
  }
}

}  // namespace

extern "C" {

// Launch one row segment sum on `stream`: out[tickets[r]] += rows[r] for
// the rows whose ticket lies in [0, G).  `vec` != 0 takes the 16-byte path
// (the caller guarantees d % 4 == 0 and 16-byte aligned rows and out).
// Returns a cudaError_t as an int (0 = launched); the caller checks shapes,
// types and devices and zeroes `out`.
int segment_rows_launch(const void* rows, const void* tickets, void* out, long long R,
                        int d, int G, int vec, void* stream) {
  if (R < 0 || d < 0 || G < 0 || (vec && d % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0 || d == 0 || G == 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (R + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * 16;
  const int grid = static_cast<int>(want < cap ? want : cap);
  const float* r = static_cast<const float*>(rows);
  const int* t = static_cast<const int*>(tickets);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    segment_rows_kernel<true><<<grid, kThreads, 0, s>>>(r, t, o, R, d, G);
  } else {
    segment_rows_kernel<false><<<grid, kThreads, 0, s>>>(r, t, o, R, d, G);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* segment_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
