// Grouped matmul (kernel B3) for Hopper (sm_90a): the expert FFNs of a
// MoE layer over expert-sorted rows.
//
// Replaces: src/repro/models/moe.py:109-112, `jax.lax.ragged_dot` in
// `moe_mlp_dense` (no Pallas kernel: XLA's grouped matmul on the TPU).
//
// What it computes: ragged_dot's function.  lhs (M, K), rhs (G, K, N) and
// group_sizes (G,) int32; the groups are contiguous runs of rows in group
// order, so out[r] = lhs[r] @ rhs[g] for the rows r of group g, and rows
// past the sum of group_sizes are written as zeros.  Float32 in and out,
// float32 FMAs on the CUDA cores (the reference casts both sides to
// float32).  A group's first row is the prefix sum of the sizes before it,
// taken on the device by each CTA: no size is read on the host.  Negative
// sizes count as 0 and rows are clamped to M.
//
// Bound on this card: bytes.  At decode the rows are few (8 slots × top-8
// = 64 rows over 32 experts for granite-moe-1b-a400m), so the call reads
// every expert it touches whole: 1024 × 512 × 4 B = 2 MiB an expert, 64
// MiB over all 32, ≈ 0.020 ms at 3.35 TB/s, while the 2·M·K·N operations
// take ≈ 0.001 ms at the 67 TFLOP/s float32 rate.  The least traffic is
// lhs and out once plus each non-empty group's K × N weights once.
//
// Design: a CTA owns one (group, N tile) and loops over that group's rows
// in tiles of kRows, so each weight element is read from device memory once
// a call while a group's rows fit one row tile (at decode a group holds at
// most one row per token, so 8 slots give at most 8 rows).  The N tile is
// 32 lanes × VEC columns (16-byte loads where N % 4 == 0 and the pointers
// are aligned); the K dimension is split over the CTA's 8 warps, each
// streaming its rows of the weight block, and the warps' partial sums are
// added through shared memory.  The row tile's lhs values are staged in
// shared memory, kChunk columns of K at a time, and read as broadcasts.
// Empty groups' CTAs return at once: they launch no work.  One extra row of
// CTAs (blockIdx.y == G) writes the zero rows past the last group.
// wgmma, TMA and bf16 weights are later work (ROADMAP B3 redesign).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // K slices, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                // row tile
constexpr int kChunk = 256;             // K columns of the row tile in shared memory

template <int VEC>
__device__ __forceinline__ void load_w(const float* p, float (&w)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    w[0] = __ldg(p);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
                      const int* __restrict__ sizes, float* __restrict__ out,
                      long long M, int K, int N, int G) {
  constexpr int TN = 32 * VEC;
  __shared__ long long s_range[2];
  __shared__ __align__(16) float s_lhs[kChunk][kRows];   // 8 KiB, k-major
  __shared__ float s_part[kWarps][kRows][TN];            // 32 KiB at VEC = 4

  const int g = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  if (threadIdx.x == 0) {
    long long start = 0, total = 0;
    for (int j = 0; j < G; ++j) {
      const long long s = max(sizes[j], 0);
      start += j < g ? s : 0;
      total += s;
    }
    if (g < G) {
      s_range[0] = min(start, M);
      s_range[1] = min(start + max(sizes[g], 0), M);
    } else {
      s_range[0] = min(total, M);
      s_range[1] = M;
    }
  }
  __syncthreads();
  const long long lo = s_range[0], hi = s_range[1];
  if (lo >= hi) return;  // an empty group

  if (g == G) {  // the rows past Σ group_sizes
    for (long long i = threadIdx.x; i < (hi - lo) * TN; i += kThreads) {
      const int c = n0 + static_cast<int>(i % TN);
      if (c < N) out[(lo + i / TN) * N + c] = 0.f;
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = n0 + lane * VEC;
  const bool live = col < N;  // VEC = 4 only when N % 4 == 0
  const float* w_g = rhs + static_cast<size_t>(g) * K * N;

  for (long long r0 = lo; r0 < hi; r0 += kRows) {
    const int nr = static_cast<int>(min(static_cast<long long>(kRows), hi - r0));
    float acc[kRows][VEC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      __syncthreads();  // the previous chunk's (and row tile's) readers are done
      for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
        const int r = i / kChunk, kk = i % kChunk;
        s_lhs[kk][r] = (r < nr && kk < kc) ? lhs[(r0 + r) * K + k0 + kk] : 0.f;
      }
      __syncthreads();
      if (live) {
#pragma unroll 4
        for (int kk = warp; kk < kc; kk += kWarps) {
          float w[VEC];
          load_w<VEC>(w_g + static_cast<size_t>(k0 + kk) * N + col, w);
          const float4 a0 = *reinterpret_cast<const float4*>(&s_lhs[kk][0]);
          const float4 a1 = *reinterpret_cast<const float4*>(&s_lhs[kk][4]);
          const float a[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(a[r], w[v], acc[r][v]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) s_part[warp][r][lane * VEC + v] = acc[r][v];
    __syncthreads();
    for (int i = threadIdx.x; i < nr * TN; i += kThreads) {
      const int r = i / TN, c = i % TN;
      if (n0 + c < N) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_part[w][r][c];
        out[(r0 + r) * N + n0 + c] = s;
      }
    }
  }
}

template <int VEC>
cudaError_t launch(const float* lhs, const float* rhs, const int* sizes, float* out,
                   long long M, int K, int N, int G, cudaStream_t stream) {
  constexpr int TN = 32 * VEC;
  const dim3 grid((N + TN - 1) / TN, G + 1);
  grouped_matmul_kernel<VEC><<<grid, kThreads, 0, stream>>>(lhs, rhs, sizes, out, M, K, N, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one grouped matmul on `stream`: lhs (M, K), rhs (G, K, N), sizes
// (G,) int32 and out (M, N), all contiguous, float32 but `sizes`, on the
// current device.  Every element of `out` is written.  Returns a
// cudaError_t as an int (0 = launched); the caller checks shapes, types
// and devices.
int grouped_matmul_launch(const void* lhs, const void* rhs, const void* sizes, void* out,
                          long long M, int K, int N, int G, void* stream) {
  if (M < 0 || K < 1 || N < 0 || G < 0 || G >= 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const float* a = static_cast<const float*>(lhs);
  const float* b = static_cast<const float*>(rhs);
  const int* s = static_cast<const int*>(sizes);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const cudaError_t err = vec4 ? launch<4>(a, b, s, o, M, K, N, G, st)
                               : launch<1>(a, b, s, o, M, K, N, G, st);
  return static_cast<int>(err);
}

const char* grouped_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
