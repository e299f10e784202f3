// Heavy-hitter register fold for Hopper (sm_90a): the hybrid strategy's
// register path.
//
// Replaces: src/repro/engine/executors.py:884 `_hybrid_registers` (a jnp
// `lax.scan` over morsels of an (R x morsel) compare; no Pallas kernel),
// the register half of `_HybridExecutor` (strategy="hybrid").
//
// What it computes, for a chunk's n keys (int32 bit patterns), R heavy keys
// (kEmpty-padded; the live ones distinct) and S accumulator planes, each a
// kind (sum / count / min / max) over a float32 value column (count reads
// none):
//   * every row whose key is a live heavy key folds into that key's
//     register of every plane: regs[s * R + r] (+)= v, in place, where (+)
//     is +, min or max and count adds 1.0;
//   * tail[i] = kEmpty for those rows and keys[i] for every other row, so
//     the tail operator never sees a heavy row (the reference's heavy mask
//     and its `where(hmask, EMPTY, keys)`, fused into the same pass).
// A row never folds into two registers: with duplicate live heavy keys it
// takes the first (the executor passes distinct keys).
//
// Bound on this card: bytes.  The least traffic is the keys read once, the
// value columns read once and the tail keys written once, over 3.35 TB/s;
// a compare against R keys is a few operations a row.
//
// Design.  The reference computes the whole (R x morsel) compare per
// morsel.  Here each row finds its register with one probe of a small
// open-addressed table of the heavy keys in shared memory (at least 2R
// slots, so a probe ends within a few slots), built by every CTA at its
// start.  Persistent CTAs (SMs x occupancy) take tiles of kThreads x kRows
// rows, neighbouring lanes on neighbouring rows, so key loads and tail
// stores coalesce; a row that misses every register reads no value.  The
// rows of a warp that hit one register form a group (a ballot on the
// register of the lowest pending lane): count takes the group's size, the
// other kinds a butterfly of five shuffles over the warp, and the group's
// lowest lane folds the result into the WARP's own copy of the S x R
// registers in shared memory with a plain read-modify-write.  No two
// warps share a copy, so a hot key costs no shared atomic and no warp
// waits on another (a first version folded every warp into one per-CTA
// copy with shared atomics, and a hot key serialised the CTA's warps on
// one address: chip_smoke phase 4, PERF.md §6).  When the CTA ends, its
// warps' copies are combined and it makes one device atomic per register
// and plane that it touched: min / max as the sign-split integer atomics
// of hash_probe.cuh.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

using hash_probe::kEmpty;
using hash_probe::kFull;

constexpr int kSum = 0, kCount = 1, kMin = 2, kMax = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                        // rows per thread per tile
constexpr int kMaxRegisters = 256;              // R
constexpr int kMaxPlanes = 16;                  // S
constexpr int kMaxHashSlots = 2 * kMaxRegisters;
// the warps' register copies: kWarps x S x R floats of dynamic shared memory
constexpr int kMaxCopyBytes = kWarps * kMaxPlanes * kMaxRegisters * 4;

struct Planes {
  const float* values[kMaxPlanes];  // null for a count plane
  int kinds[kMaxPlanes];
};

__device__ __forceinline__ float neutral(int kind) {
  return kind == kMin ? INFINITY : (kind == kMax ? -INFINITY : 0.0f);
}

// The total order of float bit patterns that the sign-split atomics use.
__device__ __forceinline__ unsigned ordered_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float combine(int kind, float a, float b) {
  if (kind == kSum || kind == kCount) return a + b;
  const unsigned ua = ordered_bits(a), ub = ordered_bits(b);
  return (kind == kMin ? ua <= ub : ua >= ub) ? a : b;
}

// Combine v over the whole warp (lanes outside a group hold the neutral);
// every lane gets the result.
__device__ __forceinline__ float warp_reduce(int kind, float v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v = combine(kind, v, __shfl_xor_sync(kFull, v, k));
  return v;
}

// Fold x into a device-memory register.
__device__ __forceinline__ void fold_device(int kind, float* a, float x) {
  if (kind == kSum || kind == kCount) atomicAdd(a, x);
  else if (kind == kMin) hash_probe::atomic_min_f32(a, x);
  else hash_probe::atomic_max_f32(a, x);
}

// The register of `key`, or -1: a probe of the CTA's heavy-key table.
__device__ __forceinline__ int find_register(int key, const int* s_key, const int* s_idx,
                                             unsigned mask) {
  if (key == kEmpty) return -1;
  unsigned h = hash_probe::slot_hash(key, mask);
  for (;;) {
    const int k = s_key[h];
    if (k == key) return s_idx[h];
    if (k == kEmpty) return -1;
    h = (h + 1) & mask;
  }
}

__global__ void __launch_bounds__(kThreads) hybrid_registers_kernel(
    const int* __restrict__ keys, const int* __restrict__ heavy, int R, Planes planes,
    int S, float* __restrict__ regs, int* __restrict__ tail, long long n, unsigned mask) {
  extern __shared__ float s_copies[];  // (kWarps, S, R): each warp's registers
  __shared__ int s_key[kMaxHashSlots];
  __shared__ int s_idx[kMaxHashSlots];
  __shared__ const float* s_values[kMaxPlanes];
  __shared__ int s_kinds[kMaxPlanes];
  const int SR = S * R;
  if (threadIdx.x < S) {
    s_values[threadIdx.x] = planes.values[threadIdx.x];
    s_kinds[threadIdx.x] = planes.kinds[threadIdx.x];
  }
  for (int h = threadIdx.x; h <= static_cast<int>(mask); h += kThreads) {
    s_key[h] = kEmpty;
    s_idx[h] = kMaxRegisters;
  }
  for (int i = threadIdx.x; i < kWarps * SR; i += kThreads) {
    s_copies[i] = neutral(planes.kinds[(i % SR) / R]);
  }
  __syncthreads();
  // insert the live heavy keys; a repeated key keeps its lowest register
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int k = heavy[r];
    if (k == kEmpty) continue;
    unsigned h = hash_probe::slot_hash(k, mask);
    for (;;) {
      const int prev = atomicCAS_block(s_key + h, kEmpty, k);
      if (prev == kEmpty || prev == k) {
        atomicMin_block(s_idx + h, r);
        break;
      }
      h = (h + 1) & mask;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float* copy = s_copies + (threadIdx.x >> 5) * SR;
  const long long tile = static_cast<long long>(kThreads) * kRows;
  for (long long base = blockIdx.x * tile; base < n; base += gridDim.x * tile) {
    int reg[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long row = base + j * kThreads + threadIdx.x;
      const int key = row < n ? keys[row] : kEmpty;
      reg[j] = find_register(key, s_key, s_idx, mask);
      if (row < n) tail[row] = reg[j] >= 0 ? kEmpty : key;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long row = base + j * kThreads + threadIdx.x;
      unsigned pending = __ballot_sync(kFull, reg[j] >= 0);
      while (pending) {
        const int lead = __ffs(pending) - 1;
        const int r = __shfl_sync(kFull, reg[j], lead);
        const unsigned group = __ballot_sync(kFull, reg[j] == r);
        const bool in = (group >> lane) & 1u;
        for (int s = 0; s < S; ++s) {
          const int kind = s_kinds[s];
          float x;
          if (kind == kCount) {
            x = static_cast<float>(__popc(group));
          } else {
            x = warp_reduce(kind, in ? s_values[s][row] : neutral(kind));
          }
          if (lane == lead) copy[s * R + r] = combine(kind, copy[s * R + r], x);
        }
        __syncwarp();  // the next lead of this register sees the write
        pending &= ~group;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SR; i += kThreads) {
    const int kind = s_kinds[i / R];
    float x = neutral(kind);
    for (int w = 0; w < kWarps; ++w) x = combine(kind, x, s_copies[w * SR + i]);
    if (x != neutral(kind)) fold_device(kind, regs + i, x);
  }
}

}  // namespace

extern "C" {

// Fold one chunk into the registers and write its tail keys, on `stream`.
// `planes` and `kinds` are host arrays of S entries (a value column's
// device pointer, null for count; 0 sum, 1 count, 2 min, 3 max); `regs` is
// (S, R) float32, folded in place.  1 <= R <= 256, 1 <= S <= 16.  Returns
// a cudaError_t as an int (0 = launched); the caller checks shapes, types
// and devices.
int hybrid_registers_launch(const void* keys, const void* heavy, int R,
                            const void* const* planes, const int* kinds, int S, void* regs,
                            void* tail, long long n, void* stream) {
  if (n < 0 || R < 1 || R > kMaxRegisters || S < 1 || S > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes p{};
  for (int s = 0; s < S; ++s) {
    if (kinds[s] < kSum || kinds[s] > kMax || (kinds[s] != kCount && planes[s] == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.values[s] = static_cast<const float*>(planes[s]);
    p.kinds[s] = kinds[s];
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kWarps) * S * R * sizeof(float);
  // the SM count and the shared-memory opt-in once per device; the
  // occupancy for the last copy size
  static int sms_of[64], per_sm_of[64];
  static size_t smem_of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= 64) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && sms_of[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(hybrid_registers_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxCopyBytes);
    }
    if (err == cudaSuccess) sms_of[dev] = sms;
  }
  if (err == cudaSuccess && (per_sm_of[dev] == 0 || smem_of[dev] != smem)) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hybrid_registers_kernel,
                                                        kThreads, smem);
    if (err == cudaSuccess) {
      per_sm_of[dev] = per_sm < 1 ? 1 : per_sm;
      smem_of[dev] = smem;
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned slots = 16;
  while (slots < 2u * static_cast<unsigned>(R)) slots <<= 1;
  const long long tile = static_cast<long long>(kThreads) * kRows;
  long long blocks = (n + tile - 1) / tile;
  const long long cap = static_cast<long long>(sms_of[dev]) * per_sm_of[dev];
  if (blocks > cap) blocks = cap;
  hybrid_registers_kernel<<<static_cast<int>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(heavy), R, p, S,
      static_cast<float*>(regs), static_cast<int*>(tail), n, slots - 1);
  return static_cast<int>(cudaGetLastError());
}

const char* hybrid_registers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
