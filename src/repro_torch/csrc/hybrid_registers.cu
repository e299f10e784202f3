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
//   * every row whose key is a live heavy key folds into that key's register
//     of every plane: regs[s * R + r] (+)= v, in place, where (+) is +, min
//     or max and count adds 1.0;
//   * tail[i] = kEmpty for those rows and keys[i] for every other row, so
//     the tail operator never sees a heavy row (the reference's heavy mask
//     and its `where(hmask, EMPTY, keys)`, fused into the same pass).
// A row never folds into two registers: with duplicate live heavy keys it
// takes the first (the executor passes distinct keys).
//
// Bound on this card: bytes.  The least traffic is the keys read once, the
// value columns read once for the rows that hit a register and the tail
// keys written once, over 3.35 TB/s; a compare against R keys is a few
// operations a row.
//
// Design.  Persistent CTAs of kThreads threads walk the chunk in tiles of
// a few 16-byte key vectors a thread (neighbouring threads on neighbouring
// vectors, so key loads and tail stores coalesce; 4-byte rows where a
// pointer is not 16-byte aligned and past the last whole vector).  A row
// that misses every register reads no value.  Two kernels, chosen by size:
//   * per-thread copies (R <= kCompareKeys = 8 and S x R <= kMaxThreadCopies
//     = 64, the main path's R = 8, S = 4 among them): every thread owns a
//     copy of the S x R registers in shared memory, laid out [s][r][thread]
//     so that the lanes of a warp hit distinct banks, and a hit row costs S
//     private read-modify-writes: no shuffle, no vote, no atomic.  The values
//     of a vector's hit rows are read together, a plane at a time.  A row
//     finds its register by comparing its key with the heavy keys held in
//     registers.  64 copies are 64 KiB at 256 threads; kThreadCtasPerSm = 2
//     CTAs an SM of 4 key vectors a thread keep as many loads in flight as 4
//     CTAs of 2, with half the CTAs to set up and flush.  When a CTA ends,
//     each warp combines the copies of the registers that a thread of the
//     CTA touched, and one device atomic per touched register and plane is
//     made, each by a thread of its own.
//   * per-warp copies (every other size: R = 64 or 256 at S = 4, S = 16 at
//     R = 8): each warp owns one copy, and a row finds its register by
//     probing a small open-addressed table of the heavy keys in shared
//     memory.  Per row step, each lane reads its row's value once a plane;
//     the rows that hit one register form a group (a ballot on the register
//     of the lowest pending lane): count takes the group's size, the other
//     kinds a butterfly of five shuffles, and the group's lowest lane folds
//     the result into the warp's copy with a plain read-modify-write.  When
//     the CTA ends, its warps' copies are combined and flushed with one
//     atomic per touched register.
// Min / max atomics are the sign-split integer atomics of hash_probe.cuh.
// Why not one path for every size: folding per warp costs a row tens of
// dependent shuffles when a warp step meets several registers (the zipf
// class: about six), while per-thread copies past 64 registers cut the CTAs
// an SM.  The per-thread copies are kept to the sizes whose heavy keys fit
// the registers' compare (R <= 8), so that kernel probes no table.
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
constexpr int kVec = 4;                         // rows of one 16-byte key vector
constexpr int kThreadSteps = 4;                 // key vectors in flight: per-thread copies
constexpr int kWarpSteps = 2;                   // per-warp copies
constexpr int kMaxRegisters = 256;              // R
constexpr int kMaxPlanes = 16;                  // S
constexpr int kMaxHashSlots = 2 * kMaxRegisters;
constexpr int kMaxThreadCopies = 64;            // S x R of the per-thread-copy kernel
constexpr int kCompareKeys = 8;                 // R compared in registers
constexpr int kThreadCtasPerSm = 2;             // the per-thread-copy kernel's CTAs an SM
// the per-warp copies: kWarps x S x R floats of dynamic shared memory
constexpr int kMaxWarpCopyBytes = kWarps * kMaxPlanes * kMaxRegisters * 4;
constexpr int kMaxThreadCopyBytes = kMaxThreadCopies * kThreads * 4;

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

// The CTA's table of the live heavy keys: key and lowest register per slot.
// Every thread calls it; a __syncthreads follows.
__device__ __forceinline__ void build_table(const int* heavy, int R, unsigned mask, int* s_key,
                                            int* s_idx) {
  for (int h = threadIdx.x; h <= static_cast<int>(mask); h += kThreads) {
    s_key[h] = kEmpty;
    s_idx[h] = kMaxRegisters;
  }
  __syncthreads();
  // a repeated key keeps its lowest register
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
}

// The register of `key`, or -1: a probe of the CTA's heavy-key table.
__device__ __forceinline__ int probe_register(int key, const int* s_key, const int* s_idx,
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

// The row loop of both kernels.  CTA-uniform tiles of kThreads x kSteps
// key vectors (a thread's kSteps loads issued together), then the rows past
// the last whole vector (every row when `vec` is false) one a thread, so
// every lane of a warp runs every iteration: `find(key)` gives a row's
// register (-1: none; a row past n holds kEmpty), `fold(reg, row0)` folds
// the registers `reg` of rows row0, row0 + 1, ... (every lane calls it,
// with reg < 0 for a row that folds nothing), and the tail keys are stored.
template <int kSteps, class Find, class Fold>
__device__ __forceinline__ void for_each_row(const int* __restrict__ keys, int* __restrict__ tail,
                                             long long n, bool vec, Find find, Fold fold) {
  const long long nv = vec ? n / kVec : 0;
  const long long tile = static_cast<long long>(kThreads) * kSteps;
  const int4* kv = reinterpret_cast<const int4*>(keys);
  int4* tv = reinterpret_cast<int4*>(tail);
  for (long long base = blockIdx.x * tile; base < nv; base += gridDim.x * tile) {
    int4 k[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const long long j = base + u * kThreads + threadIdx.x;
      k[u] = j < nv ? __ldg(kv + j) : make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const long long j = base + u * kThreads + threadIdx.x;
      const int r[kVec] = {find(k[u].x), find(k[u].y), find(k[u].z), find(k[u].w)};
      fold(r, kVec * j);
      if (j < nv) {
        tv[j] = make_int4(r[0] >= 0 ? kEmpty : k[u].x, r[1] >= 0 ? kEmpty : k[u].y,
                          r[2] >= 0 ? kEmpty : k[u].z, r[3] >= 0 ? kEmpty : k[u].w);
      }
    }
  }
  for (long long base = nv * kVec + blockIdx.x * kThreads; base < n;
       base += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = base + threadIdx.x;
    const int key = row < n ? keys[row] : kEmpty;
    const int r[1] = {find(key)};
    fold(r, row);
    if (row < n) tail[row] = r[0] >= 0 ? kEmpty : key;
  }
}

// Combine kThreads per-thread copies of one register (`col`, consecutive)
// with the warp; every lane gets the result.
template <int Kind>
__device__ __forceinline__ float combine_copies(const float* col, int lane) {
  float x = neutral(Kind);
#pragma unroll
  for (int t = lane; t < kThreads; t += 32) x = combine(Kind, x, col[t]);
  return warp_reduce(Kind, x);
}

// Per-thread copies: R <= kCompareKeys and S x R <= kMaxThreadCopies.
__global__ void __launch_bounds__(kThreads) hybrid_thread_copies_kernel(
    const int* __restrict__ keys, const int* __restrict__ heavy, int R, Planes planes,
    int S, float* __restrict__ regs, int* __restrict__ tail, long long n, bool vec) {
  extern __shared__ float s_copies[];  // (S, R, kThreads): each thread's registers
  __shared__ unsigned s_touched;       // the registers any thread folded into
  __shared__ float s_part[kMaxThreadCopies];  // the CTA's combined registers
  if (threadIdx.x == 0) s_touched = 0;
  for (int s = 0; s < S; ++s) {
    const float z = neutral(planes.kinds[s]);
    for (int r = 0; r < R; ++r) s_copies[(s * R + r) * kThreads + threadIdx.x] = z;
  }
  int hk[kCompareKeys];
#pragma unroll
  for (int r = 0; r < kCompareKeys; ++r) hk[r] = r < R ? __ldg(heavy + r) : kEmpty;
  __syncthreads();
  auto find = [&](int key) {
    int reg = -1;
#pragma unroll
    for (int r = kCompareKeys - 1; r >= 0; --r) {
      if (hk[r] == key) reg = r;  // the lowest register holding the key
    }
    return key == kEmpty ? -1 : reg;
  };
  unsigned touched = 0;  // bit r: this thread folded into register r
  auto fold = [&](const auto& reg, long long row0) {
    constexpr int N = sizeof(reg) / sizeof(reg[0]);
    bool any = false;
#pragma unroll
    for (int c = 0; c < N; ++c) any |= reg[c] >= 0;
    if (!any) return;
#pragma unroll
    for (int s = 0; s < kMaxPlanes; ++s) {
      if (s >= S) break;
      const int kind = planes.kinds[s];
      // the plane's values of the rows that hit, loaded together
      float x[N];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        x[c] = kind == kCount ? 1.0f
                              : (reg[c] >= 0 ? __ldg(planes.values[s] + row0 + c) : 0.0f);
      }
#pragma unroll
      for (int c = 0; c < N; ++c) {
        if (reg[c] < 0) continue;
        float* p = s_copies + (s * R + reg[c]) * kThreads + threadIdx.x;
        *p = combine(kind, *p, x[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < N; ++c) touched |= reg[c] >= 0 ? 1u << reg[c] : 0u;
  };
  for_each_row<kThreadSteps>(keys, tail, n, vec, find, fold);
  // the CTA's touched registers; warp w combines the copies of registers
  // w, w + kWarps, ... of every plane into s_part (the neutral where no
  // thread of the CTA touched one)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  touched = __reduce_or_sync(kFull, touched);
  if (lane == 0 && touched != 0) atomicOr_block(&s_touched, touched);
  __syncthreads();
  const unsigned cta = s_touched;
  for (int r = warp; r < R; r += kWarps) {
    const bool hit = (cta >> r) & 1u;
    for (int s = 0; s < S; ++s) {
      const int i = s * R + r;
      const int kind = planes.kinds[s];
      float x = neutral(kind);
      if (hit) {
        const float* col = s_copies + i * kThreads;
        x = kind == kMin ? combine_copies<kMin>(col, lane)
                         : (kind == kMax ? combine_copies<kMax>(col, lane)
                                         : combine_copies<kSum>(col, lane));
      }
      if (lane == 0) s_part[i] = x;
    }
  }
  __syncthreads();
  // one device atomic per register and plane that the CTA touched, each
  // from a thread of its own
  for (int i = threadIdx.x; i < S * R; i += kThreads) {
    const int kind = planes.kinds[i / R];
    if (s_part[i] != neutral(kind)) fold_device(kind, regs + i, s_part[i]);
  }
}

// Per-warp copies: R past kCompareKeys or S x R past kMaxThreadCopies.
__global__ void __launch_bounds__(kThreads) hybrid_warp_copies_kernel(
    const int* __restrict__ keys, const int* __restrict__ heavy, int R, Planes planes,
    int S, float* __restrict__ regs, int* __restrict__ tail, long long n, unsigned mask,
    bool vec) {
  extern __shared__ float s_copies[];  // (kWarps, S, R): each warp's registers
  __shared__ int s_key[kMaxHashSlots];
  __shared__ int s_idx[kMaxHashSlots];
  const int SR = S * R;
  for (int i = threadIdx.x; i < kWarps * SR; i += kThreads) {
    s_copies[i] = neutral(planes.kinds[(i % SR) / R]);
  }
  build_table(heavy, R, mask, s_key, s_idx);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float* copy = s_copies + (threadIdx.x >> 5) * SR;
  auto find = [&](int key) { return probe_register(key, s_key, s_idx, mask); };
  auto fold = [&](const auto& reg, long long row0) {
    constexpr int N = sizeof(reg) / sizeof(reg[0]);
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const unsigned hits = __ballot_sync(kFull, reg[c] >= 0);
      if (hits == 0) continue;
      for (int s = 0; s < S; ++s) {
        const int kind = planes.kinds[s];
        // each lane's value read once a plane, then combined per group
        const float v = kind == kCount || reg[c] < 0 ? neutral(kind)
                                                     : __ldg(planes.values[s] + row0 + c);
        for (unsigned pending = hits; pending != 0;) {
          const int lead = __ffs(pending) - 1;
          const int r = __shfl_sync(kFull, reg[c], lead);
          const unsigned group = __ballot_sync(kFull, reg[c] == r);
          const bool in = (group >> lane) & 1u;
          const float x = kind == kCount ? static_cast<float>(__popc(group))
                                         : warp_reduce(kind, in ? v : neutral(kind));
          if (lane == lead) copy[s * R + r] = combine(kind, copy[s * R + r], x);
          pending &= ~group;
        }
      }
      __syncwarp();  // the next row step's leads see this one's writes
    }
  };
  for_each_row<kWarpSteps>(keys, tail, n, vec, find, fold);
  __syncthreads();
  for (int i = threadIdx.x; i < SR; i += kThreads) {
    const int kind = planes.kinds[i / R];
    float x = neutral(kind);
    for (int w = 0; w < kWarps; ++w) x = combine(kind, x, s_copies[w * SR + i]);
    if (x != neutral(kind)) fold_device(kind, regs + i, x);
  }
}

// Once per device and kernel: the SM count and the shared-memory opt-in;
// then the CTAs an SM: `per_sm`, or the occupancy for the last copy size
// when it is 0.
struct LaunchCache {
  int sms = 0, per_sm = 0;
  size_t smem = ~size_t{0};
};

template <class Kernel>
cudaError_t grid_of(Kernel kernel, LaunchCache& c, int dev, int max_smem, size_t smem,
                    int per_sm, int* ctas) {
  cudaError_t err = cudaSuccess;
  if (c.sms == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    }
    if (err != cudaSuccess) return err;
    c.sms = sms;
  }
  if (per_sm == 0 && c.smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    c.per_sm = per_sm < 1 ? 1 : per_sm;
    c.smem = smem;
  }
  *ctas = c.sms * (per_sm > 0 ? per_sm : c.per_sm);
  return cudaSuccess;
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
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= 64) err = cudaErrorInvalidDevice;
  if (err != cudaSuccess) return static_cast<int>(err);
  static LaunchCache thread_of[64], warp_of[64];
  const bool thread_copies = R <= kCompareKeys && S * R <= kMaxThreadCopies;
  unsigned slots = 16;
  while (slots < 2u * static_cast<unsigned>(R)) slots <<= 1;
  const bool vec = ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(tail)) &
                    15u) == 0;
  int cap = 0;
  size_t smem;
  if (thread_copies) {
    smem = static_cast<size_t>(S) * R * kThreads * sizeof(float);
    // kThreadCtasPerSm CTAs of at most 65 KiB fit an SM
    err = grid_of(hybrid_thread_copies_kernel, thread_of[dev], dev, kMaxThreadCopyBytes, smem,
                  kThreadCtasPerSm, &cap);
  } else {
    smem = static_cast<size_t>(kWarps) * S * R * sizeof(float);
    err = grid_of(hybrid_warp_copies_kernel, warp_of[dev], dev, kMaxWarpCopyBytes, smem, 0,
                  &cap);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tile =
      static_cast<long long>(kThreads) * (thread_copies ? kThreadSteps : kWarpSteps) * kVec;
  long long blocks = (n + tile - 1) / tile;
  if (blocks > cap) blocks = cap;
  const int* k = static_cast<const int*>(keys);
  const int* h = static_cast<const int*>(heavy);
  float* rg = static_cast<float*>(regs);
  int* t = static_cast<int*>(tail);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(blocks);
  if (!thread_copies) {
    hybrid_warp_copies_kernel<<<g, kThreads, smem, st>>>(k, h, R, p, S, rg, t, n, slots - 1, vec);
  } else {
    hybrid_thread_copies_kernel<<<g, kThreads, smem, st>>>(k, h, R, p, S, rg, t, n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hybrid_registers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
