// Local pre-aggregation kernel for Hopper (sm_90a): the first stage of the
// partitioned baseline (strategy="partitioned", Leis et al.).
//
// Replaces: src/repro/core/partitioned.py:48 `preagg_morsel` under
// `_partitioned_impl` (:138): a jnp loop (vmap over workers, lax.scan over
// morsels), no Pallas kernel.
//
// What it computes.  W workers; worker w owns rows [w*R, (w+1)*R) of the
// chunk (keys as int32 bit patterns, kEmpty = -1 for a masked row, and one
// float32 value a row) and takes them morsel by morsel, msize rows each.
// Each worker has a direct-mapped table of C slots (keys, vals, cnts) that
// persists across its morsels.  Per morsel, as the reference's two claim
// rounds resolve:
//   * every live row whose slot slot_hash(key, C) holds kEmpty votes for it
//     with its lane (its row index in the morsel); the lowest lane wins and
//     writes its key;
//   * every live row whose slot now holds its own key folds into it: vals
//     (+)= v, where (+) is +, min or max and count adds 1.0, and cnts +=
//     1.0;
//   * every other live row spills: spill[row] = 1.  Masked rows neither
//     claim nor spill.
// So the table keys, the spill mask and cnts equal the reference's bit for
// bit; only the order of the float sums differs.
//
// Bound on this card: bytes.  The least traffic is the keys and values read
// once (8 B a row), the spill mask written once (1 B a row) and the W*C*12
// bytes of tables written once, over 3.35 TB/s.
//
// Design.  One CTA per worker (kThreads threads).  The table and a claim
// array (16*C bytes) live in dynamic shared memory when they fit the
// opt-in (C <= 8192); past that, the same passes run on the worker's
// region of the output tables and of a global claim buffer that the
// wrapper allocates.  Each morsel runs in three passes over its rows, a
// barrier after each:
//   A. rows whose slot holds kEmpty: atomicMin_block(claim[slot], lane);
//   B. the row whose lane is in claim[slot] writes its key;
//   C. rows whose slot holds their key fold (below), the winners reset
//      claim[slot], and the other live rows set their spill flag.
// In pass C the lanes of a warp that fold into one slot are grouped by
// __match_any_sync and combined by a shuffle tree first, so a hot key costs
// one shared atomic per warp and not 32.  Min and max are the sign-split
// integer atomics of segment_agg.cu.  Keys are read once in each pass
// (the worker's rows stay in L2 between passes), values only in pass C.
//
// Known limit: one worker is one CTA, so at the reference's default of 8
// workers the kernel runs on 8 of the card's 132 SMs.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

using hash_probe::kEmpty;
using hash_probe::kFull;
using hash_probe::slot_hash;  // xxhash32, seed 0: repro.core.hashing.slot_hash

constexpr int kSum = 0, kCount = 1, kMin = 2, kMax = 3;
constexpr int kThreads = 1024;
constexpr int kRows = 4;  // rows a thread takes per step of a pass

template <int Kind>
__device__ __forceinline__ float neutral() {
  return Kind == kMin ? INFINITY : (Kind == kMax ? -INFINITY : 0.0f);
}

// The total order of float bit patterns that the sign-split atomics use.
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

// Block-scope fold into shared or global memory (generic address).
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

// Combine v over each group of lanes that share a slot (`peers`, this
// lane's group from __match_any_sync); the group's lowest lane gets the
// result.  At step k a lane whose rank is a multiple of 2k takes the value
// of the lane k ranks above it.  Every lane of the warp calls it.
template <int Kind>
__device__ __forceinline__ float warp_fold(unsigned peers, float v, int lane) {
  const unsigned above = peers & ~((2u << lane) - 1u);
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

template <int Kind>
__global__ void __launch_bounds__(kThreads) preagg_kernel(
    const int* __restrict__ keys, const float* __restrict__ values, long long R, int msize,
    int C, int* __restrict__ out_keys, float* __restrict__ out_vals,
    float* __restrict__ out_cnts, int* __restrict__ claim_global,
    unsigned char* __restrict__ spill) {
  extern __shared__ int smem[];
  const long long w = blockIdx.x;
  const bool in_smem = claim_global == nullptr;
  int* tkeys = in_smem ? smem : out_keys + w * C;
  float* tvals = in_smem ? reinterpret_cast<float*>(smem + C) : out_vals + w * C;
  float* tcnts = in_smem ? reinterpret_cast<float*>(smem + 2 * C) : out_cnts + w * C;
  int* claim = in_smem ? smem + 3 * C : claim_global + w * C;
  for (int s = threadIdx.x; s < C; s += kThreads) {
    tkeys[s] = kEmpty;
    tvals[s] = neutral<Kind>();
    tcnts[s] = 0.0f;
    claim[s] = INT_MAX;
  }
  __syncthreads();
  const unsigned mask = static_cast<unsigned>(C - 1);
  const int lane = threadIdx.x & 31;
  const int* wkeys = keys + w * R;
  const float* wvals = values + w * R;
  unsigned char* wspill = spill + w * R;
  const int step = kThreads * kRows;
  for (long long m0 = 0; m0 < R; m0 += msize) {
    // A: vote for empty slots
    for (int base = 0; base < msize; base += step) {
      int key[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int i = base + j * kThreads + static_cast<int>(threadIdx.x);
        key[j] = i < msize ? wkeys[m0 + i] : kEmpty;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (key[j] == kEmpty) continue;
        const unsigned s = slot_hash(key[j], mask);
        if (tkeys[s] == kEmpty) {
          atomicMin_block(claim + s, base + j * kThreads + static_cast<int>(threadIdx.x));
        }
      }
    }
    __syncthreads();
    // B: the winners install their keys
    for (int base = 0; base < msize; base += step) {
      int key[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int i = base + j * kThreads + static_cast<int>(threadIdx.x);
        key[j] = i < msize ? wkeys[m0 + i] : kEmpty;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (key[j] == kEmpty) continue;
        const unsigned s = slot_hash(key[j], mask);
        if (claim[s] == base + j * kThreads + static_cast<int>(threadIdx.x)) tkeys[s] = key[j];
      }
    }
    __syncthreads();
    // C: fold the rows whose slot holds their key, spill the rest
    for (int base = 0; base < msize; base += step) {
      int key[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int i = base + j * kThreads + static_cast<int>(threadIdx.x);
        key[j] = i < msize ? wkeys[m0 + i] : kEmpty;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int i = base + j * kThreads + static_cast<int>(threadIdx.x);
        const unsigned s = key[j] == kEmpty ? 0u : slot_hash(key[j], mask);
        const bool fold = key[j] != kEmpty && tkeys[s] == key[j];
        if (i < msize) wspill[m0 + i] = key[j] != kEmpty && !fold;
        if (fold && claim[s] == i) claim[s] = INT_MAX;
        float v = neutral<Kind>();
        if (fold) v = Kind == kCount ? 1.0f : wvals[m0 + i];
        const unsigned peers = __match_any_sync(kFull, fold ? static_cast<int>(s) : -1 - lane);
        v = warp_fold<Kind>(peers, v, lane);
        if (fold && __ffs(peers) - 1 == lane) {
          fold_block<Kind>(tvals + s, v);
          atomicAdd_block(tcnts + s, static_cast<float>(__popc(peers)));
        }
      }
    }
    __syncthreads();
  }
  if (in_smem) {
    for (int s = threadIdx.x; s < C; s += kThreads) {
      out_keys[w * C + s] = tkeys[s];
      out_vals[w * C + s] = tvals[s];
      out_cnts[w * C + s] = tcnts[s];
    }
  }
}

template <int Kind>
cudaError_t launch(const int* keys, const float* values, int W, long long R, int msize, int C,
                   int* out_keys, float* out_vals, float* out_cnts, int* claim_global,
                   unsigned char* spill, size_t smem, cudaStream_t stream) {
  preagg_kernel<Kind><<<W, kThreads, smem, stream>>>(keys, values, R, msize, C, out_keys,
                                                     out_vals, out_cnts, claim_global, spill);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a table of C slots takes, and the most a
// block may opt in to on the current device (0 when the query fails).
long long preagg_smem_bytes(int C) { return 16LL * C; }

long long preagg_smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess) {
    return 0;
  }
  return optin;
}

// Pre-aggregate W workers of R rows each, morsels of msize rows (R a
// multiple of msize), into W tables of C slots (a power of two), on
// `stream`.  `kind`: 0 sum, 1 count (values may be null), 2 min, 3 max.
// Outputs: out_keys (W, C) int32, out_vals and out_cnts (W, C) float32,
// spill (W * R) bytes of 0 / 1.  `claim_global` is null when the tables
// fit shared memory, else a (W, C) int32 scratch buffer.  Returns a
// cudaError_t as an int (0 = launched); the caller checks shapes, types
// and devices.
int preagg_launch(const void* keys, const void* values, int W, long long R, int msize, int C,
                  int kind, void* out_keys, void* out_vals, void* out_cnts, void* claim_global,
                  void* spill, void* stream) {
  if (W < 1 || R < 0 || msize < 1 || C < 1 || (C & (C - 1)) != 0 || kind < kSum ||
      kind > kMax || (R % msize) != 0 || (kind != kCount && values == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  if (claim_global == nullptr) {
    smem = static_cast<size_t>(preagg_smem_bytes(C));
    if (static_cast<long long>(smem) > preagg_smem_optin()) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // the shared-memory opt-in, once per device and kind
    static int opted[64][4];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev >= 64) err = cudaErrorInvalidDevice;
    if (err == cudaSuccess && !opted[dev][kind]) {
      const int optin = static_cast<int>(preagg_smem_optin());
      switch (kind) {
        case kSum: err = cudaFuncSetAttribute(preagg_kernel<kSum>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
          break;
        case kCount: err = cudaFuncSetAttribute(preagg_kernel<kCount>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                optin);
          break;
        case kMin: err = cudaFuncSetAttribute(preagg_kernel<kMin>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
          break;
        default: err = cudaFuncSetAttribute(preagg_kernel<kMax>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
          break;
      }
      if (err == cudaSuccess) opted[dev][kind] = 1;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int* k = static_cast<const int*>(keys);
  const float* v = static_cast<const float*>(values);
  int* ok = static_cast<int*>(out_keys);
  float* ov = static_cast<float*>(out_vals);
  float* oc = static_cast<float*>(out_cnts);
  int* cg = static_cast<int*>(claim_global);
  unsigned char* sp = static_cast<unsigned char*>(spill);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kSum: err = launch<kSum>(k, v, W, R, msize, C, ok, ov, oc, cg, sp, smem, s); break;
    case kCount: err = launch<kCount>(k, v, W, R, msize, C, ok, ov, oc, cg, sp, smem, s); break;
    case kMin: err = launch<kMin>(k, v, W, R, msize, C, ok, ov, oc, cg, sp, smem, s); break;
    default: err = launch<kMax>(k, v, W, R, msize, C, ok, ov, oc, cg, sp, smem, s); break;
  }
  return static_cast<int>(err);
}

const char* preagg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
