// Local pre-aggregation kernels for Hopper (sm_90a): the first stage of the
// partitioned baseline (strategy="partitioned", Leis et al.).
//
// Replaces: src/repro/core/partitioned.py:48 `preagg_morsel` under
// `_partitioned_impl` (:138): a jnp loop (vmap over workers, lax.scan over
// morsels), no Pallas kernel.
//
// What it computes.  W workers; worker w owns rows [w*R, (w+1)*R) of the
// chunk (keys as int32 bit patterns, kEmpty = -1 for a masked row, and one
// float32 value a row).  Each worker has a direct-mapped table of C slots
// (keys, vals, cnts).  The reference takes the rows morsel by morsel, and
// per morsel every live row whose slot is free votes with its lane, the
// lowest lane installs its key, and every live row whose slot then holds
// its own key folds; the rest spill.  Since a key never leaves its slot
// and (morsel, lane) is the worker's row order, that resolves, whatever
// the morsel size, to the first-row rule:
//   * slot s holds the key of the worker's FIRST live row whose
//     slot_hash is s (kEmpty if there is none);
//   * a live row folds iff its slot holds its key: vals (+)= v, where (+)
//     is +, min or max and count adds 1.0, and cnts += 1.0;
//   * every other live row spills: spill[row] = 1.  Masked rows neither
//     vote nor spill.
// So the table keys, the spill mask and cnts equal the reference's bit for
// bit; only the order of the float sums differs.
//
// Bound on this card: bytes.  The least traffic is the keys and values read
// once (8 B a row), the spill mask written once (1 B a row) and the W*C*12
// bytes of tables written once, over 3.35 TB/s.
//
// Design.  By the rule, one worker's rows split over any number of CTAs:
// the only step across CTAs is an atomicMin of a row index per slot.  A
// launch is a fill of the scratch (the key table, then W done counters:
// all bits set) and two kernels on W*T CTAs, CTA (w, t) on a contiguous
// tile of worker w's rows (a tile never spans two workers; by default
// about two CTAs an SM):
//   1. preagg_first_kernel: each live row's worker row index goes into
//      first[slot] (the key table, read as unsigned) by atomicMin: a
//      per-CTA copy in shared memory, flushed with one device atomicMin
//      per touched slot (in global memory directly when C passes the
//      shared-memory path).  A plain read skips the atomic when first[s]
//      <= row, and __match_any_sync lets one lane of a warp's group try,
//      so a hot slot costs reads.  The last CTA of each worker (a done
//      counter after __threadfence) turns first rows into keys in place
//      and writes vals (the kind's neutral) and cnts (0).
//   2. preagg_fold_kernel: each CTA reads its worker's table keys into
//      shared memory, folds the rows whose slot holds their key into a
//      private vals / cnts copy and writes the spill mask; then it folds the
//      copy into the output tables with device atomics, for the slots it
//      touched only (in global memory directly past the shared-memory
//      path).  Same-address atomics serialise, so skew is folded in
//      registers: each warp keeps up to kHotSlots hot slots, found by
//      __match_any_sync on the first rows of each step, and a lane folds
//      its rows of a hot slot into its own registers (one shuffle
//      reduction and one atomic a slot and warp at the end); other rows of
//      a probed step fold a group at a time (a shuffle tree), the
//      rest one atomic a row.  Min and max are the sign-split integer
//      atomics of segment_agg.cu, exact with -0.0 and ±inf.  Values are
//      read only for quads with a folding row, never for count.
// Keys are read 16 bytes a thread where the address allows (a quad of rows
// whose index is a multiple of 4, when the keys, values and spill pointers
// are aligned); a tile's ragged head and tail quads are read by row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

using hash_probe::atomic_max_f32;
using hash_probe::atomic_min_f32;
using hash_probe::kEmpty;
using hash_probe::kFull;
using hash_probe::slot_hash;  // xxhash32, seed 0: repro.core.hashing.slot_hash

constexpr int kSum = 0, kCount = 1, kMin = 2, kMax = 3;
constexpr int kThreads = 512;
constexpr int kUnroll = 2;             // quads a thread loads per step
constexpr int kMaxSmemSlots = 8192;    // C of the shared-memory path (12*C bytes)
constexpr int kMinTile = 2048;         // rows of the smallest automatic tile
constexpr unsigned kNoRow = 0xffffffffu;
constexpr int kHotGroup = 4;           // lanes of a warp on one slot that make it hot
constexpr int kHotSlots = 2;           // hot slots a warp folds in registers
// flags: skip a pass's flush (timing only: the result is then wrong)
constexpr int kSkipFirstFlush = 1, kSkipFoldFlush = 2;

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

// Block-scope fold into the CTA's shared copy.
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

// Device-scope fold into the output tables.
template <int Kind>
__device__ __forceinline__ void fold_device(float* a, float v) {
  if (Kind == kSum || Kind == kCount) atomicAdd(a, v);
  else if (Kind == kMin) atomic_min_f32(a, v);
  else atomic_max_f32(a, v);
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

// A CTA's tile: rows [e0, e1) of the flat (W*R) arrays, all of worker w.
struct Tile {
  long long w, e0, e1, wbase;  // wbase = w*R
};

__device__ __forceinline__ Tile tile_of(long long R, int T, long long tile_rows) {
  Tile t;
  t.w = blockIdx.x / T;
  t.wbase = t.w * R;
  const long long lo = static_cast<long long>(blockIdx.x % T) * tile_rows;
  t.e0 = t.wbase + lo;
  t.e1 = t.wbase + (lo + tile_rows < R ? lo + tile_rows : R);
  return t;
}

// Whether quad q (rows 4q..4q+3) lies wholly inside the tile and may be
// read with one 16-byte load.
__device__ __forceinline__ bool full_quad(long long q, const Tile& t, bool vec) {
  return vec && 4 * q >= t.e0 && 4 * q + 4 <= t.e1;
}

// The keys of quad q, kEmpty outside the tile.
__device__ __forceinline__ void load_keys(const int* keys, long long q, const Tile& t, bool vec,
                                          int k[4]) {
  if (full_quad(q, t, vec)) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(keys) + q);
    k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long e = 4 * q + j;
      k[j] = e >= t.e0 && e < t.e1 ? __ldg(keys + e) : kEmpty;
    }
  }
}

// Pass 1: first[s] (worker w's key table, read as unsigned) = the lowest
// worker row index of a live row with slot s; then the last CTA of each
// worker turns its first rows into keys and writes vals and cnts.
template <bool Smem>
__global__ void __launch_bounds__(kThreads) preagg_first_kernel(
    const int* __restrict__ keys, long long R, int C, int T, long long tile_rows, bool vec,
    float neutral_val, int flags, unsigned* __restrict__ done, int* __restrict__ out_keys,
    float* __restrict__ out_vals, float* __restrict__ out_cnts) {
  extern __shared__ unsigned s_first[];
  __shared__ bool s_last;
  const Tile t = tile_of(R, T, tile_rows);
  const int tid = threadIdx.x, lane = tid & 31;
  unsigned* gfirst = reinterpret_cast<unsigned*>(out_keys) + t.w * C;
  unsigned* tfirst = Smem ? s_first : gfirst;
  if (Smem) {
    for (int s = tid; s < C; s += kThreads) s_first[s] = kNoRow;
    __syncthreads();
  }
  const unsigned mask = static_cast<unsigned>(C - 1);
  const long long q_lo = t.e0 >> 2, q_hi = (t.e1 + 3) >> 2;
  for (long long q0 = q_lo; q0 < q_hi; q0 += kThreads * kUnroll) {
    int k[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_keys(keys, q0 + u * kThreads + tid, t, vec, k[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned row0 = static_cast<unsigned>(4 * (q0 + u * kThreads + tid) - t.wbase);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k[u][j];
        const unsigned row = row0 + j;
        const unsigned s = key == kEmpty ? 0u : slot_hash(key, mask);
        // a stale read is never below the true first row: skipping on it
        // is safe
        const bool need = key != kEmpty && (Smem ? tfirst[s] : __ldcg(tfirst + s)) > row;
        const unsigned want = __ballot_sync(kFull, need);
        if (need) {
          const unsigned peers = __match_any_sync(want, s);
          if (__ffs(peers) - 1 == lane) {
            if (Smem) atomicMin_block(tfirst + s, row);
            else atomicMin(tfirst + s, row);
          }
        }
      }
    }
  }
  if (Smem) {
    __syncthreads();
    if (!(flags & kSkipFirstFlush)) {
      for (int s = tid; s < C; s += kThreads) {
        if (s_first[s] != kNoRow) atomicMin(gfirst + s, s_first[s]);
      }
    }
  }
  // -- the last CTA of worker w writes its table ---------------------------
  __threadfence();
  __syncthreads();
  // done[w] starts at all bits set (-1), so the last of T CTAs reads T - 2
  if (tid == 0) s_last = atomicAdd(done + t.w, 1u) == static_cast<unsigned>(T) - 2u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int s = tid; s < C; s += kThreads) {
    const unsigned f = __ldcg(gfirst + s);
    out_keys[t.w * C + s] = f == kNoRow ? kEmpty : __ldg(keys + t.wbase + f);
    out_vals[t.w * C + s] = neutral_val;
    out_cnts[t.w * C + s] = 0.0f;
  }
}

template <int Kind, bool Smem>
__device__ __forceinline__ void fold_one(float* tvals, float* tcnts, unsigned slot, float x,
                                         float n) {
  if (Smem) {
    fold_block<Kind>(tvals + slot, x);
    atomicAdd_block(tcnts + slot, n);
  } else {
    fold_device<Kind>(tvals + slot, x);
    atomicAdd(tcnts + slot, n);
  }
}

// A warp's hot slots (the same in every lane; kNoRow where none) and each
// lane's partial aggregate and count of the rows it folded into them, in
// registers.
struct HotSlots {
  unsigned slot[kHotSlots];
  float val[kHotSlots], n[kHotSlots];
};

// Combine hot slot i's partials over the warp and fold them into the
// tables with one atomic each (lane 0); the partials restart.
template <int Kind, bool Smem>
__device__ __forceinline__ void flush_hot(HotSlots& hot, int i, float* tvals, float* tcnts,
                                          int lane) {
  float x = hot.val[i], n = hot.n[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = combine<Kind>(x, __shfl_xor_sync(kFull, x, o));
    n += __shfl_xor_sync(kFull, n, o);
  }
  if (lane == 0 && n != 0.0f) fold_one<Kind, Smem>(tvals, tcnts, hot.slot[i], x, n);
  hot.val[i] = neutral<Kind>();
  hot.n[i] = 0.0f;
}

// Fold one row a lane (where `fold`: value v into slot s) into the tables
// (the CTA's shared copy, or the output in global memory).
//   * A row of one of the warp's hot slots folds into its lane's registers.
//   * While `probe` holds (warp-uniform), the other rows are grouped by
//     __match_any_sync and each group folded by a shuffle tree, one atomic
//     a group.  The largest group, at kHotGroup lanes or more, takes the
//     place of the hot slot that had fewer lanes this step (which is
//     flushed); probing stops once no group reaches kHotGroup.
//   * Otherwise each row folds with its own atomic: without hot slots
//     same-address atomics are few, and they cost less than the match.
template <int Kind, bool Smem>
__device__ __forceinline__ void fold_rows(bool fold, unsigned s, float v, float* tvals,
                                          float* tcnts, int lane, bool& probe, HotSlots& hot) {
  bool rest = fold;
#pragma unroll
  for (int i = 0; i < kHotSlots; ++i) {
    if (rest && s == hot.slot[i]) {
      hot.val[i] = combine<Kind>(hot.val[i], v);
      hot.n[i] += 1.0f;
      rest = false;
    }
  }
  if (!probe) {
    if (rest) fold_one<Kind, Smem>(tvals, tcnts, s, v, 1.0f);
    return;
  }
  if (__ballot_sync(kFull, rest) == 0) return;
  const unsigned peers = __match_any_sync(kFull, rest ? static_cast<int>(s) : -1 - lane);
  const int size = rest ? __popc(peers) : 0;
  const int big = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(size)));
  probe = big >= kHotGroup;
  if (probe) {
    // the hot slot with fewer lanes this step gives way to the largest group
    // if that has twice as many (so that two slots of like weight do not
    // take turns)
    int cold = 0, fewest = 33;
#pragma unroll
    for (int i = 0; i < kHotSlots; ++i) {
      const int on = __popc(__ballot_sync(kFull, fold && s == hot.slot[i]));
      if (on < fewest) fewest = on, cold = i;
    }
    if (big >= 2 * fewest) {
      const unsigned slot = __shfl_sync(kFull, s, __ffs(__ballot_sync(kFull, size == big)) - 1);
#pragma unroll
      for (int i = 0; i < kHotSlots; ++i) {  // (i == cold, unrolled: no local memory)
        if (i != cold) continue;
        if (hot.slot[i] != kNoRow) flush_hot<Kind, Smem>(hot, i, tvals, tcnts, lane);
        hot.slot[i] = slot;
        if (rest && s == slot) {
          hot.val[i] = v;
          hot.n[i] = 1.0f;
          rest = false;
        }
      }
    }
  }
  const float x = warp_fold<Kind>(peers, rest ? v : neutral<Kind>(), lane);
  if (rest && __ffs(peers) - 1 == lane) {
    fold_one<Kind, Smem>(tvals, tcnts, s, x, static_cast<float>(__popc(peers)));
  }
}

// Pass 2: fold the rows whose slot holds their key, spill the other live
// rows.
template <int Kind, bool Smem>
__global__ void __launch_bounds__(kThreads) preagg_fold_kernel(
    const int* __restrict__ keys, const float* __restrict__ values, long long R, int C, int T,
    long long tile_rows, bool vec, int flags, const int* __restrict__ out_keys,
    float* __restrict__ out_vals, float* __restrict__ out_cnts,
    unsigned char* __restrict__ spill) {
  extern __shared__ int smem[];
  const Tile t = tile_of(R, T, tile_rows);
  const int tid = threadIdx.x, lane = tid & 31;
  const int* gkeys = out_keys + t.w * C;
  float* gvals = out_vals + t.w * C;
  float* gcnts = out_cnts + t.w * C;
  const int* tkeys = Smem ? smem : gkeys;
  float* tvals = Smem ? reinterpret_cast<float*>(smem + C) : gvals;
  float* tcnts = Smem ? reinterpret_cast<float*>(smem + 2 * C) : gcnts;
  if (Smem) {
    for (int s = tid; s < C; s += kThreads) {
      smem[s] = __ldg(gkeys + s);
      tvals[s] = neutral<Kind>();
      tcnts[s] = 0.0f;
    }
    __syncthreads();
  }
  const unsigned mask = static_cast<unsigned>(C - 1);
  const long long q_lo = t.e0 >> 2, q_hi = (t.e1 + 3) >> 2;
  HotSlots hot;
#pragma unroll
  for (int i = 0; i < kHotSlots; ++i) {
    hot.slot[i] = kNoRow;
    hot.val[i] = neutral<Kind>();
    hot.n[i] = 0.0f;
  }
  for (long long q0 = q_lo; q0 < q_hi; q0 += kThreads * kUnroll) {
    bool probe = true;  // look for hot slots again every kUnroll quads
    int k[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_keys(keys, q0 + u * kThreads + tid, t, vec, k[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * kThreads + tid;
      const bool full = full_quad(q, t, vec);
      unsigned s[4];
      bool fold[4];
      unsigned spill_word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k[u][j];
        s[j] = key == kEmpty ? 0u : slot_hash(key, mask);
        fold[j] = key != kEmpty && tkeys[s[j]] == key;
        if (key != kEmpty && !fold[j]) spill_word |= 1u << (8 * j);
      }
      // the spill bytes: one 4-byte store for a whole quad
      if (full) {
        reinterpret_cast<unsigned*>(spill)[q] = spill_word;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long e = 4 * q + j;
          if (e >= t.e0 && e < t.e1) spill[e] = (spill_word >> (8 * j)) & 1u;
        }
      }
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (Kind != kCount && (fold[0] || fold[1] || fold[2] || fold[3])) {
        if (full) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(values) + q);
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (fold[j]) v[j] = __ldg(values + 4 * q + j);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (__ballot_sync(kFull, fold[j]) == 0) continue;
        fold_rows<Kind, Smem>(fold[j], s[j], Kind == kCount ? 1.0f : v[j], tvals, tcnts, lane,
                              probe, hot);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kHotSlots; ++i) {
    if (hot.slot[i] != kNoRow) flush_hot<Kind, Smem>(hot, i, tvals, tcnts, lane);
  }
  if (Smem && !(flags & kSkipFoldFlush)) {
    __syncthreads();
    for (int s = tid; s < C; s += kThreads) {
      const float n = tcnts[s];
      if (n != 0.0f) {
        fold_device<Kind>(gvals + s, tvals[s]);
        atomicAdd(gcnts + s, n);
      }
    }
  }
}

// The device's SM count and shared-memory opt-in, queried once per device;
// the fold kernels' opt-in to 12 * kMaxSmemSlots bytes, set once.
struct DeviceLimits {
  int sms = 0, optin = 0;
  bool opted = false;
};

cudaError_t device_limits(int dev, DeviceLimits** out) {
  static DeviceLimits cached[64];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceLimits& d = cached[dev];
  cudaError_t err = cudaSuccess;
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) {
      d.sms = 0;
      return err;
    }
  }
  if (!d.opted && 12 * kMaxSmemSlots <= d.optin) {
    const int bytes = 12 * kMaxSmemSlots;
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    err = cudaFuncSetAttribute(preagg_fold_kernel<kSum, true>, a, bytes);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(preagg_fold_kernel<kCount, true>, a, bytes);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(preagg_fold_kernel<kMin, true>, a, bytes);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(preagg_fold_kernel<kMax, true>, a, bytes);
    if (err != cudaSuccess) return err;
    d.opted = true;
  }
  *out = &d;
  return cudaSuccess;
}

template <int Kind>
void launch_fold(bool smem, int grid, size_t bytes, cudaStream_t stream, const int* keys,
                 const float* values, long long R, int C, int T, long long tile, bool vec,
                 int flags, const int* ok, float* ov, float* oc, unsigned char* sp) {
  if (smem) {
    preagg_fold_kernel<Kind, true><<<grid, kThreads, bytes, stream>>>(
        keys, values, R, C, T, tile, vec, flags, ok, ov, oc, sp);
  } else {
    preagg_fold_kernel<Kind, false><<<grid, kThreads, 0, stream>>>(
        keys, values, R, C, T, tile, vec, flags, ok, ov, oc, sp);
  }
}

// The fill and the two passes on the current device (see preagg_launch).
cudaError_t launch(const int* k, const float* v, int W, long long R, int C, int kind,
                   long long tile, int flags, int* ok, float* ov, float* oc,
                   unsigned char* sp, int device, int* grid_out, cudaStream_t s) {
  DeviceLimits* lim = nullptr;
  cudaError_t err = device_limits(device, &lim);
  if (err != cudaSuccess) return err;
  const bool smem = C <= kMaxSmemSlots && lim->opted;
  if (tile == 0) {  // about two CTAs an SM, in multiples of 1024 rows
    const long long per_worker = (2LL * lim->sms + W - 1) / W;
    tile = ((R + per_worker - 1) / per_worker + 1023) / 1024 * 1024;
    const long long least = smem && C > kMinTile ? C : kMinTile;
    if (tile < least) tile = least;
  }
  const long long T = R == 0 ? 1 : (R + tile - 1) / tile;
  if (T * W >= (1LL << 31)) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(T * W), Ti = static_cast<int>(T);
  grid_out[0] = grid;
  grid_out[1] = static_cast<int>(tile);
  // quads of rows read 16 bytes at a time need 16-byte aligned keys and
  // values and a 4-byte aligned spill mask
  const bool vec = (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                   (v == nullptr || (reinterpret_cast<uintptr_t>(v) & 15) == 0) &&
                   (reinterpret_cast<uintptr_t>(sp) & 3) == 0;
  unsigned* done = reinterpret_cast<unsigned*>(ok) + static_cast<long long>(W) * C;
  const float neutral_val = kind == kMin ? INFINITY : (kind == kMax ? -INFINITY : 0.0f);
  err = cudaMemsetAsync(ok, 0xff, (static_cast<size_t>(W) * C + W) * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  if (smem) {
    preagg_first_kernel<true><<<grid, kThreads, 4 * C, s>>>(
        k, R, C, Ti, tile, vec, neutral_val, flags, done, ok, ov, oc);
  } else {
    preagg_first_kernel<false><<<grid, kThreads, 0, s>>>(
        k, R, C, Ti, tile, vec, neutral_val, flags, done, ok, ov, oc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || R == 0) return err;  // no rows: nothing to fold or spill
  const size_t bytes = smem ? 12 * static_cast<size_t>(C) : 0;
  switch (kind) {
    case kSum: launch_fold<kSum>(smem, grid, bytes, s, k, v, R, C, Ti, tile, vec, flags, ok,
                                 ov, oc, sp); break;
    case kCount: launch_fold<kCount>(smem, grid, bytes, s, k, v, R, C, Ti, tile, vec, flags,
                                     ok, ov, oc, sp); break;
    case kMin: launch_fold<kMin>(smem, grid, bytes, s, k, v, R, C, Ti, tile, vec, flags, ok,
                                 ov, oc, sp); break;
    default: launch_fold<kMax>(smem, grid, bytes, s, k, v, R, C, Ti, tile, vec, flags, ok,
                               ov, oc, sp); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pre-aggregate W workers of R rows each into W tables of C slots (a power
// of two) on `device` and `stream`.  `kind`: 0 sum, 1 count (values may be
// null), 2 min, 3 max.  Outputs: out_keys (W, C) int32 followed by W
// words of scratch (the key table holds each slot's first row until the
// last CTA of its worker writes the keys; the W words are done counters;
// all filled here), out_vals and out_cnts (W, C) float32, spill (W * R)
// bytes of 0 / 1.
// `tile_rows` > 0 fixes the rows of a CTA's tile, 0 picks about two CTAs
// an SM.  `flags` 0 (1 / 2 skip pass 1's / pass 2's flush: for timing
// only).  grid_out gets (CTAs per pass, tile rows).  Returns a cudaError_t
// as an int (0 = launched); the caller checks shapes, types and devices.
int preagg_launch(const void* keys, const void* values, int W, long long R, int C, int kind,
                  int tile_rows, int flags, void* out_keys, void* out_vals, void* out_cnts,
                  void* spill, int device, int* grid_out, void* stream) {
  if (W < 1 || R < 0 || R >= (1LL << 31) || C < 1 || (C & (C - 1)) != 0 || kind < kSum ||
      kind > kMax || tile_rows < 0 ||
      (R > 0 && (keys == nullptr || (kind != kCount && values == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(static_cast<const int*>(keys), static_cast<const float*>(values), W, R, C, kind,
               tile_rows, flags, static_cast<int*>(out_keys), static_cast<float*>(out_vals),
               static_cast<float*>(out_cnts), static_cast<unsigned char*>(spill), device,
               grid_out, static_cast<cudaStream_t>(stream));
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

const char* preagg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
