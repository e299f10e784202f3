// Fused GROUP BY kernel for Hopper (sm_90a): ticketing and aggregate
// update of one morselized chunk against a table carried across chunks.
//
// Replaces: src/repro/kernels/fused_groupby.py, `fused_consume` →
// `_fused_kernel` (the Pallas TPU kernel of ExecutionPolicy.kernel="fused").
//
// What it computes, per program p (one local table per program) and per
// morsel i = start[p] .. npm-1 in order:
//   1. the §4.4 room check: with `checked`, a morsel pauses BEFORE it
//      tickets anything when count > threshold (or count > bound_slack
//      under `grow_bound`; bound_slack may be negative), and the program
//      halts;
//   2. GET_OR_INSERT of every row (Folklore*, paper Algorithm 1): read the
//      slot's key, claim an empty slot with atomicCAS(EMPTY -> key); the
//      winner takes ticket atomicAdd(count) + 1, writes key_by_ticket[t-1]
//      when t <= G and publishes t; a thread that meets its own key with
//      ticket 0 spins until the ticket is published.  At most C slots are
//      probed (one wrap); a row still unresolved marks the morsel saturated;
//   3. with `checked`, a saturated morsel halts the program and commits no
//      update (its inserts stay: replay takes the lookup path);
//   4. otherwise every resolved row updates the S accumulator planes:
//      atomicAdd for sum/count, an order-preserving integer atomicMin/Max
//      for min/max (neutral ±inf);
//   5. committed-morsel event counts (morsels, rows, masked rows, probe
//      steps, probe-length histogram) plus saturations and pauses, added to
//      events[p] once at the end.
//
// Bound on this card: it moves bytes and does almost no arithmetic.  The
// least traffic is the keys and value planes read once plus the table
// slots, key_by_ticket entries and accumulators the chunk touches, each
// read and written once, over 3.35 TB/s.  Probing is a chain of dependent
// loads and atomics, so one CTA is latency bound long before that.
//
// Design: one CTA per program.  Its loop over the program's morsels stands
// in for the TPU's sequential grid axis, so "first halted morsel" keeps its
// exact meaning and the pause decision depends only on the program's
// distinct count, which is deterministic.  Table, key_by_ticket and
// accumulators stay in global memory (high-cardinality tables do not fit
// shared memory).  Only program p's CTA touches program p's state, so
// block-scoped atomics and acquire/release at CTA scope suffice, and the
// count lives in shared memory.  Everything is updated in place.
// Simple first: with P = 1 the kernel uses one SM of 132.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kInfoLen = 4;  // count, first halt, saturation, halted
constexpr int kNoHalt = 0x7FFFFFFF;
constexpr int kEvtMorsels = 0, kEvtRows = 1, kEvtRowsMasked = 2,
              kEvtProbeSteps = 3, kEvtProbeSaturations = 4, kEvtPauses = 5,
              kNumEvents = 6;
constexpr int kHistBuckets = 8;  // edges 2, 3, 4, 5, 9, 17, 33
constexpr int kEventVecLen = kNumEvents + kHistBuckets;
constexpr int kMaxSpecs = 16;
constexpr int kSum = 0, kCount = 1, kMin = 2, kMax = 3;
// A published ticket is one store away from its CAS; a spin this long
// means a broken protocol, and the kernel traps instead of hanging.
constexpr long long kSpinLimit = 1LL << 26;

struct Specs {
  int n;
  int plane[kMaxSpecs];  // value plane, or -1 (count reads none)
  int kind[kMaxSpecs];
};

__device__ __forceinline__ unsigned slot_hash(int key, unsigned mask) {
  // xxhash32 avalanche, seed 0: repro.kernels.ticket_hash._slot_hash_i32
  unsigned x = static_cast<unsigned>(key);
  x ^= x >> 15;
  x *= 0x85EBCA77u;
  x ^= x >> 13;
  x *= 0xC2B2AE3Du;
  x ^= x >> 16;
  return x & mask;
}

__device__ __forceinline__ int ld_relaxed_cta(const int* p) {
  int v;
  asm volatile("ld.relaxed.cta.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// Float min/max as integer atomics: non-negative floats order like their
// int bits, negative floats order reversed as unsigned bits.  Correct
// against the ±inf neutrals and for -0.0 (signbit, not `v >= 0`).
__device__ __forceinline__ void atomic_min_f32(float* a, float v) {
  if (!signbit(v)) atomicMin_block(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMax_block(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* a, float v) {
  if (!signbit(v)) atomicMax_block(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMin_block(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

__global__ void __launch_bounds__(1024) fused_groupby_kernel(
    const int* __restrict__ keys,      // (P*npm, M)
    const float* __restrict__ values,  // (V, P*npm, M)
    const int* __restrict__ start,     // (P,)
    int* __restrict__ tkeys,           // (P, C)
    int* __restrict__ ttks,            // (P, C)
    int* __restrict__ kbt,             // (P, G)
    float* __restrict__ accs,          // (S, P, G)
    int* __restrict__ count,           // (P,)
    int* __restrict__ events,          // (P, kEventVecLen)
    int* __restrict__ info,            // (P, kInfoLen)
    Specs specs, int P, int npm, int M, int C, int G, int checked,
    int grow_bound, int threshold, int bound_slack, int collect_events) {
  extern __shared__ int smem[];
  int* s_ticket = smem;      // (M,) 1-based ticket of each row, 0 unresolved
  int* s_plen = smem + M;    // (M,) probe length, -1 for masked rows
  __shared__ int s_count;
  __shared__ int s_ev[kEventVecLen];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  int* tk = tkeys + static_cast<size_t>(p) * C;
  int* tt = ttks + static_cast<size_t>(p) * C;
  int* kb = kbt + static_cast<size_t>(p) * G;
  const size_t plane_rows = static_cast<size_t>(P) * npm * M;
  const unsigned mask = static_cast<unsigned>(C - 1);

  if (tid == 0) s_count = count[p];
  if (tid < kEventVecLen) s_ev[tid] = 0;
  __syncthreads();

  // per-thread committed counts, reduced once at the end
  int my_rows = 0, my_masked = 0, my_steps = 0;
  int my_hist[kHistBuckets];
#pragma unroll
  for (int b = 0; b < kHistBuckets; ++b) my_hist[b] = 0;
  // block-uniform control state
  int halted = 0, first_halt = kNoHalt, sat_any = 0;
  int n_morsels = 0, n_saturations = 0, n_pauses = 0;

  for (int i = start[p]; i < npm; ++i) {
    const int c0 = s_count;
    __syncthreads();  // every thread read c0 before this morsel's inserts
    if (checked) {
      const bool needs_room =
          c0 > threshold || (grow_bound && c0 > bound_slack);
      if (needs_room) {
        halted = 1;
        first_halt = min(first_halt, i);
        ++n_pauses;
        break;
      }
    }
    const size_t row0 = (static_cast<size_t>(p) * npm + i) * M;

    // -- phase 1: ticket every row of the morsel ------------------------
    int unresolved = 0;
    for (int r = tid; r < M; r += nthreads) {
      const int key = keys[row0 + r];
      int ticket = 0, plen = -1;
      if (key != kEmpty) {
        unsigned slot = slot_hash(key, mask);
        plen = 0;
        for (int probe = 0; probe < C; ++probe) {
          ++plen;
          int k = ld_relaxed_cta(tk + slot);
          if (k == kEmpty) {
            const int prev = atomicCAS_block(tk + slot, kEmpty, key);
            if (prev == kEmpty) {
              const int t = atomicAdd_block(&s_count, 1) + 1;
              if (t <= G) kb[t - 1] = key;
              st_release_cta(tt + slot, t);
              ticket = t;
              break;
            }
            k = prev;
          }
          if (k == key) {
            int t;
            long long spins = 0;
            while ((t = ld_acquire_cta(tt + slot)) == 0) {
              if (++spins > kSpinLimit) __trap();
              __nanosleep(32);
            }
            ticket = t;
            break;
          }
          slot = (slot + 1) & mask;
        }
        if (ticket == 0) unresolved = 1;
      }
      s_ticket[r] = ticket;
      s_plen[r] = plen;
    }
    const int sat = __syncthreads_or(unresolved);
    if (sat) {
      sat_any = 1;
      ++n_saturations;
    }
    if (checked && sat) {
      // halt; inserts stay published, updates are dropped
      halted = 1;
      first_halt = min(first_halt, i);
      ++n_pauses;
      break;
    }

    // -- phase 2: fold the committed morsel into the accumulators --------
    ++n_morsels;
    for (int r = tid; r < M; r += nthreads) {
      const int plen = s_plen[r];
      if (plen < 0) {
        ++my_masked;
        continue;
      }
      ++my_rows;
      my_steps += plen;
      const int bucket = (plen >= 2) + (plen >= 3) + (plen >= 4) +
                         (plen >= 5) + (plen >= 9) + (plen >= 17) +
                         (plen >= 33);
#pragma unroll
      for (int b = 0; b < kHistBuckets; ++b) my_hist[b] += (bucket == b);
      const int t = s_ticket[r];
      if (t <= 0 || t > G) continue;  // unresolved, or past the bound
      for (int s = 0; s < specs.n; ++s) {
        const int plane = specs.plane[s];
        const float v =
            plane < 0 ? 1.0f : values[plane * plane_rows + row0 + r];
        float* a = accs + (static_cast<size_t>(s) * P + p) * G + (t - 1);
        switch (specs.kind[s]) {
          case kSum:
          case kCount: atomicAdd_block(a, v); break;
          case kMin: atomic_min_f32(a, v); break;
          default: atomic_max_f32(a, v); break;
        }
      }
    }
  }

  if (collect_events) {
    const int lane = tid & 31;
    int sums[3 + kHistBuckets] = {my_rows, my_masked, my_steps};
#pragma unroll
    for (int b = 0; b < kHistBuckets; ++b) sums[3 + b] = my_hist[b];
#pragma unroll
    for (int j = 0; j < 3 + kHistBuckets; ++j) {
      const int w = warp_sum(sums[j]);
      if (lane == 0 && w != 0) atomicAdd_block(&s_ev[j], w);
    }
    __syncthreads();
    if (tid == 0) {
      int* ev = events + static_cast<size_t>(p) * kEventVecLen;
      ev[kEvtMorsels] += n_morsels;
      ev[kEvtRows] += s_ev[0];
      ev[kEvtRowsMasked] += s_ev[1];
      ev[kEvtProbeSteps] += s_ev[2];
      ev[kEvtProbeSaturations] += n_saturations;
      ev[kEvtPauses] += n_pauses;
      for (int b = 0; b < kHistBuckets; ++b) ev[kNumEvents + b] += s_ev[3 + b];
    }
  }
  if (tid == 0) {
    count[p] = s_count;
    int* inf = info + static_cast<size_t>(p) * kInfoLen;
    inf[0] = s_count;
    inf[1] = first_halt;
    inf[2] = sat_any;
    inf[3] = halted;
  }
}

}  // namespace

extern "C" {

// Launch one fused GROUP BY pass on `stream`.  Returns cudaGetLastError()
// as an int (0 = launched).  The caller checks shapes, types and devices.
int fused_groupby_launch(const void* keys, const void* values,
                         const void* start, void* tkeys, void* ttks,
                         void* kbt, void* accs, void* count, void* events,
                         void* info, const int* spec_planes,
                         const int* spec_kinds, int num_specs, int P, int npm,
                         int M, int C, int G, int checked, int grow_bound,
                         int threshold, int bound_slack, int collect_events,
                         void* stream) {
  if (num_specs < 1 || num_specs > kMaxSpecs || P < 1 || M < 1 || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Specs specs;
  specs.n = num_specs;
  for (int s = 0; s < kMaxSpecs; ++s) {
    specs.plane[s] = s < num_specs ? spec_planes[s] : -1;
    specs.kind[s] = s < num_specs ? spec_kinds[s] : kSum;
  }
  int threads = ((M + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = 2 * static_cast<size_t>(M) * sizeof(int);
  fused_groupby_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const float*>(values),
      static_cast<const int*>(start), static_cast<int*>(tkeys),
      static_cast<int*>(ttks), static_cast<int*>(kbt),
      static_cast<float*>(accs), static_cast<int*>(count),
      static_cast<int*>(events), static_cast<int*>(info), specs, P, npm, M, C,
      G, checked, grow_bound, threshold, bound_slack, collect_events);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_groupby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
