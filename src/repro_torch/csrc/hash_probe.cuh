// Device-scope protocol of the port's concurrent hash table (Folklore*,
// paper Algorithm 1), shared by ticket_hash.cu and fused_groupby.cu so the
// two kernels cannot drift apart.
//
// A table is two int32 arrays of C slots (C a power of two): the slot's key
// (kEmpty where free) and its 1-based ticket (0 until published), plus
// key_by_ticket (G entries) and a ticket count.  Every CTA of the card may
// probe the same table at once, so claims and the count are device-scope
// atomics and the publish / wait pair is release / acquire at GPU scope.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace hash_probe {

namespace cg = cooperative_groups;

constexpr int kEmpty = -1;
// A published ticket is one store away from its CAS; a spin this long
// means a broken protocol, and the kernel traps instead of hanging.
constexpr long long kSpinLimit = 1LL << 26;

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

__device__ __forceinline__ int ld_relaxed_gpu(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// GET_OR_INSERT of one key (not kEmpty): read the slot's key; claim an
// empty slot with atomicCAS(kEmpty -> key).  The CAS winners that are
// converged in a warp take one atomicAdd on *count for their ticket range
// (the fuzzy ticketer), so tickets stay gap-free and *count may pass G; a
// winner writes key_by_ticket[t-1] when t <= G and publishes t.  A thread
// that meets its own key spins until the ticket is published.  At most C
// slots are probed (one wrap).  Returns the 1-based ticket, 0 when the row
// stays unresolved; *plen gets the slots probed.  *issued (may be null) is
// a shared-memory counter that gains the tickets this call issued.
__device__ __forceinline__ int get_or_insert(int key, int* tkeys, int* ttks, int* kbt,
                                             int* count, int C, int G, int* plen,
                                             int* issued) {
  const unsigned mask = static_cast<unsigned>(C - 1);
  unsigned slot = slot_hash(key, mask);
  for (int probe = 0; probe < C; ++probe) {
    *plen = probe + 1;
    int k = ld_relaxed_gpu(tkeys + slot);
    if (k == kEmpty) {
      const int prev = atomicCAS(tkeys + slot, kEmpty, key);
      if (prev == kEmpty) {
        cg::coalesced_group winners = cg::coalesced_threads();
        int base = 0;
        if (winners.thread_rank() == 0) {
          base = atomicAdd(count, static_cast<int>(winners.size()));
          if (issued != nullptr) atomicAdd_block(issued, static_cast<int>(winners.size()));
        }
        base = winners.shfl(base, 0);
        const int t = base + static_cast<int>(winners.thread_rank()) + 1;
        if (t <= G) kbt[t - 1] = key;
        st_release_gpu(ttks + slot, t);
        return t;
      }
      k = prev;
    }
    if (k == key) {
      int t;
      long long spins = 0;
      while ((t = ld_acquire_gpu(ttks + slot)) == 0) {
        if (++spins > kSpinLimit) __trap();
        __nanosleep(32);
      }
      return t;
    }
    slot = (slot + 1) & mask;
  }
  return 0;
}

// Float min/max as integer atomics: non-negative floats order like their
// int bits, negative floats order reversed as unsigned bits.  Correct
// against the ±inf neutrals and for -0.0 (signbit, not `v >= 0`).  The
// generic address works on global memory (device scope) and on shared.
__device__ __forceinline__ void atomic_min_f32(float* a, float v) {
  if (!signbit(v)) atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* a, float v) {
  if (!signbit(v)) atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

}  // namespace hash_probe
