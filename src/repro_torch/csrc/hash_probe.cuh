// Device-scope protocol of the port's concurrent hash table (Folklore*,
// paper Algorithm 1), shared by ticket_hash.cu and fused_groupby.cu so the
// kernels cannot drift apart.
//
// A table is two int32 arrays of C slots (C a power of two): the slot's key
// (kEmpty where free) and its 1-based ticket (0 until published), plus
// key_by_ticket (G entries) and a ticket count.  Every CTA of the card may
// probe the same table at once, so claims and the count are device-scope
// atomics.  get_or_insert (the fused kernel's per-row probe) publishes and
// waits with release / acquire at GPU scope.
//
// The tile protocol (the ticket kernel's tile mode and scan_ticket_kernel)
// takes a tile of rows at a time and does not depend on the table's
// layout: a per-CTA direct-mapped (key, ticket) cache in shared memory
// (dedupe_role: one leader per key, followers read its ticket), claims
// that never wait, one count atomic per tile (claim_tickets), a relaxed
// publish, and pending rows that wait only after their CTA's own
// publishes.  Its helpers are below get_or_insert.
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

// -- the tile protocol ---------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
// a free cache word (and a free 64-bit slot word): key EMPTY, ticket 0
constexpr unsigned long long kFreeSlot = 0x00000000FFFFFFFFull;
// row outcomes (kNone: EMPTY, or not placed in C probes)
constexpr int kNone = 0, kWon = 1, kFound = 2, kPending = 3;
// a row's part in a tile's dedupe
constexpr int kSolo = 0, kLead = 1, kFollow = 2, kCached = 3;

__device__ __forceinline__ void st_relaxed_gpu(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// A (key, ticket) word: the key in the low half, the ticket in the high.
__device__ __forceinline__ int key_of(unsigned long long w) {
  return static_cast<int>(static_cast<unsigned>(w));
}

__device__ __forceinline__ int ticket_of(unsigned long long w) {
  return static_cast<int>(static_cast<unsigned>(w >> 32));
}

__device__ __forceinline__ unsigned long long pack(int key, int ticket) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(ticket)) << 32) |
         static_cast<unsigned>(key);
}

// This lane's place in a list that *count counts, for the lanes of the warp
// whose `append` is true: one atomicAdd per warp (block-scope on a shared
// count when Block).  Every lane of the warp calls it.
template <bool Block>
__device__ __forceinline__ int warp_append(bool append, int* count) {
  const unsigned ballot = __ballot_sync(kFull, append);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && ballot != 0) {
    base = Block ? atomicAdd_block(count, __popc(ballot)) : atomicAdd(count, __popc(ballot));
  }
  base = __shfl_sync(kFull, base, 0);
  return base + __popc(ballot & ((1u << lane) - 1u));
}

// The exclusive prefix of x over the CTA's threads; *s_total (shared) gets
// the sum.  Every thread of the CTA calls it (two __syncthreads); s_warp
// holds Block / 32 ints.
template <int Block>
__device__ __forceinline__ int block_scan(int x, int* s_warp, int* s_total) {
  constexpr int kWarpsPerBlock = Block / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int wsum = lane < kWarpsPerBlock ? s_warp[lane] : 0;
    int wincl = wsum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, wincl, d);
      if (lane >= d) wincl += y;
    }
    if (lane < kWarpsPerBlock) s_warp[lane] = wincl - wsum;  // exclusive
    if (lane == 31) *s_total = wincl;
  }
  __syncthreads();
  return s_warp[warp] + (incl - x);
}

// The first of x consecutive 1-based tickets for this thread: a block-wide
// scan of x, and one atomicAdd on *count for the CTA's total.  Every thread
// of the CTA calls it (three __syncthreads).  *s_claimed (shared, may be
// null) gains the total; only thread 0 touches it.
template <int Block>
__device__ __forceinline__ int claim_tickets(int x, int* count, int* s_warp, int* s_base,
                                             int* s_claimed = nullptr) {
  const int before = block_scan<Block>(x, s_warp, s_base);
  if (threadIdx.x == 0) {
    const int total = *s_base;
    if (s_claimed != nullptr) *s_claimed += total;
    *s_base = total > 0 ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  return *s_base + before + 1;
}

// This row's part in the tile's dedupe, from its cache word (see the file
// comment); may claim the cache slot.  kCached sets *tick.
__device__ __forceinline__ int dedupe_role(unsigned long long* cslot, int key, int* tick) {
  unsigned long long c = *static_cast<volatile unsigned long long*>(cslot);
  for (int attempt = 0; attempt < 2; ++attempt) {
    if (key_of(c) == key) {
      const int t = ticket_of(c);
      if (t > 0) {
        *tick = t;
        return kCached;
      }
      if (t == 0) return kFollow;
    }
    const bool in_flight = key_of(c) != kEmpty && ticket_of(c) == 0;
    if (attempt == 1 || in_flight) break;
    const unsigned long long old = atomicCAS(cslot, c, pack(key, 0));
    if (old == c) return kLead;
    c = old;  // another row got there first: follow it if it holds this key
  }
  return kSolo;
}

}  // namespace hash_probe
