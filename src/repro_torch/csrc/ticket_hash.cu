// GET_OR_INSERT ticketing kernel for Hopper (sm_90a): one key column
// against one table that the wrapper makes fresh for the call.
//
// Replaces: src/repro/kernels/ticket_hash.py, `ticket_hash_pallas` →
// `_ticket_kernel` (the Pallas TPU kernel of ExecutionPolicy.kernel="split").
//
// What it computes, for every row r of the column:
//   tickets[r] = the 0-based ticket of keys[r], or -1 for EMPTY padding and
//   for a row the full table could not place.  Folklore* (paper
//   Algorithm 1): read the slot; claim an empty slot with
//   atomicCAS(EMPTY -> key); each claim takes one ticket of the count,
//   writes key_by_ticket[t-1] when t <= G (the reference drops the write
//   past the bound) and publishes t in its slot; a row that meets its own
//   key takes the published ticket.  Linear probing, at most C slots (one
//   wrap).  Tickets are gap-free: one count increment per claim, so count
//   may exceed G (the caller's overflow check relies on it).
//
// Bound on this card: bytes.  The least traffic is the keys read and the
// tickets written once (8 B a row), the fresh table (8 B a slot) and
// key_by_ticket (4 B a group) written once, over 3.35 TB/s.
//
// Design.  A slot is one 64-bit word: the key in its low half, the 1-based
// ticket in its high half (0 until published), so a claim and its publish
// touch one sector.  table_keys and table_tickets are strided views of the
// slot words.  Two modes: the shapes rule region mode out or allow it
// (may_use_regions), and where they allow it a sample of the keys decides
// on the card (ticket_sample_kernel), with no host sync.
//
// Tile mode (a table that the 50 MB L2 holds, many rows per slot, or keys
// that repeat):
// ticket_fill_kernel writes the fresh table, key_by_ticket and the count in
// one launch; then persistent CTAs of ticket_tile_kernel take tiles of
// kThreads × kRows rows.  For each tile:
//   * Dedupe.  A direct-mapped cache of (key, ticket) words in shared memory
//     answers keys this CTA has resolved.  A key it has not is claimed in
//     the cache by one row, its leader (a shared 64-bit CAS writes (key, 0));
//     rows that meet the claim follow it, and only leaders (and rows whose
//     cache slot another key holds in flight) touch the table.  A hot key,
//     or a small key set, then costs one table access per CTA, not one per
//     row on the same few L2 lines.
//   * Phase A, claim without waiting.  Every touching row issues its slot
//     load, then its CAS, all rows of a thread in flight together, and
//     notes one outcome: won (its CAS claimed the slot), found (the slot
//     holds its key with a published ticket), or pending (its key, not yet
//     published).  A row whose slot holds another key probes on, never
//     waiting either.
//   * One count atomic per tile: a block-wide scan over the winners gives
//     each a place in the tile's range, which one atomicAdd on the count
//     takes.  Winners write key_by_ticket and publish their tickets.
//   * Phase B, after a __syncthreads: pending rows wait for their ticket;
//     then, after another, followers read their leader's from the cache.
// No CTA waits on itself, and no wait closes a cycle: a slot is claimed
// only in some CTA's phase A, and that CTA publishes it before its own
// phase B, after a scan and an atomicAdd that wait on nothing outside the
// CTA.  So every pending row's ticket is published in bounded time.
//
// Region mode (a table past the L2, at most 2^26 slots, with at most one
// row per 16 slots, and keys that are mostly distinct, as a chunk of
// unique keys has): in tile mode every insert there reads and later
// writes back one random sector of device memory.  Instead the table is
// built region by region in shared memory and written once, and nothing
// is written at random places.  On keys that repeat, tile mode's fill and
// cached probes cost less than region mode's staging and gather, and a hot
// key would crowd one region's slab.  So where the shapes allow region
// mode:
//   0. ticket_sample_kernel puts kSampleRows rows, in runs of 32
//      consecutive rows spread evenly over the column (one line per warp
//      load: 8192 single rows, loaded by the one CTA, took 0.024 ms on an
//      H100), into a set in shared memory and counts r, the rows whose
//      key the set already holds.  Over d equally frequent keys a sample of
//      S rows repeats about S^2 / (2d), so r * n > S^2 estimates d < n / 2:
//      tile mode then (the steps below skip on the flag it writes; the
//      fill writes the table, and the tile kernel takes every row);
//   1. ticket_fill_kernel zeroes the count and the scratch counters;
//   2. ticket_stage_kernel drops each row (key, row) into the staging slab
//      of its home region (kRegionSlots slots): a CTA counts a chunk of rows
//      per region in shared memory, takes each region's slab range with one
//      atomic, sorts the chunk by region in shared memory and writes it out
//      in runs; each row's slab entry goes to `where`, in row order; a row
//      that finds its slab full goes to an overflow list;
//   3. ticket_region_kernel: a CTA builds each region in shared memory from
//      an empty region, as the slot words it ends as: its staged keys insert
//      with shared CAS, the region's new keys take tickets with one count
//      atomic (a scan over the region), the CTA writes key_by_ticket, each
//      staged row's ticket into its slab entry, and the whole region with
//      16-byte stores (this is the table's fill).  A key whose probe runs
//      past the region's end goes to the overflow list;
//   4. ticket_tile_kernel (tile mode's protocol) places the overflow rows
//      against the finished table: a key that overran its region takes the
//      first empty slot past it, so the table stays a valid linear-probing
//      table;
//   5. ticket_gather_kernel writes every other row's ticket in row order
//      from its slab entry (EMPTY rows -1) and EMPTY into key_by_ticket past
//      the final count.  (Filling key_by_ticket first left the L2 full of
//      dirty lines that the staging writes had to evict; writing the
//      tickets from the region kernel scattered 4-byte stores over them.)

// The publish and the wait are relaxed stores and loads of the ticket
// word, with no release / acquire and no fence.  A waiter reads only that
// word: it already saw its key in the slot (by its load or its CAS), and a
// claimed slot's key never changes.  A 64-bit load that shows its key with
// a ticket is final for the same reason: only the slot's winner writes the
// ticket, once.  A load that shows EMPTY is checked by the CAS, which sees
// the true key.  key_by_ticket and the tickets are read only after the
// kernel, which orders every write before them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

using hash_probe::kEmpty;
using hash_probe::kSpinLimit;
using hash_probe::slot_hash;
constexpr unsigned kFull = 0xffffffffu;
// tile mode
constexpr int kThreads = 512;
constexpr int kRows = 4;  // rows per thread per tile
constexpr int kCacheSlots = 4096;  // per-CTA (key, ticket) cache, 32 KB
// region mode: slots per region (64 KiB of slot words in shared memory),
// staged rows a region holds, and the smallest table
constexpr int kRegionLog2 = 13;
constexpr int kRegionSlots = 1 << kRegionLog2;
constexpr int kRegionThreads = 512;
constexpr int kRegionRows = 2;
constexpr int kSlab = kRegionThreads * kRegionRows;
constexpr int kRegionMinSlots = 1 << 23;  // 64 MiB of slot words
// the slab counts and the overflow count, one per 128-byte line, so that the
// staging atomics spread over the L2
constexpr int kCountStride = 32;
constexpr int kRegionSmem = kRegionSlots * 8;  // the region's slot words
constexpr int kFillThreads = 256;
// staging: rows per CTA chunk, and the most regions (a shared-memory count
// each); `where` and slab-entry markers
constexpr int kStageThreads = 1024;
constexpr int kStageRows = 16;  // a chunk's rank in a region fits 16 bits
constexpr int kMaxRegions = 8192;
constexpr int kWhereEmpty = -1, kWhereOvf = -2, kRanPast = -2;
// staging's shared memory: two ints per region and the chunk's rows sorted
constexpr int kStageSmem = kMaxRegions * 2 * 4 + kStageThreads * kStageRows * 8;
// region mode's choice: rows sampled, in runs of kSampleRun, and the
// shared-memory set (64 KiB)
constexpr int kSampleThreads = 1024;
constexpr int kSampleRows = 8192;
constexpr int kSampleRun = 32;  // a warp's lanes
static_assert(kSampleRun == 32 && kSampleRows % (kSampleRun * kSampleThreads / 32) == 0,
              "a sampled run is one warp load");
constexpr int kSampleSlots = 2 * kSampleRows;
constexpr int kSampleSmem = kSampleSlots * 4;
// a free slot word, and a free cache word: key EMPTY, ticket 0
constexpr unsigned long long kFreeSlot = 0x00000000FFFFFFFFull;
// row outcomes (kNone: EMPTY, or not placed in C probes)
constexpr int kNone = 0, kWon = 1, kFound = 2, kPending = 3;
// a row's part in a tile's dedupe
constexpr int kSolo = 0, kLead = 1, kFollow = 2, kCached = 3;

// The shapes allow region mode when the table is past the L2 and sparse:
// at least kRegionMinSlots slots and 16 slots a row, so staged slabs
// (kSlab rows for kRegionSlots slots, twice the mean) rarely overflow, and
// rows enough for the sample to be a small part of them.  The sample then
// decides.
bool may_use_regions(long long n, int C) {
  return n >= 4LL * kSampleRows && C >= kRegionMinSlots && (C >> kRegionLog2) <= kMaxRegions &&
         n * 16 <= C;
}

__device__ __forceinline__ unsigned long long ld_slot(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed_gpu(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

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

__device__ __forceinline__ int* key_word(unsigned long long* slots, unsigned s) {
  return reinterpret_cast<int*>(slots + s);
}

__device__ __forceinline__ int* ticket_word(unsigned long long* slots, unsigned s) {
  return reinterpret_cast<int*>(slots + s) + 1;
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
// of the CTA calls it (three __syncthreads).
template <int Block>
__device__ __forceinline__ int claim_tickets(int x, int* count, int* s_warp, int* s_base) {
  const int before = block_scan<Block>(x, s_warp, s_base);
  if (threadIdx.x == 0) *s_base = *s_base > 0 ? atomicAdd(count, *s_base) : 0;
  __syncthreads();
  return *s_base + before + 1;
}

// The outcome of slot word `w` (loaded, or the CAS's view of it) for
// `key`: found / pending when the slot holds the key, -1 for another key.
// `from_cas`: w's key half came from a failed CAS, its ticket half is
// unknown.
__device__ __forceinline__ int outcome(int key, unsigned long long w, bool from_cas,
                                       int* tick) {
  if (key_of(w) != key) return -1;
  *tick = from_cas ? 0 : ticket_of(w);
  return *tick != 0 ? kFound : kPending;
}

// Probe on from the slot after *slot, until C slots were probed in all;
// never waits.  Returns the row's outcome (kNone: the table is full).
__device__ int probe_on(int key, unsigned* slot, int* tick, unsigned long long* slots,
                        unsigned mask, int C) {
  for (int probe = 1; probe < C; ++probe) {
    *slot = (*slot + 1) & mask;
    unsigned long long w = ld_slot(slots + *slot);
    bool from_cas = false;
    if (key_of(w) == kEmpty) {
      const int prev = atomicCAS(key_word(slots, *slot), kEmpty, key);
      if (prev == kEmpty) return kWon;
      w = static_cast<unsigned>(prev);
      from_cas = true;
    }
    const int st = outcome(key, w, from_cas, tick);
    if (st >= 0) return st;
  }
  return kNone;
}

// This row's part in the tile's dedupe, from cache word c (see the file
// comment); may claim the cache slot.
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

// Region mode's choice (step 0 in the file comment): *use_regions = 1 when
// the sampled rows repeat few keys, else 0.
__global__ void __launch_bounds__(kSampleThreads) ticket_sample_kernel(
    const int* __restrict__ keys, long long n, int* use_regions) {
  extern __shared__ int sample_set[];  // (kSampleSlots,) keys, EMPTY where free
  __shared__ int s_repeats;
  constexpr int kPerThread = kSampleRows / kSampleThreads;
  constexpr int kRuns = kSampleRows / kSampleRun, kWarps = kSampleThreads / 32;
  for (int i = threadIdx.x; i < kSampleSlots; i += kSampleThreads) sample_set[i] = kEmpty;
  if (threadIdx.x == 0) s_repeats = 0;
  int key[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {  // the loads, all in flight: a run per warp
    const long long run = j * kWarps + (threadIdx.x >> 5);
    const long long start = (run * n / kRuns) & ~static_cast<long long>(kSampleRun - 1);
    key[j] = keys[start + (threadIdx.x & 31)];
  }
  __syncthreads();
  int repeats = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (key[j] == kEmpty) continue;
    // the set holds at most half its slots: the probe ends
    for (unsigned h = slot_hash(key[j], kSampleSlots - 1);; h = (h + 1) & (kSampleSlots - 1)) {
      int k = *static_cast<volatile int*>(sample_set + h);
      if (k == kEmpty) {
        k = atomicCAS_block(sample_set + h, kEmpty, key[j]);
        if (k == kEmpty) break;
      }
      if (k == key[j]) {
        ++repeats;
        break;
      }
    }
  }
  if (repeats != 0) atomicAdd_block(&s_repeats, repeats);
  __syncthreads();
  if (threadIdx.x == 0) {
    *use_regions = static_cast<long long>(s_repeats) * n <=
                   static_cast<long long>(kSampleRows) * kSampleRows;
  }
}

__global__ void __launch_bounds__(kThreads) ticket_tile_kernel(
    const int* __restrict__ keys,  // (N,)
    const int* use_regions,        // region mode's flag, or null (tile mode)
    const int* rows,               // region mode: the overflow rows into keys / tickets
    const int* n_dev,              // region mode: their count
    long long n_arg,               // tile mode: the rows, 0..n_arg-1
    int* __restrict__ tickets,     // (N,) out, 0-based, -1 unresolved
    unsigned long long* slots,     // (C,) free slots where not claimed
    int* __restrict__ kbt,         // (G,) written for each ticket <= G it issues
    int* count,                    // (1,)
    int C, int G) {
  __shared__ unsigned long long s_cache[kCacheSlots];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_base;
  const bool overflow_pass = use_regions != nullptr && *use_regions != 0;
  if (!overflow_pass) rows = nullptr;
  const long long n = overflow_pass ? *n_dev : n_arg;
  const long long tile = static_cast<long long>(kThreads) * kRows;
  if (blockIdx.x * tile >= n) return;  // no tile for this CTA
  for (int i = threadIdx.x; i < kCacheSlots; i += kThreads) s_cache[i] = kFreeSlot;
  __syncthreads();

  const unsigned mask = static_cast<unsigned>(C - 1);
  for (long long base = blockIdx.x * tile; base < n; base += gridDim.x * tile) {
    int key[kRows], tick[kRows], state[kRows], role[kRows], prev[kRows];
    long long row[kRows];
    unsigned hash[kRows], slot[kRows];
    unsigned long long w[kRows];

#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long i = base + j * kThreads + threadIdx.x;
      row[j] = i < n ? (rows != nullptr ? rows[i] : i) : -1;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) key[j] = row[j] >= 0 ? keys[row[j]] : kEmpty;

    // -- dedupe through the CTA's cache ------------------------------------
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      state[j] = kNone;
      tick[j] = 0;
      role[j] = kSolo;
      if (key[j] == kEmpty) continue;
      hash[j] = slot_hash(key[j], kFull);
      slot[j] = hash[j] & mask;
      role[j] = dedupe_role(s_cache + (hash[j] & (kCacheSlots - 1)), key[j], &tick[j]);
      if (role[j] == kCached) state[j] = kFound;
    }
    // rows that touch the table: leaders and solos
    bool touch[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      touch[j] = key[j] != kEmpty && (role[j] == kLead || role[j] == kSolo);
    }

    // -- phase A: claim without waiting ------------------------------------
#pragma unroll
    for (int j = 0; j < kRows; ++j) {  // the slot loads, all in flight
      if (touch[j]) w[j] = ld_slot(slots + slot[j]);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {  // the CASes, all in flight
      prev[j] = 0;
      if (touch[j] && key_of(w[j]) == kEmpty) {
        prev[j] = atomicCAS(key_word(slots, slot[j]), kEmpty, key[j]);
      }
    }
    int won = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (!touch[j]) continue;
      const bool cased = key_of(w[j]) == kEmpty;
      if (cased && prev[j] == kEmpty) {
        state[j] = kWon;
      } else {
        const unsigned long long seen = cased ? static_cast<unsigned>(prev[j]) : w[j];
        const int st = outcome(key[j], seen, cased, &tick[j]);
        state[j] = st >= 0 ? st : probe_on(key[j], &slot[j], &tick[j], slots, mask, C);
      }
      won += state[j] == kWon;
    }

    // -- one count atomic per tile; publish --------------------------------
    int next = claim_tickets<kThreads>(won, count, s_warp, &s_base);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (state[j] == kWon) {
        const int t = next++;
        if (t <= G) kbt[t - 1] = key[j];
        st_relaxed_gpu(ticket_word(slots, slot[j]), t);
        tick[j] = t;
      }
      if (role[j] == kLead && (state[j] == kWon || state[j] == kFound)) {
        s_cache[hash[j] & (kCacheSlots - 1)] = pack(key[j], tick[j]);
      }
    }
    __syncthreads();  // this CTA's tickets are published

    // -- phase B: pending rows wait; then followers read their leader ------
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (!touch[j]) continue;
      if (state[j] == kPending) {
        long long spins = 0;
        int t;
        while ((t = hash_probe::ld_relaxed_gpu(ticket_word(slots, slot[j]))) == 0) {
          if (++spins > kSpinLimit) __trap();
          __nanosleep(32);
        }
        tick[j] = t;
        state[j] = kFound;
        if (role[j] == kLead) s_cache[hash[j] & (kCacheSlots - 1)] = pack(key[j], t);
      } else if (state[j] == kNone && role[j] == kLead) {
        // the full table could not place it: its followers get -1 too
        s_cache[hash[j] & (kCacheSlots - 1)] = pack(key[j], -1);
      }
    }
    __syncthreads();  // every leader's ticket is in the cache
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (role[j] == kFollow && key[j] != kEmpty) {
        const unsigned long long c = s_cache[hash[j] & (kCacheSlots - 1)];
        if (key_of(c) != key[j] || ticket_of(c) == 0) __trap();  // broken protocol
        tick[j] = ticket_of(c);
        state[j] = tick[j] > 0 ? kFound : kNone;
      }
      if (row[j] >= 0) tickets[row[j]] = state[j] == kNone ? -1 : tick[j] - 1;
    }
    __syncthreads();  // followers have read the cache before the next dedupe
  }
}

// Region mode, step 2: each row to its home region's slab.  A CTA takes a
// chunk of kStageThreads × kStageRows rows and counts them per region in
// shared memory; it takes each region's range of its slab with one
// atomicAdd per region it meets (not one per row), sorts the chunk's rows
// by region in shared memory, and writes them out in that order, so the
// rows of one region go to its slab as one run.  Each row's slab entry goes
// to `where` in row order (kWhereEmpty for EMPTY rows; kWhereOvf for rows
// of a full slab, which go to the overflow list: a chunk takes its range of
// the list with one atomicAdd, so a hot key's rows past its slab do not
// serialise on the list's count).
__global__ void __launch_bounds__(kStageThreads) ticket_stage_kernel(
    const int* __restrict__ keys, long long n, unsigned mask, int regions,
    int2* __restrict__ slab, int* slab_count, int* ovf, int* ovf_count,
    int* __restrict__ where, const int* use_regions) {
  if (*use_regions == 0) return;
  extern __shared__ int4 stage_smem[];
  int* s_base = reinterpret_cast<int*>(stage_smem);  // per region: rows, then slab base
  int* s_start = s_base + kMaxRegions;               // per region: start in s_sorted
  int2* s_sorted = reinterpret_cast<int2*>(s_start + kMaxRegions);  // the chunk by region
  __shared__ int s_warp[kStageThreads / 32];
  __shared__ int s_total, s_ovf, s_ovf_base;  // the chunk's overflow rows, its list range
  constexpr int kBinsPerThread = kMaxRegions / kStageThreads;
  const long long chunk = static_cast<long long>(kStageThreads) * kStageRows;
  for (long long base = blockIdx.x * chunk; base < n; base += gridDim.x * chunk) {
    for (int i = threadIdx.x; i < regions; i += kStageThreads) s_base[i] = 0;
    if (threadIdx.x == 0) s_ovf = 0;
    __syncthreads();
    // key, and region << 16 | rank within the chunk's rows of the region
    int key[kStageRows], place[kStageRows];
#pragma unroll
    for (int j = 0; j < kStageRows; ++j) {
      const long long r = base + j * kStageThreads + threadIdx.x;
      key[j] = r < n ? keys[r] : kEmpty;
    }
#pragma unroll
    for (int j = 0; j < kStageRows; ++j) {
      if (key[j] == kEmpty) continue;
      const int bin = static_cast<int>(slot_hash(key[j], mask) >> kRegionLog2);
      place[j] = (bin << 16) | atomicAdd_block(s_base + bin, 1);
    }
    __syncthreads();
    // each thread's run of regions: their starts in s_sorted (a scan) and
    // their slab bases (one global atomic each)
    int c[kBinsPerThread], mine = 0;
#pragma unroll
    for (int q = 0; q < kBinsPerThread; ++q) {
      const int i = threadIdx.x * kBinsPerThread + q;
      c[q] = i < regions ? s_base[i] : 0;
      mine += c[q];
    }
    int start = block_scan<kStageThreads>(mine, s_warp, &s_total);
#pragma unroll
    for (int q = 0; q < kBinsPerThread; ++q) {
      const int i = threadIdx.x * kBinsPerThread + q;
      if (i >= regions) break;
      s_start[i] = start;
      start += c[q];
      s_base[i] = c[q] != 0 ? atomicAdd(slab_count + static_cast<size_t>(i) * kCountStride, c[q])
                            : 0;
    }
    __syncthreads();
    int spill[kStageRows];  // a row's place among the chunk's overflow rows, or -1
#pragma unroll
    for (int j = 0; j < kStageRows; ++j) {
      const long long r = base + j * kStageThreads + threadIdx.x;
      bool over = false;
      if (r < n && key[j] == kEmpty) {
        where[r] = kWhereEmpty;
      } else if (r < n) {
        const int bin = place[j] >> 16, rank = place[j] & 0xFFFF;
        const int pos = s_base[bin] + rank;
        over = pos >= kSlab;
        s_sorted[s_start[bin] + rank] = make_int2(key[j], over ? -1 : static_cast<int>(r));
        where[r] = over ? kWhereOvf : bin * kSlab + pos;
      }
      const int place_in_chunk = warp_append<true>(over, &s_ovf);
      spill[j] = over ? place_in_chunk : -1;
    }
    __syncthreads();
    if (threadIdx.x == 0 && s_ovf != 0) s_ovf_base = atomicAdd(ovf_count, s_ovf);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kStageRows; ++j) {
      if (spill[j] >= 0) {
        ovf[s_ovf_base + spill[j]] = static_cast<int>(base + j * kStageThreads + threadIdx.x);
      }
    }
    for (int i = threadIdx.x; i < s_total; i += kStageThreads) {
      const int2 e = s_sorted[i];
      if (e.y < 0) continue;  // its slab was full
      const int bin = static_cast<int>(slot_hash(e.x, mask) >> kRegionLog2);
      slab[static_cast<size_t>(bin) * kSlab + s_base[bin] + (i - s_start[bin])] = e;
    }
    __syncthreads();  // shared memory is reset for the next chunk
  }
}

// Region mode, step 5: every row's ticket from its slab entry, in row
// order, skipping the overflow rows that step 4 placed; and key_by_ticket
// EMPTY past the final count (every entry below it was written by its
// ticket's winner).
__global__ void __launch_bounds__(kFillThreads) ticket_gather_kernel(
    const int* __restrict__ where, const int2* __restrict__ slab, int* __restrict__ tickets,
    long long n, int* __restrict__ kbt, const int* count, int G, const int* use_regions) {
  if (*use_regions == 0) return;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long r = i0; r < n; r += stride) {
    const int w = where[r];
    if (w == kWhereEmpty) {
      tickets[r] = -1;
    } else if (w >= 0) {
      const int t = slab[w].x;
      if (t != kRanPast) tickets[r] = t;
    }
  }
  for (long long g = *count + i0; g < G; g += stride) kbt[g] = kEmpty;
}

// Region mode, step 3: build each region in shared memory, as the slot
// words it ends as, and write it out with 16-byte stores.
__global__ void __launch_bounds__(kRegionThreads) ticket_region_kernel(
    unsigned long long* __restrict__ slots, int* __restrict__ kbt, int* count,
    int2* __restrict__ slab,
    const int* __restrict__ slab_count, int* ovf, int* ovf_count, int regions, int G,
    const int* use_regions) {
  if (*use_regions == 0) return;
  extern __shared__ int4 region_smem[];
  unsigned long long* s_slot = reinterpret_cast<unsigned long long*>(region_smem);
  __shared__ int s_warp[kRegionThreads / 32];
  __shared__ int s_base;
  constexpr int kPerThread = kRegionSlots / kRegionThreads;

  for (int b = blockIdx.x; b < regions; b += gridDim.x) {
    for (int i = threadIdx.x; i < kRegionSlots; i += kRegionThreads) s_slot[i] = kFreeSlot;
    __syncthreads();
    const int staged = min(slab_count[static_cast<size_t>(b) * kCountStride], kSlab);
    int at[kRegionRows], rid[kRegionRows];
#pragma unroll
    for (int j = 0; j < kRegionRows; ++j) {
      const int i = j * kRegionThreads + threadIdx.x;
      at[j] = -1;
      rid[j] = -1;
      if (i < staged) {
        const int2 kr = slab[static_cast<size_t>(b) * kSlab + i];
        rid[j] = kr.y;
        for (int h = slot_hash(kr.x, kRegionSlots - 1); h < kRegionSlots; ++h) {
          int* kw = reinterpret_cast<int*>(s_slot + h);
          int k = *static_cast<volatile int*>(kw);
          if (k == kEmpty) {
            k = atomicCAS_block(kw, kEmpty, kr.x);
            if (k == kEmpty) k = kr.x;
          }
          if (k == kr.x) {
            at[j] = h;
            break;
          }
        }
      }
      // ran past the region: the overflow pass places it
      const bool past = i < staged && at[j] < 0;
      const int o = warp_append<false>(past, ovf_count);
      if (past) {
        ovf[o] = rid[j];
        slab[static_cast<size_t>(b) * kSlab + i] = make_int2(kRanPast, rid[j]);
      }
    }
    __syncthreads();

    // the region's keys take tickets: one count atomic per region
    int mine = 0;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      mine += key_of(s_slot[q * kRegionThreads + threadIdx.x]) != kEmpty;
    }
    int t = claim_tickets<kRegionThreads>(mine, count, s_warp, &s_base);
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = q * kRegionThreads + threadIdx.x;
      const int k = key_of(s_slot[i]);
      if (k == kEmpty) continue;
      const int tk = t++;
      if (tk <= G) kbt[tk - 1] = k;
      reinterpret_cast<int*>(s_slot + i)[1] = tk;
    }
    __syncthreads();
    int4* out = reinterpret_cast<int4*>(slots + static_cast<size_t>(b) * kRegionSlots);
    const int4* in = reinterpret_cast<const int4*>(s_slot);
    for (int i = threadIdx.x; i < kRegionSlots / 2; i += kRegionThreads) out[i] = in[i];
#pragma unroll
    for (int j = 0; j < kRegionRows; ++j) {  // each staged row's ticket, in its slab entry
      if (at[j] >= 0) {
        slab[static_cast<size_t>(b) * kSlab + j * kRegionThreads + threadIdx.x] =
            make_int2(ticket_of(s_slot[at[j]]) - 1, rid[j]);
      }
    }
    __syncthreads();  // s_slot is reset for the next region
  }
}

// The fresh state: in tile mode the table and key_by_ticket (region mode
// writes them in its own steps: skipped when *use_regions, if given), the
// count and the `zeros` scratch counters 0.  16-byte stores, then the tails.
__global__ void __launch_bounds__(kFillThreads) ticket_fill_kernel(
    unsigned long long* slots, int C, int* kbt, int G, int* count, int* zeros,
    int n_zeros, const int* use_regions) {
  if (use_regions != nullptr && *use_regions != 0) {
    slots = nullptr;
    G = 0;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int4 free2 = make_int4(kEmpty, 0, kEmpty, 0);
  const int4 empty4 = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  if (slots != nullptr) {
    int4* s4 = reinterpret_cast<int4*>(slots);
    for (long long i = i0; i < C / 2; i += stride) s4[i] = free2;
  }
  int4* k4 = reinterpret_cast<int4*>(kbt);
  for (long long i = i0; i < G / 4; i += stride) k4[i] = empty4;
  for (long long i = i0; i < n_zeros; i += stride) zeros[i] = 0;
  if (i0 == 0) {
    if (slots != nullptr && (C & 1)) slots[C - 1] = kFreeSlot;
    for (int g = G & ~3; g < G; ++g) kbt[g] = kEmpty;
    *count = 0;
  }
}

struct Limits {
  int sms, tile_per_sm, region_per_sm;
};

// The device's SMs and the resident CTAs per SM of the two table kernels
// (queried once per device; the region, staging and sample kernels opt in
// to their dynamic shared memory here).
cudaError_t limits(Limits* out) {
  static Limits cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev].sms == 0) {
    Limits l{};
    const int smem = kRegionSmem;
    err = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.tile_per_sm, ticket_tile_kernel,
                                                          kThreads, 0);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ticket_region_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ticket_stage_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kStageSmem);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ticket_sample_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSampleSmem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.region_per_sm, ticket_region_kernel,
                                                          kRegionThreads, smem);
    }
    if (err != cudaSuccess) return err;
    if (l.tile_per_sm < 1) l.tile_per_sm = 1;
    if (l.region_per_sm < 1) l.region_per_sm = 1;
    cached[dev] = l;
  }
  *out = cached[dev];
  return cudaSuccess;
}

// Scratch layout (int32) where the shapes allow region mode: the slabs (2
// ints a row), the slab counts and the overflow count (kCountStride ints
// each), the sample's flag (kCountStride), the overflow list (n), `where`
// (n).
struct Scratch {
  int2* slab;
  int *slab_count, *ovf_count, *use_regions, *ovf, *where;
};

long long scratch_ints(long long n, int C) {
  if (!may_use_regions(n, C)) return 0;
  const long long regions = C >> kRegionLog2;
  return regions * kSlab * 2 + (regions + 2) * kCountStride + 2 * n;
}

Scratch scratch_of(void* scratch, long long n, int C) {
  const long long regions = C >> kRegionLog2;
  Scratch sc;
  sc.slab = static_cast<int2*>(scratch);
  sc.slab_count = static_cast<int*>(scratch) + regions * kSlab * 2;
  sc.ovf_count = sc.slab_count + regions * kCountStride;
  sc.use_regions = sc.ovf_count + kCountStride;
  sc.ovf = sc.use_regions + kCountStride;
  sc.where = sc.ovf + n;
  return sc;
}

// The fresh state for a call on n rows: the table, key_by_ticket and the
// count, and where the shapes allow region mode the scratch counters, and
// the table and key_by_ticket only if the sample chose tile mode.
cudaError_t launch_fill(const Limits& l, void* slots, void* kbt, void* count, void* scratch,
                        long long n, int C, int G, void* stream) {
  int* zeros = nullptr;
  int n_zeros = 0;
  const int* use_regions = nullptr;
  if (may_use_regions(n, C)) {
    const Scratch sc = scratch_of(scratch, n, C);
    zeros = sc.slab_count;
    n_zeros = static_cast<int>(((C >> kRegionLog2) + 1) * kCountStride);
    use_regions = sc.use_regions;
  }
  long long quads = C / 2 > G / 4 ? C / 2 : G / 4;
  if (quads < n_zeros) quads = n_zeros;
  long long blocks = (quads + kFillThreads - 1) / kFillThreads;
  const long long cap = static_cast<long long>(l.sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  ticket_fill_kernel<<<static_cast<int>(blocks), kFillThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slots), C, static_cast<int*>(kbt), G,
      static_cast<int*>(count), zeros, n_zeros, use_regions);
  return cudaGetLastError();
}

// The ticket kernels on n > 0 keys.  Where the shapes allow region mode,
// the sample and the fill run here, before the region steps (each of which
// returns at once when the sample chose tile mode); else against the state
// launch_fill made.
cudaError_t launch_ticket(const Limits& l, const void* keys, void* tickets, void* slots,
                          void* kbt, void* count, void* scratch, long long n, int C, int G,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(keys);
  int* t = static_cast<int*>(tickets);
  unsigned long long* sl = static_cast<unsigned long long*>(slots);
  int* kb = static_cast<int*>(kbt);
  int* cnt = static_cast<int*>(count);
  const long long tile = static_cast<long long>(kThreads) * kRows;
  long long tile_blocks = (n + tile - 1) / tile;
  if (tile_blocks > static_cast<long long>(l.sms) * l.tile_per_sm) {
    tile_blocks = static_cast<long long>(l.sms) * l.tile_per_sm;
  }
  if (!may_use_regions(n, C)) {
    ticket_tile_kernel<<<static_cast<int>(tile_blocks), kThreads, 0, s>>>(
        k, nullptr, nullptr, nullptr, n, t, sl, kb, cnt, C, G);
    return cudaGetLastError();
  }
  const Scratch sc = scratch_of(scratch, n, C);
  ticket_sample_kernel<<<1, kSampleThreads, kSampleSmem, s>>>(k, n, sc.use_regions);
  cudaError_t err = launch_fill(l, slots, kbt, count, scratch, n, C, G, stream);
  if (err != cudaSuccess) return err;
  const int regions = C >> kRegionLog2;
  const long long chunk = static_cast<long long>(kStageThreads) * kStageRows;
  long long stage_blocks = (n + chunk - 1) / chunk;
  if (stage_blocks > static_cast<long long>(l.sms) * 2) stage_blocks = l.sms * 2;
  ticket_stage_kernel<<<static_cast<int>(stage_blocks), kStageThreads, kStageSmem, s>>>(
      k, n, static_cast<unsigned>(C - 1), regions, sc.slab, sc.slab_count, sc.ovf, sc.ovf_count,
      sc.where, sc.use_regions);
  int region_blocks = l.sms * l.region_per_sm;
  if (region_blocks > regions) region_blocks = regions;
  ticket_region_kernel<<<region_blocks, kRegionThreads, kRegionSmem, s>>>(
      sl, kb, cnt, sc.slab, sc.slab_count, sc.ovf, sc.ovf_count, regions, G, sc.use_regions);
  // region mode: the overflow rows, by tile mode's protocol (their count is
  // read on the device; CTAs past it exit at once); tile mode: every row
  ticket_tile_kernel<<<static_cast<int>(tile_blocks), kThreads, 0, s>>>(
      k, sc.use_regions, sc.ovf, sc.ovf_count, n, t, sl, kb, cnt, C, G);
  long long gather_blocks = ((n > G ? n : G) + kFillThreads - 1) / kFillThreads;
  if (gather_blocks > static_cast<long long>(l.sms) * 8) gather_blocks = l.sms * 8;
  ticket_gather_kernel<<<static_cast<int>(gather_blocks), kFillThreads, 0, s>>>(
      sc.where, sc.slab, t, n, kb, cnt, G, sc.use_regions);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 words of scratch a call on n rows and C slots needs (0: none).
long long ticket_hash_scratch_ints(long long n, int C) { return scratch_ints(n, C); }

// One call on n keys on `stream`.  `phases`: 1 makes the fresh state
// (slots (C,) 64-bit words and kbt (G,) int32, both 16-byte aligned; the
// count, one int32; scratch, ticket_hash_scratch_ints(n, C) int32 words,
// 16-byte aligned, or null when that is 0), 2 runs the ticket kernels on
// it (tickets (n,) int32 out), 3 both.  Where the shapes allow region mode (scratch not
// null), 2 makes the fresh state itself, after the sample, and 1 does
// nothing.  Returns a cudaError_t as an int (0 = launched).
// The caller allocates and checks shapes, types and devices.
int ticket_hash_launch(const void* keys, void* tickets, void* slots, void* kbt, void* count,
                       void* scratch, long long n, int C, int G, int phases, void* stream) {
  if (n < 0 || C < 1 || (C & (C - 1)) != 0 || G < 0 || phases < 1 || phases > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Limits l;
  cudaError_t err = limits(&l);
  if (err == cudaSuccess && (phases & 1) && !may_use_regions(n, C)) {
    err = launch_fill(l, slots, kbt, count, scratch, n, C, G, stream);
  }
  if (err == cudaSuccess && (phases & 2) && n > 0) {
    err = launch_ticket(l, keys, tickets, slots, kbt, count, scratch, n, C, G, stream);
  }
  return static_cast<int>(err);
}

const char* ticket_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
