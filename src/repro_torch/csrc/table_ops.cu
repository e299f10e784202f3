// Read-only lookup and migration of a carried ticket table, for Hopper
// (sm_90a).
//
// Replaces two `jax.lax.while_loop` programs of the reference's main path:
//   * src/repro/core/ticketing.py:213 `lookup` (the loop at :237): the
//     0-based ticket of each key, -1 for EMPTY and absent keys;
//   * src/repro/core/resize.py:34 `migrate` (the loop at :73): every
//     (key, ticket) pair of a table relocated into a table of C' slots,
//     tickets and key_by_ticket kept (paper §4.4: tickets are immutable).
// The third loop, `get_or_insert` (ticketing.py:82), runs on
// scan_ticket_kernel in unchecked mode (csrc/fused_groupby.cu).
//
// The table is the layout of csrc/hash_probe.cuh: two int32 arrays of C
// slots (C a power of two), the key (kEmpty where free) and the 1-based
// ticket (0 where free); a key's home slot is hash_probe::slot_hash and its
// probe walks slot + 1 mod C.  migrate writes tables in the same layout and
// probe order, so the fused, scan_ticket and lookup kernels read them.
//
// Lookup.  A row walks from its home slot and stops at its key (hit:
// ticket - 1), at a slot whose ticket is 0 (the key is absent) or after C
// slots (an absent key on a full table), exactly as the plain version's
// rounds do, so its output equals the plain version's bit for bit on either
// path.  Nothing writes the table during the launch.  Bound: bytes, the
// keys read and the tickets written once (8 B a row) and a slot (8 B) for
// each distinct present key.  On a table past the L2 a slot costs two
// random 32-B sectors, one in each array (the sector floor); on an H100 the
// device memory serves about 3e10 such sectors a second, so there a hit
// costs its two sectors' time whatever the kernel keeps in flight.
//   * lookup_shared_kernel (C <= kMaxSharedSlots; the wrapper picks the
//     threshold): a persistent grid, as many 1024-thread CTAs as fit an SM,
//     each copies the table into shared memory once with cp.async, as
//     (key, ticket) pairs so a probe is one 8-B shared load, loading its
//     first rows' keys meanwhile, then probes there over a grid-stride
//     loop of the rows, kSharedRows rows a thread, the next step's keys in
//     flight during this step's probes.
//   * lookup_probe_kernel (larger tables): kProbeRows rows a thread (one
//     from kLargeSlots slots, where the sectors' rate rules and more rows
//     in flight only queue: on an H100, 1 row a thread took 0.135 ms on a
//     2^25-slot table where 4 took 0.139).  The thread loads its rows'
//     keys, then the ticket and key words of every row's home slot as
//     independent loads on the read-only path (`ld.global.nc`, allocating
//     in L1: a table that fits the L2 is read many times over), before any
//     compare, so a hit costs one round trip.  Only rows that neither hit
//     nor meet a ticket-0 slot walk on, one slot (both words) at a time.
//
// Migrate into more slots (C2 > C, C2 >= kTile): migrate_tiled_kernel, then
// migrate_overflow_kernel; no fill pass.  slot_hash is the xxhash32
// avalanche masked with C - 1, so in C2 = r C slots a key's new home is its
// old home + k C for some k < r.  The keys whose new home lies in a tile of
// kTile new slots [T0, T0 + kTile) have their old homes in [a, a + kTile),
// a = T0 mod C (the whole table when C < kTile), and each sits between its
// old home and the first ticket-0 slot at or after a + kTile, cyclically
// and at most C slots from a.  A CTA owns one tile.  It loads that old
// range, one coalesced run, and warp 0 the first 32 slots past it, all
// while it clears the tile in shared memory.  Each key whose new home
// falls in the tile claims that slot with a plain store of its ticket:
// tickets are distinct, so after a barrier the key whose ticket stayed
// owns the slot, and only the others probe on by atomicCAS on the tile's
// ticket words (0 -> t), as do the keys of the tail (walked 32 slots a step
// up to the first free slot).  Then the CTA stores the whole tile in 16-B
// coalesced stores, keys, tickets and kEmpty / 0 in the free slots: every
// new slot is written exactly once.  A key that reaches the tile's end
// without a free slot goes to an overflow list (its old slot; the list has
// room for C entries, so the wrapper allocates it without a host read);
// the second launch places those keys by the atomicCAS walk from their home
// in the global table.  Slots only go from free to taken, so the slots
// between any key's home and its place stay taken: the result is a valid
// table.  The CTA owns a tile of new slots, not a range of old homes and
// its r output tiles: its shared memory is one tile whatever the ratio (2
// at a grow, 4 or more from grow_bound), the r tiles that read one old range
// are adjacent block indices (the range comes from device memory about
// once, from the L2 r - 1 times), and many small independent CTAs hide each
// other's load, claim and store phases (on an H100 a CTA that loops over
// its range's tiles was slower at r = 2 and 4, and so were tiles of 1024
// or 4096 slots).  Bound: bytes, the old table read once (8 B a slot) and
// the new one written once (8 B a slot).
//
// Migrate into as many or fewer slots, or into fewer than kTile:
// fill_kernel writes the new table's EMPTY / 0 slots and clears *error,
// then migrate_slot_kernel takes one thread an old slot whose ticket is
// nonzero: it claims a new slot by atomicCAS on the ticket word (0 -> t)
// and then writes the key.  The keys of a table are distinct, so a slot
// whose ticket word is taken belongs to another key, and the thread walks
// on.  A probe is bounded at C2 slots; a key not placed in them sets
// *error (only possible when C2 is below the live count, which a grow
// never asks for).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

using hash_probe::kEmpty;
using hash_probe::slot_hash;

constexpr int kThreads = 256;         // probe, fill, slot and overflow kernels
constexpr int kProbeRows = 4;         // rows a thread of lookup_probe_kernel
constexpr int kLargeSlots = 1 << 23;  // from here (64 MB, past the L2) one row a thread
constexpr int kSharedThreads = 1024;  // lookup_shared_kernel
constexpr int kSharedRows = 4;        // rows a thread a step of lookup_shared_kernel
constexpr int kMaxSharedSlots = 1 << 14;  // 128 KB of (key, ticket) pairs
constexpr int kTile = 2048;           // new slots a CTA of migrate_tiled_kernel (16 KB)
constexpr int kTileThreads = 256;
constexpr int kTileLoads = kTile / kTileThreads;  // old slots a thread of the range
constexpr unsigned kNone = 0xFFFFFFFFu;

constexpr int kLookupShared = 0;      // table_lookup_launch's mode 0 (1: the probe path)
constexpr int kMigrateSlot = 0;       // table_migrate_launch's mode 0 (1: the tiles)

__device__ __forceinline__ void load_rows(const int* __restrict__ keys, long long n,
                                          long long base, int (&key)[kSharedRows]) {
#pragma unroll
  for (int r = 0; r < kSharedRows; ++r) {
    const long long i = base + r * kSharedThreads;
    key[r] = i < n ? __ldg(keys + i) : kEmpty;
  }
}

__global__ void __launch_bounds__(kSharedThreads)
    lookup_shared_kernel(const int* __restrict__ keys, long long n,
                         const int* __restrict__ tkeys, const int* __restrict__ ttks, int C,
                         int* __restrict__ out) {
  extern __shared__ int2 s_tab[];  // (key, ticket) of every slot
  for (int j = threadIdx.x; j < C; j += kSharedThreads) {
    __pipeline_memcpy_async(&s_tab[j].x, tkeys + j, sizeof(int));
    __pipeline_memcpy_async(&s_tab[j].y, ttks + j, sizeof(int));
  }
  __pipeline_commit();
  const unsigned mask = static_cast<unsigned>(C - 1);
  const long long step = static_cast<long long>(gridDim.x) * kSharedThreads * kSharedRows;
  long long base = static_cast<long long>(blockIdx.x) * kSharedThreads * kSharedRows +
                   threadIdx.x;
  int key[kSharedRows];
  load_rows(keys, n, base, key);  // the first rows' keys land while the table does
  __pipeline_wait_prior(0);
  __syncthreads();
  for (; base < n; base += step) {
    int next[kSharedRows];
    load_rows(keys, n, base + step, next);  // the next step's keys in flight meanwhile
#pragma unroll
    for (int r = 0; r < kSharedRows; ++r) {
      int t = -1;
      if (key[r] != kEmpty) {
        unsigned slot = slot_hash(key[r], mask);
        for (int probe = 0; probe < C; ++probe) {
          const int2 e = s_tab[slot];
          if (e.y == 0) break;  // an empty slot: the key is absent
          if (e.x == key[r]) {
            t = e.y - 1;
            break;
          }
          slot = (slot + 1) & mask;
        }
      }
      const long long i = base + r * kSharedThreads;
      if (i < n) out[i] = t;
      key[r] = next[r];
    }
  }
}

template <int kProbeRows>
__global__ void __launch_bounds__(kThreads)
    lookup_probe_kernel(const int* __restrict__ keys, long long n,
                        const int* __restrict__ tkeys, const int* __restrict__ ttks, int C,
                        int* __restrict__ out) {
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kProbeRows + threadIdx.x;
  const unsigned mask = static_cast<unsigned>(C - 1);
  int key[kProbeRows], tick[kProbeRows], held[kProbeRows];
  unsigned slot[kProbeRows];
#pragma unroll
  for (int r = 0; r < kProbeRows; ++r) {
    const long long i = base + r * kThreads;
    key[r] = i < n ? __ldg(keys + i) : kEmpty;
  }
  // every row's home slot, both words, before any compare
#pragma unroll
  for (int r = 0; r < kProbeRows; ++r) {
    slot[r] = slot_hash(key[r], mask);
    tick[r] = 0;
    held[r] = kEmpty;
    if (key[r] != kEmpty) {
      tick[r] = __ldg(ttks + slot[r]);
      held[r] = __ldg(tkeys + slot[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kProbeRows; ++r) {
    int t = -1;
    if (key[r] != kEmpty && tick[r] != 0) {
      if (held[r] == key[r]) {
        t = tick[r] - 1;
      } else {  // walk on from the second slot
        unsigned s = slot[r];
        for (int probe = 1; probe < C; ++probe) {
          s = (s + 1) & mask;
          const int tk = __ldg(ttks + s);
          const int k = __ldg(tkeys + s);
          if (tk == 0) break;
          if (k == key[r]) {
            t = tk - 1;
            break;
          }
        }
      }
    }
    const long long i = base + r * kThreads;
    if (i < n) out[i] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
    fill_kernel(int* __restrict__ nkeys, int* __restrict__ ntks, long long C2,
                int* __restrict__ error) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i == 0) *error = 0;
  if (i >= C2) return;
  nkeys[i] = kEmpty;
  ntks[i] = 0;
}

// Claim a slot for (key, t) from its home in a table of C2 slots, ticket
// word first; *error set when C2 probes find none.
__device__ __forceinline__ void place_global(int key, int t, int* nkeys, int* ntks, int C2,
                                             int* error) {
  const unsigned mask = static_cast<unsigned>(C2 - 1);
  unsigned slot = slot_hash(key, mask);
  for (int probe = 0; probe < C2; ++probe) {
    if (atomicCAS(ntks + slot, 0, t) == 0) {
      nkeys[slot] = key;
      return;
    }
    slot = (slot + 1) & mask;
  }
  atomicExch(error, 1);  // not placed in C2 slots
}

__global__ void __launch_bounds__(kThreads)
    migrate_slot_kernel(const int* __restrict__ tkeys, const int* __restrict__ ttks, long long C,
                        int* nkeys, int* ntks, int C2, int* error) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= C) return;
  const int t = ttks[i];
  if (t <= 0) return;  // a free slot
  place_global(tkeys[i], t, nkeys, ntks, C2, error);
}

// Place (key, t) in the tile [T0, T0 + kTile) from its offset `from`
// there on: linear probing by atomicCAS on the shared ticket words, the
// overflow list past the tile's end.
__device__ __forceinline__ void place_tile(int key, int t, unsigned from, unsigned old_slot,
                                           int* s_key, int* s_tk, int* ovf_count, int* ovf) {
  for (unsigned j = from; j < static_cast<unsigned>(kTile); ++j) {
    if (atomicCAS(s_tk + j, 0, t) == 0) {
      s_key[j] = key;
      return;
    }
  }
  ovf[atomicAdd(ovf_count, 1)] = static_cast<int>(old_slot);
}

// aux[1] counts the overflow list `ovf`; the launcher zeroes aux first.
__global__ void __launch_bounds__(kTileThreads)
    migrate_tiled_kernel(const int* __restrict__ tkeys, const int* __restrict__ ttks, int C,
                         int* __restrict__ nkeys, int* __restrict__ ntks, int C2, int* aux,
                         int* ovf) {
  __shared__ __align__(16) int s_key[kTile];
  __shared__ __align__(16) int s_tk[kTile];
  const unsigned mask = static_cast<unsigned>(C - 1), mask2 = static_cast<unsigned>(C2 - 1);
  const unsigned b = blockIdx.x;
  unsigned tile, a;
  int span;  // old homes of the tile: [a, a + span)
  if (kTile <= C) {  // the r = C2 / C tiles of one old range are adjacent blocks
    const unsigned r = static_cast<unsigned>(C2 / C);
    tile = (b % r) * static_cast<unsigned>(C / kTile) + b / r;
    a = (b / r) * kTile;
    span = kTile;
  } else {  // every tile's keys come from the whole old table
    tile = b;
    a = 0;
    span = C;
  }
  const unsigned T0 = tile * kTile;
  // the old range, every load in flight at once, and warp 0 the first 32
  // slots past it (the tail), while the tile is cleared
  int t[kTileLoads], k[kTileLoads];
#pragma unroll
  for (int u = 0; u < kTileLoads; ++u) {
    const int j = threadIdx.x + u * kTileThreads;
    const unsigned s = (a + j) & mask;
    t[u] = j < span ? __ldg(ttks + s) : 0;
    k[u] = j < span ? __ldg(tkeys + s) : kEmpty;
  }
  const int lane = threadIdx.x;
  int tt = 0, kk = kEmpty;
  if (threadIdx.x < 32 && span + lane < C) {
    tt = __ldg(ttks + ((a + span + lane) & mask));
    kk = __ldg(tkeys + ((a + span + lane) & mask));
  }
  int4* sk4 = reinterpret_cast<int4*>(s_key);
  int4* st4 = reinterpret_cast<int4*>(s_tk);
  for (int j = threadIdx.x; j < kTile / 4; j += kTileThreads) {
    sk4[j] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    st4[j] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  // every key of the tile claims its home with a plain store of its ticket;
  // tickets are distinct, so after the barrier the key whose ticket stayed
  // owns the slot, and only the others probe on with atomicCAS
  unsigned off[kTileLoads];
#pragma unroll
  for (int u = 0; u < kTileLoads; ++u) {
    off[u] = t[u] > 0 ? slot_hash(k[u], mask2) - T0 : kNone;
    if (off[u] < static_cast<unsigned>(kTile)) s_tk[off[u]] = t[u];
  }
  __syncthreads();
  int* ovf_count = aux + 1;
#pragma unroll
  for (int u = 0; u < kTileLoads; ++u) {
    if (off[u] >= static_cast<unsigned>(kTile)) continue;  // another tile's key, or none
    if (s_tk[off[u]] == t[u]) {
      s_key[off[u]] = k[u];
    } else {
      place_tile(k[u], t[u], off[u] + 1, (a + threadIdx.x + u * kTileThreads) & mask, s_key,
                 s_tk, ovf_count, ovf);
    }
  }
  if (threadIdx.x < 32) {  // the tail: up to the first free slot past the range
    for (int j0 = span; j0 < C; j0 += 32) {
      const int j = j0 + lane;
      const unsigned s = (a + j) & mask;
      if (j0 > span) {  // past the first 32 slots: rare at a load of 1/2
        tt = j < C ? __ldg(ttks + s) : 0;
        kk = j < C ? __ldg(tkeys + s) : kEmpty;
      }
      const unsigned free = __ballot_sync(0xFFFFFFFFu, j < C && tt == 0);
      const int stop = free ? __ffs(free) - 1 : 32;
      if (lane < stop && j < C && tt > 0) {
        const unsigned o = slot_hash(kk, mask2) - T0;
        if (o < static_cast<unsigned>(kTile)) place_tile(kk, tt, o, s, s_key, s_tk, ovf_count, ovf);
      }
      if (free) break;
    }
  }
  __syncthreads();
  int4* nk4 = reinterpret_cast<int4*>(nkeys + T0);
  int4* nt4 = reinterpret_cast<int4*>(ntks + T0);
  for (int j = threadIdx.x; j < kTile / 4; j += kTileThreads) {
    nk4[j] = sk4[j];
    nt4[j] = st4[j];
  }
}

// The keys the tiles could not hold, from their old slots, by the atomicCAS
// walk from their home in the whole new table (a grid-stride loop over the
// list, whose length only the card knows).
__global__ void __launch_bounds__(kThreads)
    migrate_overflow_kernel(const int* __restrict__ tkeys, const int* __restrict__ ttks,
                            int* nkeys, int* ntks, int C2, int* aux, const int* ovf) {
  const int count = aux[1];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < count; i += gridDim.x * kThreads) {
    const int s = ovf[i];
    place_global(tkeys[s], ttks[s], nkeys, ntks, C2, aux);
  }
}

unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 132;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// The 0-based tickets of n keys in a table of C slots (C a power of two)
// into out (n int32), -1 for EMPTY and absent keys, on `stream`.  mode:
// 0 the shared-memory path (C <= table_ops_max_shared_slots()), 1 the
// probe path.  Returns a cudaError_t as an int (0 = launched); the caller
// checks shapes, types and devices.
int table_lookup_launch(const void* keys, long long n, const void* tkeys, const void* ttks,
                        int C, void* out, int mode, void* stream) {
  if (n < 0 || C < 1 || (C & (C - 1)) != 0 || mode < 0 || mode > 1 ||
      (mode == kLookupShared && C > kMaxSharedSlots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(keys);
  const int* tk = static_cast<const int*>(tkeys);
  const int* tt = static_cast<const int*>(ttks);
  int* o = static_cast<int*>(out);
  if (mode == kLookupShared) {
    const size_t smem = sizeof(int2) * static_cast<size_t>(C);
    static bool opted_in[64] = {};  // by device
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64 || !opted_in[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          lookup_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(sizeof(int2) * kMaxSharedSlots));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev >= 0 && dev < 64) opted_in[dev] = true;
    }
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lookup_shared_kernel, kSharedThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long want = (n + kSharedThreads * kSharedRows - 1) / (kSharedThreads * kSharedRows);
    const long long most = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
    lookup_shared_kernel<<<static_cast<unsigned>(want < most ? want : most), kSharedThreads,
                           smem, s>>>(k, n, tk, tt, C, o);
  } else if (C < kLargeSlots) {
    lookup_probe_kernel<kProbeRows>
        <<<blocks_for(n, kThreads * kProbeRows), kThreads, 0, s>>>(k, n, tk, tt, C, o);
  } else {
    lookup_probe_kernel<1><<<blocks_for(n, kThreads), kThreads, 0, s>>>(k, n, tk, tt, C, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// Relocate every (key, ticket) pair of a table of C slots into nkeys /
// ntks (C2 int32 each, C2 a power of two, written whole: the caller
// allocates them without filling), on `stream`.  aux holds two int32:
// aux[0] (the error flag) ends 1 when a key found no slot in C2 probes,
// else 0; aux[1] is scratch.  mode 0: the fill and one thread an old slot
// (any C2); mode 1: the tiles and their overflow (C2 > C, C2 >=
// table_ops_tile_slots(), nkeys / ntks 16-B aligned), ovf scratch of C
// int32.  Returns a cudaError_t as an int (0 = launched); the caller
// checks shapes, types and devices.
int table_migrate_launch(const void* tkeys, const void* ttks, long long C, void* nkeys,
                         void* ntks, int C2, void* aux, void* ovf, int mode, void* stream) {
  if (C < 1 || (C & (C - 1)) != 0 || C2 < 1 || (C2 & (C2 - 1)) != 0 || mode < 0 || mode > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tk = static_cast<const int*>(tkeys);
  const int* tt = static_cast<const int*>(ttks);
  int* nk = static_cast<int*>(nkeys);
  int* nt = static_cast<int*>(ntks);
  int* a = static_cast<int*>(aux);
  if (mode == kMigrateSlot) {
    fill_kernel<<<blocks_for(C2, kThreads), kThreads, 0, s>>>(nk, nt, C2, a);
    migrate_slot_kernel<<<blocks_for(C, kThreads), kThreads, 0, s>>>(tk, tt, C, nk, nt, C2, a);
    return static_cast<int>(cudaGetLastError());
  }
  if (C2 <= C || C2 < kTile || ovf == nullptr || !aligned16(nkeys) || !aligned16(ntks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(a, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  migrate_tiled_kernel<<<static_cast<unsigned>(C2 / kTile), kTileThreads, 0, s>>>(
      tk, tt, static_cast<int>(C), nk, nt, C2, a, static_cast<int*>(ovf));
  const long long most = 2LL * sm_count();
  const long long want = blocks_for(C, kThreads);
  migrate_overflow_kernel<<<static_cast<unsigned>(want < most ? want : most), kThreads, 0, s>>>(
      tk, tt, nk, nt, C2, a, static_cast<const int*>(ovf));
  return static_cast<int>(cudaGetLastError());
}

int table_ops_tile_slots() { return kTile; }

int table_ops_max_shared_slots() { return kMaxSharedSlots; }

const char* table_ops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
