// Fused GROUP BY kernel for Hopper (sm_90a): ticketing and aggregate
// update of one morselized chunk against a table carried across chunks.
//
// Replaces: src/repro/kernels/fused_groupby.py, `fused_consume` →
// `_fused_kernel` (the Pallas TPU kernel of ExecutionPolicy.kernel="fused").
//
// What it computes, per program p (one local table per program) and per
// morsel i of p whose todo flag is set:
//   1. the §4.4 room check: with `checked`, a morsel pauses BEFORE it
//      tickets anything when the live count[p] > threshold, or, under
//      `grow_bound`, when its reservation of M tickets does not fit
//      (below); a paused morsel stays todo;
//   2. GET_OR_INSERT of every row (csrc/hash_probe.cuh, paper Algorithm 1)
//      into p's table, at device scope; at most C slots are probed, and a
//      row still unresolved marks the morsel saturated;
//   3. with `checked`, a saturated morsel commits no update and stays todo
//      (its inserts stay: replay takes the lookup path);
//   4. otherwise the morsel commits: every resolved row with a ticket
//      <= G folds into the S accumulator planes (sum / count add, min / max
//      as sign-split integer atomics) and the morsel's todo flag is cleared;
//   5. committed-morsel event counts (morsels, rows, masked rows, probe
//      steps, probe-length histogram), saturated morsels, and one pause per
//      program whose launch left a morsel todo.
// The last CTA of program p to finish writes info[p]: count, the lowest
// morsel still todo (NO_HALT if none), the saturation flag, halted.
//
// Bound on this card: it moves bytes and does almost no arithmetic.  The
// least traffic is the keys and value planes read once plus the table
// slots, key_by_ticket entries and accumulators the chunk touches, each
// read and written once, over 3.35 TB/s.  Probing is a chain of dependent
// loads and atomics, so the kernel is latency bound unless many rows are
// in flight at once, and same-address atomics serialise on hot keys.
//
// Design.  The first version of this kernel ran one CTA per program,
// walking the program's morsels in order with CTA-scope atomics: exact
// "first halted morsel", but one SM of 132 at P = 1.  Now persistent CTAs
// fill the card (SMs × the occupancy the block size and shared memory
// allow), split evenly across programs; the CTAs of program p take
// morsels from a device-scope counter (morsel-driven dispatch) and share
// p's table through the device-scope protocol of hash_probe.cuh.  Morsels
// no longer run in order, so the kernel reports per-morsel commit flags
// (`todo`, cleared in place) and the host replays only the morsels left
// todo.
//   * Room check: the load threshold reads the live count, so under RAISE
//     a pause still means the table holds more than threshold >= G groups.
//     The bound uses a reservation: reserved[p] starts the launch at
//     count[p]; a morsel moves it from r_old to r_old + M, and runs only if
//     r_old <= bound_slack (= G - M in the executor), returning the M minus
//     the tickets it issued when done.  With one CTA this is the sequential
//     rule count > bound_slack; with many, no ticket past G is ever issued
//     under GROW.  A reservation that does not fit waits while the count
//     is <= bound_slack (the running morsels return their unused tickets)
//     and pauses once it is past, so a launch pauses only when the count
//     has crossed a threshold, as with one CTA.
//   * Equal tickets fold before the device atomic: each CTA keeps a small
//     hash table in shared memory keyed by ticket, with S accumulators per
//     slot, and folds committed rows into it with shared atomics.  It is
//     flushed to the device accumulators (one atomic per slot and plane)
//     when more than half full and when the CTA ends, so a hot key costs
//     one device atomic per CTA-flush instead of one per row.  A row whose
//     ticket finds no slot within kLocalProbes folds at device scope.
//
// scan_ticket_kernel (`scan_ticket_launch`): the ticket stage of the scan
// route (ExecutionPolicy.kernel "off" / "scan_body").  Its reference is no
// Pallas kernel but plain jnp under jax.lax.scan
// (src/repro/engine/groupby.py:144, make_pause_scan_body's get_or_insert).
// It runs steps 1-3 above with P = 1 and no accumulator planes against the
// carried table, and writes each row's 0-based ticket for the morsels the
// launch commits and -1 for every other row (padding, morsels skipped or
// paused, every row of a morsel that saturated under `checked` even though
// some of its keys were inserted, and, unchecked, a row not placed in C
// probes).  The last CTA writes info and sets the table's sticky overflow
// flag when the count passed G.  A morsel may have any number of rows.
//
// Its bound: bytes.  The keys read and the tickets written once (8 B a
// row), and per distinct key its slot (key and ticket) and key_by_ticket
// entry written once; the table is carried, so nothing is filled.
//
// Its design is the ticket kernel's tile protocol (hash_probe.cuh) under
// the fused kernel's morsel dispatch:
//   * Dispatch and room check as above: persistent CTAs take morsels from
//     the device-scope counter; count > threshold pauses, and under
//     grow_bound a morsel runs only on its reservation of M tickets.
//   * Inside a morsel, tiles of T × kScanRows rows (a ragged last tile).
//   * Dedupe: a direct-mapped cache of (key, ticket) words in shared memory
//     (dedupe_role: one leader per key, followers read its ticket).  It
//     lives for the CTA's whole launch, across its morsels: a claimed
//     slot's key and ticket never change within a launch, and each launch
//     starts with an empty cache, so a migration between launches cannot
//     leave a stale entry.  A hot key, or a small key set, costs one table
//     access per CTA, not one per row on the same few L2 lines.
//   * Phase A, claim without waiting: the CASes of a thread's rows on
//     their home slots, then the ticket loads of the rows whose CAS met
//     their key, each batch in flight together.  A CAS claims an empty
//     slot or returns the key that holds it, so a row needs no key load
//     first: on a table past the L2 (unique keys) that load misses, and a
//     CAS after it costs a second dependent round trip.  A row whose slot
//     holds another key probes on (a load, and a CAS where the slot is
//     empty), never waiting.  The carried table keeps two int32 arrays,
//     so a found key costs a second load (its slot's ticket word); the
//     ticket kernel's 64-bit slot words would save it (ROADMAP.md, the
//     fused kernel's second-round item).
//   * One count atomic per tile (claim_tickets): tickets stay gap-free and
//     the count may pass G.  Winners write key_by_ticket[t-1] for t <= G
//     and publish t with a relaxed store.
//   * Phase B: pending rows wait with relaxed loads; then followers read
//     their leader's ticket from the cache.
// Memory order: ticket_hash.cu's argument.  A waiter reads only the ticket
// word of a slot whose key it saw (a claimed key never changes); only the
// slot's winner writes that word, once, so a nonzero ticket is final;
// key_by_ticket and the tickets are read only after the kernel.
// Saturation: a row not placed within C probes marks its morsel saturated;
// under `checked` every row of that morsel gets -1 (earlier tiles too) and
// it stays todo, while its inserts stay in the table.  Its leader caches -1
// for its followers: within a launch the table only fills.
// Events: as the fused kernel's, except that a row answered from the cache
// or by its leader counts one probe step (histogram bucket 0), so the
// histogram sums to the rows but probe steps differ from the plain
// version's claim rounds (EVT_PROBE_STEPS is not compared exactly).
// Deadlock freedom, ticket_hash.cu's argument extended to dispatch: a CTA
// waits in phase B only on claims that another CTA made in its phase A and
// publishes before its own phase B, after a scan and one atomicAdd that
// wait on nothing outside that CTA.  A CTA waits in reserve() only at
// dispatch, after it has published every claim of its previous morsel, and
// the running morsels it waits for end by the same argument.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

using namespace hash_probe;  // the table protocol and the tile protocol
constexpr int kInfoLen = 4;  // count, lowest todo morsel, saturation, halted
constexpr int kNoHalt = 0x7FFFFFFF;
constexpr int kEvtPauses = 5, kNumEvents = 6;
constexpr int kHistBuckets = 8;  // edges 2, 3, 4, 5, 9, 17, 33
constexpr int kEventVecLen = kNumEvents + kHistBuckets;
constexpr int kThreadSums = 3 + kHistBuckets;  // rows, masked, steps, hist
constexpr int kMaxSpecs = 16;
constexpr int kSum = 0, kCount = 1, kMin = 2, kMax = 3;
// per-program launch scratch: morsel counter, finished CTAs, saturation
// flag, reserved tickets
constexpr int kScratch = 4, kNext = 0, kDone = 1, kSatFlag = 2, kReserved = 3;
// dispatch outcome of one morsel
constexpr int kSkip = 0, kRun = 1, kRunReserved = 2, kPause = 3, kEnd = 4;
// the shared fold table: bytes for keys + accumulators, slots probed
constexpr int kFoldBytes = 40 * 1024;
constexpr int kMaxFoldSlots = 2048;
constexpr int kLocalProbes = 32;
// scan_ticket_kernel: rows per thread per tile, and the per-CTA (key,
// ticket) cache (32 KB)
constexpr int kScanRows = 4;
constexpr int kCacheSlots = 4096;

struct Specs {
  int n;
  int plane[kMaxSpecs];  // value plane, or -1 (count reads none)
  int kind[kMaxSpecs];
};

__device__ __forceinline__ float neutral(int kind) {
  return kind == kMin ? __int_as_float(0x7f800000)
                      : kind == kMax ? __int_as_float(0xff800000) : 0.0f;
}

__device__ __forceinline__ void fold(float* a, int kind, float v) {
  switch (kind) {
    case kSum:
    case kCount: atomicAdd(a, v); break;
    case kMin: hash_probe::atomic_min_f32(a, v); break;
    default: hash_probe::atomic_max_f32(a, v); break;
  }
}

// Flush the CTA's fold table into the device accumulators of program p
// and empty it.  Called by every thread of the CTA.
__device__ __forceinline__ void flush_folds(int* s_hkey, float* s_hacc, int* s_entries, int H,
                            const Specs& specs, float* accs, int P, int p, int G) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const int t = s_hkey[h];
    if (t == 0) continue;
    for (int s = 0; s < specs.n; ++s) {
      float* a = accs + (static_cast<size_t>(s) * P + p) * G + (t - 1);
      fold(a, specs.kind[s], s_hacc[s * H + h]);
      s_hacc[s * H + h] = neutral(specs.kind[s]);
    }
    s_hkey[h] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) *s_entries = 0;
  __syncthreads();
}

// The bound's room check: reserve M tickets of program p's bound, i.e.
// move *reserved from r to r + M while r <= bound_slack.  While the live
// count is still <= bound_slack, a reservation that does not fit waits for
// the running morsels to return what they did not use (they hold no other
// resource, so they finish); once the count itself is past bound_slack
// the morsel pauses, the sequential rule count > bound_slack.  True when
// reserved.
__device__ __forceinline__ bool reserve(int* reserved, const int* count, int M, int bound_slack) {
  long long spins = 0;
  for (;;) {
    const int r = hash_probe::ld_relaxed_gpu(reserved);
    if (r <= bound_slack) {
      if (atomicCAS(reserved, r, r + M) == r) return true;
      continue;
    }
    if (hash_probe::ld_relaxed_gpu(count) > bound_slack) return false;
    if (++spins > hash_probe::kSpinLimit) __trap();
    __nanosleep(128);
  }
}

__global__ void __launch_bounds__(1024) fused_groupby_kernel(
    const int* __restrict__ keys,      // (P*npm, M)
    const float* __restrict__ values,  // (V, P*npm, M)
    int* todo,                         // (P*npm,) 1 = still to commit
    int* tkeys,                        // (P, C)
    int* ttks,                         // (P, C)
    int* kbt,                          // (P, G)
    float* accs,                       // (S, P, G)
    int* count,                        // (P,)
    int* events,                       // (P, kEventVecLen)
    int* __restrict__ info,            // (P, kInfoLen)
    int* scratch,                      // (P, kScratch)
    Specs specs, int P, int cpp, int npm, int M, int C, int G, int H,
    int checked, int grow_bound, int threshold, int bound_slack,
    int collect_events) {
  extern __shared__ int smem[];
  int* s_ticket = smem;                                  // (M,) 1-based, 0 none
  int* s_hkey = smem + M;                                // (H,) ticket, 0 free
  float* s_hacc = reinterpret_cast<float*>(s_hkey + H);  // (S, H)
  __shared__ int s_i, s_state, s_issued, s_entries, s_flag;
  __shared__ int s_ev[kThreadSums];

  const int p = blockIdx.x / cpp;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  int* tk = tkeys + static_cast<size_t>(p) * C;
  int* tt = ttks + static_cast<size_t>(p) * C;
  int* kb = kbt + static_cast<size_t>(p) * G;
  int* sc = scratch + p * kScratch;
  int* ptodo = todo + static_cast<size_t>(p) * npm;
  const size_t plane_rows = static_cast<size_t>(P) * npm * M;

  for (int h = tid; h < H; h += nthreads) {
    s_hkey[h] = 0;
    for (int s = 0; s < specs.n; ++s) s_hacc[s * H + h] = neutral(specs.kind[s]);
  }
  if (tid == 0) s_entries = 0;
  if (tid < kThreadSums) s_ev[tid] = 0;
  __syncthreads();

  // per-thread committed counts, reduced once at the end
  int sums[kThreadSums];
#pragma unroll
  for (int j = 0; j < kThreadSums; ++j) sums[j] = 0;
  // CTA-uniform counts
  int n_morsels = 0, n_saturations = 0;

  for (;;) {
    // -- dispatch: the next morsel of program p, and its room check -------
    if (tid == 0) {
      const int i = atomicAdd(sc + kNext, 1);
      int st = kSkip;
      if (i >= npm) {
        st = kEnd;
      } else if (ptodo[i] != 0) {
        st = kRun;
        if (checked) {
          if (hash_probe::ld_relaxed_gpu(count + p) > threshold) {
            st = kPause;
          } else if (grow_bound) {
            st = reserve(sc + kReserved, count + p, M, bound_slack) ? kRunReserved : kPause;
          }
        }
      }
      s_i = i;
      s_state = st;
      s_issued = 0;
    }
    __syncthreads();
    const int i = s_i, st = s_state;
    __syncthreads();  // every thread read s_i / s_state before the next write
    if (st == kEnd) break;
    const size_t row0 = (static_cast<size_t>(p) * npm + i) * M;
    if (st == kSkip || st == kPause) continue;

    // -- phase 1: ticket every row of the morsel ------------------------
    int unresolved = 0;
    int mine[kThreadSums];
#pragma unroll
    for (int j = 0; j < kThreadSums; ++j) mine[j] = 0;
    for (int r = tid; r < M; r += nthreads) {
      const int key = keys[row0 + r];
      int ticket = 0;
      if (key == kEmpty) {
        ++mine[1];
      } else {
        int plen = 0;
        ticket = hash_probe::get_or_insert(key, tk, tt, kb, count + p, C, G, &plen,
                                           &s_issued);
        if (ticket == 0) unresolved = 1;
        ++mine[0];
        mine[2] += plen;
        const int bucket = (plen >= 2) + (plen >= 3) + (plen >= 4) + (plen >= 5) +
                           (plen >= 9) + (plen >= 17) + (plen >= 33);
#pragma unroll
        for (int b = 0; b < kHistBuckets; ++b) mine[3 + b] += (bucket == b);
      }
      s_ticket[r] = ticket;
    }
    const int sat = __syncthreads_or(unresolved);
    if (tid == 0 && st == kRunReserved) atomicSub(sc + kReserved, M - s_issued);
    if (sat) ++n_saturations;
    if (checked && sat) continue;  // inserts stay, updates dropped, still todo

    // -- phase 2: fold the committed morsel through the shared table ------
    ++n_morsels;
#pragma unroll
    for (int j = 0; j < kThreadSums; ++j) sums[j] += mine[j];
    for (int r = tid; r < M; r += nthreads) {
      const int t = s_ticket[r];
      if (t <= 0 || t > G) continue;  // masked, unresolved, or past the bound
      int slot = -1;
      int h = t & (H - 1);
      for (int q = 0; q < kLocalProbes; ++q) {
        int k = *static_cast<volatile int*>(s_hkey + h);
        if (k == 0) {
          k = atomicCAS_block(s_hkey + h, 0, t);
          if (k == 0) {
            atomicAdd_block(&s_entries, 1);
            slot = h;
            break;
          }
        }
        if (k == t) {
          slot = h;
          break;
        }
        h = (h + 1) & (H - 1);
      }
      for (int s = 0; s < specs.n; ++s) {
        const int plane = specs.plane[s];
        const float v = plane < 0 ? 1.0f : values[plane * plane_rows + row0 + r];
        float* a = slot >= 0 ? s_hacc + s * H + slot
                             : accs + (static_cast<size_t>(s) * P + p) * G + (t - 1);
        fold(a, specs.kind[s], v);
      }
    }
    if (tid == 0) ptodo[i] = 0;  // committed
    __syncthreads();
    if (s_entries > H / 2) flush_folds(s_hkey, s_hacc, &s_entries, H, specs, accs, P, p, G);
  }
  flush_folds(s_hkey, s_hacc, &s_entries, H, specs, accs, P, p, G);

  if (collect_events) {
    const int lane = tid & 31;
#pragma unroll
    for (int j = 0; j < kThreadSums; ++j) {
      const int w = __reduce_add_sync(0xffffffffu, sums[j]);
      if (lane == 0 && w != 0) atomicAdd_block(&s_ev[j], w);
    }
    __syncthreads();
    if (tid == 0) {
      int* ev = events + static_cast<size_t>(p) * kEventVecLen;
      // morsels, rows, masked rows, probe steps, saturations, pauses, hist
      const int add[kEventVecLen] = {n_morsels, s_ev[0], s_ev[1], s_ev[2], n_saturations,
                                     0, s_ev[3], s_ev[4], s_ev[5], s_ev[6],
                                     s_ev[7], s_ev[8], s_ev[9], s_ev[10]};
#pragma unroll
      for (int j = 0; j < kEventVecLen; ++j) {
        if (add[j] != 0) atomicAdd(ev + j, add[j]);
      }
    }
  }
  if (tid == 0 && n_saturations > 0) atomicExch(sc + kSatFlag, 1);

  // -- the last CTA of program p writes info[p] -------------------------
  __threadfence();
  __syncthreads();
  if (tid == 0) s_flag = atomicAdd(sc + kDone, 1) == cpp - 1;
  __syncthreads();
  if (!s_flag) return;
  __threadfence();
  if (tid == 0) s_i = kNoHalt;
  __syncthreads();
  for (int j = tid; j < npm; j += nthreads) {
    if (hash_probe::ld_relaxed_gpu(ptodo + j) != 0) {
      atomicMin_block(&s_i, j);
      break;  // j grows: the first todo this thread finds is its lowest
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int low = s_i;
    const int halted = low != kNoHalt;
    int* inf = info + static_cast<size_t>(p) * kInfoLen;
    inf[0] = hash_probe::ld_relaxed_gpu(count + p);
    inf[1] = low;
    inf[2] = hash_probe::ld_relaxed_gpu(sc + kSatFlag);
    inf[3] = halted;
    if (collect_events && halted) {
      atomicAdd(events + static_cast<size_t>(p) * kEventVecLen + kEvtPauses, 1);
    }
  }
}

// Probe on from the slot after *slot, until C slots were probed in all;
// never waits.  Returns the row's outcome (kNone: the table is full); *plen
// gets the slots probed.
__device__ int probe_on(int key, unsigned* slot, int* tick, int* tkeys, const int* ttks,
                        unsigned mask, int C, int* plen) {
  for (int probe = 1; probe < C; ++probe) {
    *slot = (*slot + 1) & mask;
    int k = ld_relaxed_gpu(tkeys + *slot);
    if (k == kEmpty) {
      k = atomicCAS(tkeys + *slot, kEmpty, key);
      if (k == kEmpty) {
        *plen = probe + 1;
        return kWon;
      }
    }
    if (k == key) {
      *plen = probe + 1;
      *tick = ld_relaxed_gpu(ttks + *slot);
      return *tick != 0 ? kFound : kPending;
    }
  }
  *plen = C;
  return kNone;
}

// scan_ticket_kernel: the scan route's ticket stage (see the file comment).
// Persistent CTAs of T threads take morsels from the device-scope counter,
// as the fused kernel's do, and ticket each morsel in tiles of T × kScanRows
// rows by the tile protocol of hash_probe.cuh, against the carried table's
// two int32 arrays.
template <int T>
__global__ void __launch_bounds__(T) scan_ticket_kernel(
    const int* __restrict__ keys,   // (npm, M)
    int* todo,                      // (npm,) 1 = still to commit
    int* tkeys,                     // (C,) EMPTY where free
    int* ttks,                      // (C,) 1-based, 0 until published
    int* __restrict__ kbt,          // (G,)
    int* count,                     // (1,)
    int* events,                    // (kEventVecLen,), or null
    int* __restrict__ info,         // (kInfoLen,)
    int* scratch,                   // (kScratch,)
    int* __restrict__ out_tickets,  // (npm, M) 0-based or -1
    unsigned char* overflowed,      // () bool, sticky
    int npm, int M, int C, int G, int checked, int grow_bound, int threshold,
    int bound_slack, int collect_events) {
  constexpr int R = kScanRows;
  __shared__ unsigned long long s_cache[kCacheSlots];
  __shared__ int s_warp[T / 32];
  __shared__ int s_base, s_i, s_state, s_issued, s_flag;
  // the morsel's counts (rows, masked, steps, hist), and the committed ones
  __shared__ int s_mev[kThreadSums], s_ev[kThreadSums];

  const int tid = threadIdx.x;
  const unsigned mask = static_cast<unsigned>(C - 1);
  for (int h = tid; h < kCacheSlots; h += T) s_cache[h] = kFreeSlot;
  if (tid < kThreadSums) s_ev[tid] = s_mev[tid] = 0;
  int n_morsels = 0, n_saturations = 0;  // CTA-uniform

  for (;;) {
    // -- dispatch: the next morsel and its room check (as the fused kernel)
    if (tid == 0) {
      const int i = atomicAdd(scratch + kNext, 1);
      int st = kSkip;
      if (i >= npm) {
        st = kEnd;
      } else if (todo[i] != 0) {
        st = kRun;
        if (checked) {
          if (ld_relaxed_gpu(count) > threshold) {
            st = kPause;
          } else if (grow_bound) {
            st = reserve(scratch + kReserved, count, M, bound_slack) ? kRunReserved : kPause;
          }
        }
      }
      s_i = i;
      s_state = st;
      s_issued = 0;
    }
    __syncthreads();
    const int i = s_i, st = s_state;
    __syncthreads();  // every thread read s_i / s_state before the next write
    if (st == kEnd) break;
    int* out = out_tickets + static_cast<size_t>(i) * M;
    if (st == kSkip || st == kPause) {
      for (int r = tid; r < M; r += T) out[r] = -1;
      continue;
    }
    const int* in = keys + static_cast<size_t>(i) * M;

    int unresolved = 0;
    int mine[kThreadSums];
#pragma unroll
    for (int j = 0; j < kThreadSums; ++j) mine[j] = 0;
    for (int base = 0; base < M; base += T * R) {
      int key[R], tick[R], state[R], role[R], plen[R], seen[R];
      unsigned hash[R], slot[R];
      bool touch[R], match[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = base + j * T + tid;
        key[j] = r < M ? in[r] : kEmpty;
      }

      // -- dedupe through the CTA's cache ---------------------------------
#pragma unroll
      for (int j = 0; j < R; ++j) {
        state[j] = kNone;
        tick[j] = 0;
        role[j] = kSolo;
        plen[j] = 1;
        hash[j] = slot[j] = 0;
        if (key[j] == kEmpty) continue;
        hash[j] = slot_hash(key[j], kFull);
        slot[j] = hash[j] & mask;
        role[j] = dedupe_role(s_cache + (hash[j] & (kCacheSlots - 1)), key[j], &tick[j]);
        if (role[j] == kCached) state[j] = kFound;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {  // rows that touch the table: leaders and solos
        touch[j] = key[j] != kEmpty && (role[j] == kLead || role[j] == kSolo);
      }

      // -- phase A: claim without waiting ---------------------------------
#pragma unroll
      for (int j = 0; j < R; ++j) {  // the CASes, all in flight: claim, or see the key
        seen[j] = touch[j] ? atomicCAS(tkeys + slot[j], kEmpty, key[j]) : kEmpty;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {  // the ticket loads of found keys, all in flight
        if (touch[j] && seen[j] == kEmpty) state[j] = kWon;
        match[j] = touch[j] && seen[j] == key[j];
        if (match[j]) tick[j] = ld_relaxed_gpu(ttks + slot[j]);
      }
      int won = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (match[j]) {
          state[j] = tick[j] != 0 ? kFound : kPending;
        } else if (touch[j] && state[j] != kWon) {  // another key: probe on
          state[j] = probe_on(key[j], &slot[j], &tick[j], tkeys, ttks, mask, C, &plen[j]);
        }
        won += state[j] == kWon;
      }

      // -- one count atomic per tile; publish -----------------------------
      int next = claim_tickets<T>(won, count, s_warp, &s_base, &s_issued);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (state[j] == kWon) {
          const int t = next++;
          if (t <= G) kbt[t - 1] = key[j];
          st_relaxed_gpu(ttks + slot[j], t);
          tick[j] = t;
        }
        if (role[j] == kLead && (state[j] == kWon || state[j] == kFound)) {
          s_cache[hash[j] & (kCacheSlots - 1)] = pack(key[j], tick[j]);
        }
      }
      __syncthreads();  // this CTA's tickets are published

      // -- phase B: pending rows wait; then followers read their leader ----
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!touch[j]) continue;
        if (state[j] == kPending) {
          long long spins = 0;
          int t;
          while ((t = ld_relaxed_gpu(ttks + slot[j])) == 0) {
            if (++spins > kSpinLimit) __trap();
            __nanosleep(32);
          }
          tick[j] = t;
          state[j] = kFound;
          if (role[j] == kLead) s_cache[hash[j] & (kCacheSlots - 1)] = pack(key[j], t);
        } else if (state[j] == kNone && role[j] == kLead) {
          // not placed in C probes: its followers get -1 too
          s_cache[hash[j] & (kCacheSlots - 1)] = pack(key[j], -1);
        }
      }
      __syncthreads();  // every leader's ticket is in the cache
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = base + j * T + tid;
        if (r >= M) continue;
        if (key[j] == kEmpty) {
          ++mine[1];
          out[r] = -1;
          continue;
        }
        if (role[j] == kFollow) {
          const unsigned long long c = s_cache[hash[j] & (kCacheSlots - 1)];
          if (key_of(c) != key[j] || ticket_of(c) == 0) __trap();  // broken protocol
          tick[j] = ticket_of(c);
          state[j] = tick[j] > 0 ? kFound : kNone;
        }
        out[r] = state[j] == kNone ? -1 : tick[j] - 1;
        unresolved |= state[j] == kNone;
        ++mine[0];
        mine[2] += plen[j];
        const int bucket = (plen[j] >= 2) + (plen[j] >= 3) + (plen[j] >= 4) + (plen[j] >= 5) +
                           (plen[j] >= 9) + (plen[j] >= 17) + (plen[j] >= 33);
#pragma unroll
        for (int b = 0; b < kHistBuckets; ++b) mine[3 + b] += (bucket == b);
      }
      __syncthreads();  // followers read the cache before the next dedupe
    }

    if (collect_events) {
#pragma unroll
      for (int j = 0; j < kThreadSums; ++j) {
        const int w = __reduce_add_sync(kFull, mine[j]);
        if ((tid & 31) == 0 && w != 0) atomicAdd_block(&s_mev[j], w);
      }
    }
    const int sat = __syncthreads_or(unresolved);
    const bool commit = !(checked && sat);
    if (tid == 0) {
      if (st == kRunReserved) atomicSub(scratch + kReserved, M - s_issued);
      for (int j = 0; j < kThreadSums; ++j) {  // committed-morsel counts
        if (commit) s_ev[j] += s_mev[j];
        s_mev[j] = 0;
      }
    }
    if (sat) ++n_saturations;
    if (!commit) {  // inserts stay, every row -1 (earlier tiles too), still todo
      for (int r = tid; r < M; r += T) out[r] = -1;
      continue;
    }
    ++n_morsels;
    if (tid == 0) todo[i] = 0;  // committed
  }

  if (collect_events && tid == 0) {
    // morsels, rows, masked rows, probe steps, saturations, pauses, hist
    const int add[kEventVecLen] = {n_morsels, s_ev[0], s_ev[1], s_ev[2], n_saturations,
                                   0, s_ev[3], s_ev[4], s_ev[5], s_ev[6],
                                   s_ev[7], s_ev[8], s_ev[9], s_ev[10]};
#pragma unroll
    for (int j = 0; j < kEventVecLen; ++j) {
      if (add[j] != 0) atomicAdd(events + j, add[j]);
    }
  }
  if (tid == 0 && n_saturations > 0) atomicExch(scratch + kSatFlag, 1);

  // -- the last CTA writes info and the sticky overflow flag ---------------
  __threadfence();
  __syncthreads();
  if (tid == 0) s_flag = atomicAdd(scratch + kDone, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!s_flag) return;
  __threadfence();
  if (tid == 0) s_i = kNoHalt;
  __syncthreads();
  for (int j = tid; j < npm; j += T) {
    if (ld_relaxed_gpu(todo + j) != 0) {
      atomicMin_block(&s_i, j);
      break;  // j grows: the first todo this thread finds is its lowest
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int low = s_i;
    const int halted = low != kNoHalt;
    const int n = ld_relaxed_gpu(count);
    info[0] = n;
    info[1] = low;
    info[2] = ld_relaxed_gpu(scratch + kSatFlag);
    info[3] = halted;
    if (n > G) *overflowed = 1;
    if (collect_events && halted) atomicAdd(events + kEvtPauses, 1);
  }
}

// The launch scratch of scan_ticket_kernel: morsel counter, finished CTAs
// and saturation flag 0, the reservation at the count.
__global__ void scan_fill_kernel(int* scratch, const int* count) {
  if (threadIdx.x < kScratch) scratch[threadIdx.x] = threadIdx.x == kReserved ? *count : 0;
}

template <int T>
cudaError_t scan_occupancy(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, scan_ticket_kernel<T>, T, 0);
}

// The device's SM count and the resident CTAs per SM of scan_ticket_kernel
// at each block size, queried once per device and block size.
constexpr int kScanBlocks[3] = {256, 512, 1024};

cudaError_t scan_limits(int threads, int* sms, int* per_sm) {
  static int cached_sms[64], cached_per_sm[64][3];
  int b = 0;
  while (b < 3 && kScanBlocks[b] != threads) ++b;
  int dev = 0;
  cudaError_t err = b < 3 ? cudaGetDevice(&dev) : cudaErrorInvalidValue;
  if (err == cudaSuccess && dev >= 64) err = cudaErrorInvalidDevice;
  if (err != cudaSuccess) return err;
  if (cached_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && cached_per_sm[dev][b] == 0) {
    err = b == 0   ? scan_occupancy<256>(&cached_per_sm[dev][b])
          : b == 1 ? scan_occupancy<512>(&cached_per_sm[dev][b])
                   : scan_occupancy<1024>(&cached_per_sm[dev][b]);
  }
  if (err != cudaSuccess) return err;
  if (cached_per_sm[dev][b] < 1) return cudaErrorInvalidConfiguration;
  *sms = cached_sms[dev];
  *per_sm = cached_per_sm[dev][b];
  return cudaSuccess;
}

// Launch the fused pass on `stream` with `threads` threads a CTA (1..
// kMaxSpecs accumulator planes).  `scratch` is (P, 4) int32: zeros, with
// column 3 (reserved) holding count.  grid_out gets (CTAs, CTAs per
// program).  Returns a cudaError_t (cudaSuccess = launched).  The caller
// checks shapes, types and devices.
cudaError_t launch(const void* keys, const void* values, void* todo, void* tkeys, void* ttks,
                   void* kbt, void* accs, void* count, void* events, void* info,
                   void* scratch, const int* spec_planes, const int* spec_kinds,
                   int num_specs, int P, int npm, int M, int C, int G, int checked,
                   int grow_bound, int threshold, int bound_slack, int collect_events,
                   int threads, int* grid_out, void* stream) {
  if (num_specs < 1 || num_specs > kMaxSpecs || P < 1 || M < 1 || C < 1 || (C & (C - 1)) != 0 ||
      npm < 0 || threads < 32 || threads > 1024 || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  Specs specs;
  specs.n = num_specs;
  for (int s = 0; s < kMaxSpecs; ++s) {
    specs.plane[s] = s < num_specs ? spec_planes[s] : -1;
    specs.kind[s] = s < num_specs ? spec_kinds[s] : kSum;
  }
  // the fold table: a power of two of slots, S + 1 ints each
  int H = kMaxFoldSlots;
  while (H > 32 && static_cast<size_t>(H) * (num_specs + 1) * 4 > kFoldBytes) H /= 2;
  const size_t smem =
      (static_cast<size_t>(M) + static_cast<size_t>(H) * (num_specs + 1)) * sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_groupby_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_groupby_kernel, threads,
                                                        smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int cpp = sms * per_sm / P;
  if (cpp > npm) cpp = npm;
  if (cpp < 1) cpp = 1;
  grid_out[0] = P * cpp;
  grid_out[1] = cpp;
  fused_groupby_kernel<<<P * cpp, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const float*>(values), static_cast<int*>(todo),
      static_cast<int*>(tkeys), static_cast<int*>(ttks), static_cast<int*>(kbt),
      static_cast<float*>(accs), static_cast<int*>(count), static_cast<int*>(events),
      static_cast<int*>(info), static_cast<int*>(scratch), specs, P, cpp, npm, M, C, G, H,
      checked, grow_bound, threshold, bound_slack, collect_events);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One fused GROUP BY pass.  Returns cudaGetLastError() as an int (0 =
// launched).
int fused_groupby_launch(const void* keys, const void* values, void* todo,
                         void* tkeys, void* ttks, void* kbt, void* accs,
                         void* count, void* events, void* info, void* scratch,
                         const int* spec_planes, const int* spec_kinds,
                         int num_specs, int P, int npm, int M, int C, int G,
                         int checked, int grow_bound, int threshold,
                         int bound_slack, int collect_events, int threads,
                         int* grid_out, void* stream) {
  return static_cast<int>(launch(
      keys, values, todo, tkeys, ttks, kbt, accs, count, events, info, scratch, spec_planes,
      spec_kinds, num_specs, P, npm, M, C, G, checked, grow_bound, threshold, bound_slack,
      collect_events, threads, grid_out, stream));
}

// One ticket-stage pass of the scan route over npm >= 1 morsels of M rows
// against one carried table, on `stream`: scan_fill_kernel writes the
// launch scratch (kScratch int32), then scan_ticket_kernel runs on
// `threads` (256, 512 or 1024) threads a CTA.  `out_tickets` (npm, M) gets
// each row's 0-based ticket for the morsels this launch commits and -1 for
// every other row; `info` (kInfoLen int32) the control signals;
// `overflowed` (one bool byte) is set when the count passes G; `events`
// (may be null unless collect_events) gains the committed-morsel counts.
// grid_out gets (CTAs, CTAs).  Returns a cudaError_t as an int (0 =
// launched).  The caller checks shapes, types and devices.
int scan_ticket_launch(const void* keys, void* todo, void* tkeys, void* ttks, void* kbt,
                       void* count, void* events, void* info, void* scratch,
                       void* out_tickets, void* overflowed, int npm, int M, int C, int G,
                       int checked, int grow_bound, int threshold, int bound_slack,
                       int collect_events, int threads, int* grid_out, void* stream) {
  if (npm < 1 || M < 1 || C < 1 || (C & (C - 1)) != 0 || G < 0 || info == nullptr ||
      scratch == nullptr || out_tickets == nullptr || overflowed == nullptr ||
      (collect_events && events == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = scan_limits(threads, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = sms * per_sm < npm ? sms * per_sm : npm;
  grid_out[0] = grid_out[1] = ctas;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scan_fill_kernel<<<1, 32, 0, s>>>(static_cast<int*>(scratch), static_cast<const int*>(count));
#define SCAN_TICKET_ARGS                                                                   \
  static_cast<const int*>(keys), static_cast<int*>(todo), static_cast<int*>(tkeys),        \
      static_cast<int*>(ttks), static_cast<int*>(kbt), static_cast<int*>(count),           \
      static_cast<int*>(events), static_cast<int*>(info), static_cast<int*>(scratch),      \
      static_cast<int*>(out_tickets), static_cast<unsigned char*>(overflowed), npm, M, C, G, \
      checked, grow_bound, threshold, bound_slack, collect_events
  if (threads == 256) {
    scan_ticket_kernel<256><<<ctas, 256, 0, s>>>(SCAN_TICKET_ARGS);
  } else if (threads == 512) {
    scan_ticket_kernel<512><<<ctas, 512, 0, s>>>(SCAN_TICKET_ARGS);
  } else {
    scan_ticket_kernel<1024><<<ctas, 1024, 0, s>>>(SCAN_TICKET_ARGS);
  }
#undef SCAN_TICKET_ARGS
  return static_cast<int>(cudaGetLastError());
}

const char* fused_groupby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
