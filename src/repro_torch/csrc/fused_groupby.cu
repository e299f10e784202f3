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
// Ticket-only mode (`scan_ticket_launch`, the kTicketOnly instantiation):
// the ticket stage of the scan route (ExecutionPolicy.kernel "off" /
// "scan_body").  Its reference is no Pallas kernel but plain jnp under
// jax.lax.scan (src/repro/engine/groupby.py:144, make_pause_scan_body's
// get_or_insert); on the card it is this kernel's morsel loop with S = 0
// accumulator planes, P = 1 and no fold table, that writes each row's
// 0-based ticket for the morsels this launch commits and -1 for every
// other row (padding, morsels skipped or paused, a morsel that saturated
// under `checked` even though some of its keys were inserted).  Rows need
// no shared memory here, so a morsel may have any number of rows.  The
// fused instantiation compiles as before: every ticket-only branch is an
// `if constexpr`.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

using hash_probe::kEmpty;
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

template <bool kTicketOnly>
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
    int* __restrict__ out_tickets,     // ticket-only: (P*npm, M) 0-based or -1
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

  if constexpr (!kTicketOnly) {
    for (int h = tid; h < H; h += nthreads) {
      s_hkey[h] = 0;
      for (int s = 0; s < specs.n; ++s) s_hacc[s * H + h] = neutral(specs.kind[s]);
    }
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
    if (st == kSkip || st == kPause) {
      if constexpr (kTicketOnly) {
        for (int r = tid; r < M; r += nthreads) out_tickets[row0 + r] = -1;
      }
      continue;
    }

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
      if constexpr (kTicketOnly) {
        out_tickets[row0 + r] = ticket - 1;
      } else {
        s_ticket[r] = ticket;
      }
    }
    const int sat = __syncthreads_or(unresolved);
    if (tid == 0 && st == kRunReserved) atomicSub(sc + kReserved, M - s_issued);
    if (sat) ++n_saturations;
    if (checked && sat) {  // inserts stay, updates dropped, still todo
      if constexpr (kTicketOnly) {
        for (int r = tid; r < M; r += nthreads) out_tickets[row0 + r] = -1;
      }
      continue;
    }

    // -- phase 2: fold the committed morsel through the shared table ------
    ++n_morsels;
#pragma unroll
    for (int j = 0; j < kThreadSums; ++j) sums[j] += mine[j];
    if constexpr (!kTicketOnly) {
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
    }  // !kTicketOnly
    if (tid == 0) ptodo[i] = 0;  // committed
    __syncthreads();
    if constexpr (!kTicketOnly) {
      if (s_entries > H / 2) flush_folds(s_hkey, s_hacc, &s_entries, H, specs, accs, P, p, G);
    }
  }
  if constexpr (!kTicketOnly) flush_folds(s_hkey, s_hacc, &s_entries, H, specs, accs, P, p, G);

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

// Launch one pass of the kernel on `stream` with `threads` threads a CTA:
// the fused pass (kTicketOnly false, 1..kMaxSpecs accumulator planes) or
// the ticket-only pass (no planes, `out_tickets` written).  `scratch` is
// (P, 4) int32: zeros, with column 3 (reserved) holding count.  grid_out
// gets (CTAs, CTAs per program).  Returns a cudaError_t (cudaSuccess =
// launched).  The caller checks shapes, types and devices.
template <bool kTicketOnly>
cudaError_t launch(const void* keys, const void* values, void* todo, void* tkeys, void* ttks,
                   void* kbt, void* accs, void* count, void* events, void* info,
                   void* scratch, void* out_tickets, const int* spec_planes,
                   const int* spec_kinds, int num_specs, int P, int npm, int M, int C, int G,
                   int checked, int grow_bound, int threshold, int bound_slack,
                   int collect_events, int threads, int* grid_out, void* stream) {
  const bool specs_ok = kTicketOnly ? num_specs == 0 && out_tickets != nullptr
                                    : num_specs >= 1 && num_specs <= kMaxSpecs;
  if (!specs_ok || P < 1 || M < 1 || C < 1 || (C & (C - 1)) != 0 || npm < 0 ||
      threads < 32 || threads > 1024 || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  Specs specs;
  specs.n = num_specs;
  for (int s = 0; s < kMaxSpecs; ++s) {
    specs.plane[s] = s < num_specs ? spec_planes[s] : -1;
    specs.kind[s] = s < num_specs ? spec_kinds[s] : kSum;
  }
  // the fold table: a power of two of slots, S + 1 ints each; the
  // ticket-only pass keeps neither it nor a ticket per row in shared memory
  int H = 0;
  size_t smem = 0;
  if (!kTicketOnly) {
    H = kMaxFoldSlots;
    while (H > 32 && static_cast<size_t>(H) * (num_specs + 1) * 4 > kFoldBytes) H /= 2;
    smem = (static_cast<size_t>(M) + static_cast<size_t>(H) * (num_specs + 1)) * sizeof(int);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_groupby_kernel<kTicketOnly>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_groupby_kernel<kTicketOnly>, threads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int cpp = sms * per_sm / P;
  if (cpp > npm) cpp = npm;
  if (cpp < 1) cpp = 1;
  grid_out[0] = P * cpp;
  grid_out[1] = cpp;
  fused_groupby_kernel<kTicketOnly>
      <<<P * cpp, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(keys), static_cast<const float*>(values),
          static_cast<int*>(todo), static_cast<int*>(tkeys), static_cast<int*>(ttks),
          static_cast<int*>(kbt), static_cast<float*>(accs), static_cast<int*>(count),
          static_cast<int*>(events), static_cast<int*>(info), static_cast<int*>(scratch),
          static_cast<int*>(out_tickets), specs, P, cpp, npm, M, C, G, H, checked,
          grow_bound, threshold, bound_slack, collect_events);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One fused GROUP BY pass (launch<false>).  Returns cudaGetLastError() as
// an int (0 = launched).
int fused_groupby_launch(const void* keys, const void* values, void* todo,
                         void* tkeys, void* ttks, void* kbt, void* accs,
                         void* count, void* events, void* info, void* scratch,
                         const int* spec_planes, const int* spec_kinds,
                         int num_specs, int P, int npm, int M, int C, int G,
                         int checked, int grow_bound, int threshold,
                         int bound_slack, int collect_events, int threads,
                         int* grid_out, void* stream) {
  return static_cast<int>(launch<false>(
      keys, values, todo, tkeys, ttks, kbt, accs, count, events, info, scratch, nullptr,
      spec_planes, spec_kinds, num_specs, P, npm, M, C, G, checked, grow_bound, threshold,
      bound_slack, collect_events, threads, grid_out, stream));
}

// One ticket-only pass of the scan route (launch<true>) over npm morsels of
// M rows against one table: `out_tickets` (npm, M) gets each row's 0-based
// ticket for the morsels this launch commits and -1 for every other row.
// Returns cudaGetLastError() as an int (0 = launched).
int scan_ticket_launch(const void* keys, void* todo, void* tkeys, void* ttks, void* kbt,
                       void* count, void* events, void* info, void* scratch,
                       void* out_tickets, int npm, int M, int C, int G, int checked,
                       int grow_bound, int threshold, int bound_slack, int collect_events,
                       int threads, int* grid_out, void* stream) {
  return static_cast<int>(launch<true>(
      keys, nullptr, todo, tkeys, ttks, kbt, nullptr, count, events, info, scratch,
      out_tickets, nullptr, nullptr, 0, 1, npm, M, C, G, checked, grow_bound, threshold,
      bound_slack, collect_events, threads, grid_out, stream));
}

const char* fused_groupby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
