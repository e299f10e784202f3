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
// lookup_kernel: one thread a row.  A row walks from its home slot and
// stops at its key (hit: ticket - 1), at a slot whose ticket is 0 (the key
// is absent) or after C slots (an absent key on a full table), exactly as
// the plain version's rounds do, so its output equals the plain version's
// bit for bit.  Nothing writes the table during the launch.  Bound: bytes,
// the keys read and the tickets written once (8 B a row) and a slot (8 B)
// for each distinct present key.
//
// migrate_kernel: one thread an old slot whose ticket is nonzero.  It
// claims a new slot by atomicCAS on the ticket word (0 -> t) and then
// writes the key.  The keys of a table are distinct, so no thread ever
// looks for its own key: a slot whose ticket word is taken belongs to
// another key, and the thread walks on.  No thread waits and no key is
// compared.  A probe is bounded at C' slots; a key not placed in them sets
// *error (only possible when C' is below the live count, which a grow
// never asks for).  fill_kernel writes the new table's EMPTY / 0 slots and
// clears *error first, on the same stream, so one launcher call is the
// whole migration.  Bound: bytes, the old table read once (8 B a slot) and
// the new one written once (8 B a slot).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

using hash_probe::kEmpty;
using hash_probe::slot_hash;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lookup_kernel(const int* __restrict__ keys, long long n, const int* __restrict__ tkeys,
                  const int* __restrict__ ttks, int C, int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  int t = -1;
  if (key != kEmpty) {
    const unsigned mask = static_cast<unsigned>(C - 1);
    unsigned slot = slot_hash(key, mask);
    for (int probe = 0; probe < C; ++probe) {
      const int tick = ttks[slot];
      if (tick == 0) break;  // an empty slot: the key is absent
      if (tkeys[slot] == key) {
        t = tick - 1;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }
  out[i] = t;
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

__global__ void __launch_bounds__(kThreads)
    migrate_kernel(const int* __restrict__ tkeys, const int* __restrict__ ttks, long long C,
                   int* nkeys, int* ntks, int C2, int* error) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= C) return;
  const int t = ttks[i];
  if (t <= 0) return;  // a free slot
  const int key = tkeys[i];
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

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The 0-based tickets of n keys in a table of C slots (C a power of two)
// into out (n int32), -1 for EMPTY and absent keys, on `stream`.  Returns a
// cudaError_t as an int (0 = launched); the caller checks shapes, types
// and devices.
int table_lookup_launch(const void* keys, long long n, const void* tkeys, const void* ttks,
                        int C, void* out, void* stream) {
  if (n < 0 || C < 1 || (C & (C - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  lookup_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n, static_cast<const int*>(tkeys),
      static_cast<const int*>(ttks), C, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Relocate every (key, ticket) pair of a table of C slots into nkeys /
// ntks (C2 int32 each, C2 a power of two, written whole: the caller
// allocates them without filling), on `stream`.  *error (one int32) ends
// 1 when a key found no slot in C2 probes, else 0.  Returns a cudaError_t
// as an int (0 = launched); the caller checks shapes, types and devices.
int table_migrate_launch(const void* tkeys, const void* ttks, long long C, void* nkeys,
                         void* ntks, int C2, void* error, void* stream) {
  if (C < 1 || C2 < 1 || (C2 & (C2 - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_kernel<<<blocks_for(C2), kThreads, 0, s>>>(static_cast<int*>(nkeys),
                                                  static_cast<int*>(ntks), C2,
                                                  static_cast<int*>(error));
  migrate_kernel<<<blocks_for(C), kThreads, 0, s>>>(
      static_cast<const int*>(tkeys), static_cast<const int*>(ttks), C,
      static_cast<int*>(nkeys), static_cast<int*>(ntks), C2, static_cast<int*>(error));
  return static_cast<int>(cudaGetLastError());
}

const char* table_ops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
