// GET_OR_INSERT ticketing kernel for Hopper (sm_90a): one key column
// against one table that the wrapper makes fresh for the call.
//
// Replaces: src/repro/kernels/ticket_hash.py, `ticket_hash_pallas` →
// `_ticket_kernel` (the Pallas TPU kernel of ExecutionPolicy.kernel="split").
//
// What it computes, for every row r of the column:
//   tickets[r] = the 0-based ticket of keys[r], or -1 for EMPTY padding and
//   for a row the full table could not place.  Folklore* (paper
//   Algorithm 1): read the slot's key; claim an empty slot with
//   atomicCAS(EMPTY -> key); the winner takes ticket atomicAdd(count) + 1,
//   writes key_by_ticket[t-1] when t <= G (the reference drops the write
//   past the bound) and publishes t with a release store; a thread that
//   meets its own key with ticket 0 spins on an acquire load until the
//   ticket is published.  At most C slots are probed (one wrap).
// Tickets are gap-free: one count increment per CAS winner, so count may
// exceed G (the caller's overflow check relies on it).
//
// Bound on this card: bytes.  The least traffic is the keys read and the
// tickets written once (8 B a row) plus, per distinct key, its slot read
// and written and its key_by_ticket entry written, over 3.35 TB/s.
//
// Design: unlike the TPU's sequential grid, nothing here depends on the
// order of morsels except the ticket numbering, so a grid-stride loop over
// rows runs on enough CTAs to fill the card.  The table is in global
// memory and shared by every CTA, so claims and the count use device-scope
// atomics and the publish / wait pair is release / acquire at GPU scope
// (CTA scope, as in fused_groupby.cu, would be wrong here).  The CAS
// winners of a warp that are converged take their tickets with one
// atomicAdd (a warp-aggregated range claim: the fuzzy ticketer).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kEmpty = -1;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
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

__global__ void __launch_bounds__(kThreads) ticket_hash_kernel(
    const int* __restrict__ keys,  // (N,)
    int* __restrict__ tickets,     // (N,) out, 0-based, -1 unresolved
    int* __restrict__ tkeys,       // (C,) EMPTY-filled by the wrapper
    int* __restrict__ ttks,        // (C,) zero-filled
    int* __restrict__ kbt,         // (G,) EMPTY-filled
    int* __restrict__ count,       // (1,) zero
    long long n, int C, int G) {
  const unsigned mask = static_cast<unsigned>(C - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const int key = keys[r];
    int ticket = 0;
    if (key != kEmpty) {
      unsigned slot = slot_hash(key, mask);
      for (int probe = 0; probe < C; ++probe) {
        int k = ld_relaxed_gpu(tkeys + slot);
        if (k == kEmpty) {
          const int prev = atomicCAS(tkeys + slot, kEmpty, key);
          if (prev == kEmpty) {
            cg::coalesced_group winners = cg::coalesced_threads();
            int base = 0;
            if (winners.thread_rank() == 0) base = atomicAdd(count, static_cast<int>(winners.size()));
            base = winners.shfl(base, 0);
            const int t = base + static_cast<int>(winners.thread_rank()) + 1;
            if (t <= G) kbt[t - 1] = key;
            st_release_gpu(ttks + slot, t);
            ticket = t;
            break;
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
          ticket = t;
          break;
        }
        slot = (slot + 1) & mask;
      }
    }
    tickets[r] = ticket - 1;  // 0 (EMPTY or unresolved) -> -1
  }
}

}  // namespace

extern "C" {

// Launch one ticketing pass on `stream`.  Returns cudaGetLastError() as an
// int (0 = launched).  The caller allocates and fills the table, checks
// shapes, types and devices.
int ticket_hash_launch(const void* keys, void* tickets, void* tkeys, void* ttks,
                       void* kbt, void* count, long long n, int C, int G,
                       void* stream) {
  if (n < 0 || C < 1 || (C & (C - 1)) != 0 || G < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  ticket_hash_kernel<<<static_cast<int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<int*>(tickets),
      static_cast<int*>(tkeys), static_cast<int*>(ttks), static_cast<int*>(kbt),
      static_cast<int*>(count), n, C, G);
  return static_cast<int>(cudaGetLastError());
}

const char* ticket_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
