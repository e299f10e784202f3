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
// (csrc/hash_probe.cuh, shared with fused_groupby.cu).  The CAS winners
// of a warp that are converged take their tickets with one atomicAdd (a
// warp-aggregated range claim: the fuzzy ticketer).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

using hash_probe::kEmpty;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads) ticket_hash_kernel(
    const int* __restrict__ keys,  // (N,)
    int* __restrict__ tickets,     // (N,) out, 0-based, -1 unresolved
    int* __restrict__ tkeys,       // (C,) EMPTY-filled by the wrapper
    int* __restrict__ ttks,        // (C,) zero-filled
    int* __restrict__ kbt,         // (G,) EMPTY-filled
    int* __restrict__ count,       // (1,) zero
    long long n, int C, int G) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const int key = keys[r];
    int ticket = 0, plen = 0;
    if (key != kEmpty) {
      ticket = hash_probe::get_or_insert(key, tkeys, ttks, kbt, count, C, G, &plen,
                                         nullptr);
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
