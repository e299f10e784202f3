// Row segment sum (kernel B5) for Hopper (sm_90a): add whole float32 rows
// into the rows of a dense (G, d) output named by their tickets.
//
// Replaces: src/repro/models/layers.py:150-154, `jax.ops.segment_sum` in
// `_ticketed_embed_bwd` (no Pallas kernel there: XLA's scatter-add on the
// TPU).  It is step 2 of the embedding gradient's GROUP BY token_id
// SUM(cotangent): the ticket kernel has numbered the token ids, this sums
// the cotangent rows in ticket space, and one index_add_ lands the sums in
// the (vocab, d) table.
//
// What it computes: out[t] = the sum of rows[r] over the rows r whose
// ticket t = tickets[r] lies in [0, G), and 0 for a ticket no row names;
// rows with t < 0 or t >= G are dropped (the reference sends them to a
// segment it drops).  rows (R, d) float32, tickets (R,) int32, out (G, d)
// float32.  The kernel writes every element of `out` once, so the caller
// allocates it without zeroing it.  A ticket's rows are added in an order
// that shared-memory atomics and shuffles set, so the result agrees with an
// ordered sum to float32 rounding, not bit for bit.
//
// Why one kernel: the segment kernel (segment_agg.cu) folds one (G,) plane
// a launch, so d = 1024 columns would take 1024 launches a training step.
//
// Bound on this card: bytes.  The least traffic is the rows and tickets
// read once and the G × d sums written once: at R = 1024, d = 1024 and
// G = 1024 (qwen3-0.6b, 8 × 128 tokens) 8 MiB, ≈ 0.0025 ms at 3.35 TB/s.
//
// Design: one launch; each sum is added up in the registers of the one
// thread that owns it and stored once.  A CTA owns a slice of W columns
// (Q = W / 4 float4s) and a range of `span` tickets (at most kSpan); each
// thread owns kOut float4 sums of that range, warp w the tickets
// t ≡ w (mod kWarps), so that the first-seen (most frequent) tickets fall
// in different warps.  The CTA takes the rows kChunk at a time:
//   1. stage: each thread reads kPer tickets (coalesced; from the L2 after
//      the first CTA; the next round's a round early) and loads the W
//      columns of each row whose ticket lies in the range, kLoads 16-byte
//      loads in flight; a ticket outside the range (or outside [0, G))
//      skips its row before any load.  It counts each kept row in its
//      ticket's bin with a shared-memory integer atomicAdd (native on this
//      card), whose result is the row's rank among its ticket's rows;
//   2. sort: an exclusive scan of the bins gives each ticket's start, and
//      each kept row's slice goes to `staged` at start + rank, so a
//      ticket's rows lie together;
//   3. sum: each owner adds its ticket's first staged row (all owners'
//      loads in flight together) and then up to kShort more; the rows of a
//      hotter ticket are added by the owner's whole warp, a row a lane
//      group, and reduced by shuffles, so a hot ticket costs its warp about
//      its rows / (32 / Q) loads.
// At the end every thread stores its sums, zeros where no row came, so the
// output is written whole, once, with no zeroing pass, no float atomic (on
// this card a shared-memory float atomicAdd is a compare-and-swap loop,
// ATOMS.CAST.SPIN, and a hot ticket's rows would spin on it) and no L2
// atomic.  At the training shape (d 1024, G 1024) the launcher takes W = 8:
// one ticket range, one round, 128 CTAs, one wave, each row's 32-byte
// slice one sector.  Where G passes kSpan the CTAs take (slice, range)
// pairs; each scans every ticket and keeps the rows of its range, so each
// row's slice is still read once in all; a round that keeps no row of the
// CTA's range is skipped.
//
// Two paths, chosen by the launcher's `vec` (the wrapper decides): where
// d % 4 == 0 and rows and out are 16-byte aligned, a row's columns are
// loaded and stored 16 bytes at a time; else 4 bytes at a time, masked at
// the last slice's edge.  Both stage, sort and sum the same way.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 8;     // float4 sums a thread owns
constexpr int kLoads = 8;   // 16-byte row loads a thread has in flight a round
constexpr int kShort = 32;  // a sum of more rows is added by its whole warp

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The W columns from c0 of one row as W / 4 float4s (masked at the row's end on the
// 4-byte path).
template <int W, bool VEC>
__device__ __forceinline__ void load_slice(const float* src, int c0, int d, float4* v) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const int c = c0 + 4 * q;
    if constexpr (VEC) {
      v[q] = c < d ? __ldg(reinterpret_cast<const float4*>(src + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      v[q] = make_float4(c < d ? __ldg(src + c) : 0.f, c + 1 < d ? __ldg(src + c + 1) : 0.f,
                         c + 2 < d ? __ldg(src + c + 2) : 0.f,
                         c + 3 < d ? __ldg(src + c + 3) : 0.f);
    }
  }
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int mask) {
  return make_float4(__shfl_xor_sync(~0u, v.x, mask), __shfl_xor_sync(~0u, v.y, mask),
                     __shfl_xor_sync(~0u, v.z, mask), __shfl_xor_sync(~0u, v.w, mask));
}

template <bool VEC>
__device__ __forceinline__ void store4(float* dst, int c, int d, float4 v) {
  if constexpr (VEC) {
    if (c < d) *reinterpret_cast<float4*>(dst + c) = v;
  } else {
    if (c < d) dst[c] = v.x;
    if (c + 1 < d) dst[c + 1] = v.y;
    if (c + 2 < d) dst[c + 2] = v.z;
    if (c + 3 < d) dst[c + 3] = v.w;
  }
}

template <int W, bool VEC>
__global__ void __launch_bounds__(kThreads)
segment_rows_kernel(const float* __restrict__ rows, const int* __restrict__ tickets,
                    float* __restrict__ out, long long R, int d, int G, int slices,
                    int span) {
  constexpr int Q = W / 4;                    // float4s a row slice
  constexpr int kPer = kLoads / Q;            // rows a thread stages a round
  constexpr int kChunk = kThreads * kPer;     // rows a round
  constexpr int kSpan = kThreads * kOut / Q;  // tickets a CTA owns, at most
  constexpr int kBins = kSpan / kThreads;     // bins a thread scans
  constexpr int kGroups = 32 / Q;             // row groups of a warp (Q lanes each)
  __shared__ float4 staged[kChunk * Q];       // the round's kept row slices, by ticket
  __shared__ int count[kSpan];                // a ticket's kept rows this round
  __shared__ int start[kSpan];                // where they begin in `staged`
  __shared__ int warp_total[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, q = tid % Q;
  const int c0 = (blockIdx.x % slices) * W;
  const int g0 = (blockIdx.x / slices) * span;
  const int gn = min(span, G - g0);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // This thread's sums: float4 q of ticket own(j), so that warp w owns the tickets
  // t ≡ w (mod kWarps) and the first-seen (most frequent) tickets fall in different warps
  const auto own = [&](int j) { return (j * kGroups + lane / Q) * kWarps + warp; };
  float4 acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = zero;
  for (int i = tid; i < gn; i += kThreads) count[i] = 0;
  int ahead[kPer];  // the next round's tickets, loaded a round early
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    ahead[k] = k * kThreads + tid < R ? __ldg(tickets + k * kThreads + tid) : -1;
  }

  for (long long base = 0; base < R; base += kChunk) {
    // 1. stage and count
    int lt[kPer];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      lt[k] = ahead[k] >= g0 && ahead[k] < g0 + gn ? ahead[k] - g0 : -1;
      any |= lt[k] >= 0;
      const long long r = base + kChunk + k * kThreads + tid;
      ahead[k] = r < R ? __ldg(tickets + r) : -1;
    }
    float4 v[kPer][Q];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (lt[k] >= 0) load_slice<W, VEC>(rows + (base + k * kThreads + tid) * d, c0, d, v[k]);
    }
    if (!__syncthreads_or(any)) continue;  // the bins are zero; no row of this round is kept
    int rank[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) rank[k] = lt[k] >= 0 ? atomicAdd(count + lt[k], 1) : 0;
    __syncthreads();
    // 2. sort: exclusive scan of the bins, kBins a thread, then the slices to start + rank
    int bins[kBins], sum = 0;
#pragma unroll
    for (int i = 0; i < kBins; ++i) {
      const int b = tid * kBins + i;
      bins[i] = b < gn ? count[b] : 0;
      sum += bins[i];
    }
    int inclusive = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(~0u, inclusive, off);
      if (lane >= off) inclusive += y;
    }
    if (lane == 31) warp_total[warp] = inclusive;
    __syncthreads();
    int at = inclusive - sum;
    for (int w = 0; w < warp; ++w) at += warp_total[w];
#pragma unroll
    for (int i = 0; i < kBins; ++i) {
      const int b = tid * kBins + i;
      if (b < gn) start[b] = at;
      at += bins[i];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (lt[k] >= 0) {
        float4* dst = staged + (start[lt[k]] + rank[k]) * Q;
#pragma unroll
        for (int i = 0; i < Q; ++i) dst[i] = v[k][i];
      }
    }
    __syncthreads();
    // 3. sum: every sum's first row, all loads in flight together; up to kShort rows more
    // by the owner; the rows of a hotter ticket by its whole warp, a row a lane group,
    // reduced by shuffles
    int first[kOut], n[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int t = own(j);
      first[j] = t < gn ? start[t] : 0;
      n[j] = t < gn ? count[t] : 0;
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      if (n[j] > 0) acc[j] = add4(acc[j], staged[first[j] * Q + q]);
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      if (n[j] > 1 && n[j] <= kShort) {
        const float4* src = staged + first[j] * Q + q;
        float4 x = zero, y = zero;
        int i = 1;
        for (; i + 1 < n[j]; i += 2) {
          x = add4(x, src[i * Q]);
          y = add4(y, src[(i + 1) * Q]);
        }
        if (i < n[j]) x = add4(x, src[i * Q]);
        acc[j] = add4(acc[j], add4(x, y));
      }
      unsigned hot = __ballot_sync(~0u, n[j] > kShort && q == 0);
      while (hot) {
        const int lead = __ffs(hot) - 1;
        hot &= hot - 1;
        const int f = __shfl_sync(~0u, first[j], lead), m = __shfl_sync(~0u, n[j], lead);
        float4 x = zero;
        for (int i = 1 + lane / Q; i < m; i += kGroups) x = add4(x, staged[(f + i) * Q + q]);
#pragma unroll
        for (int off = Q; off < 32; off <<= 1) x = add4(x, shfl_xor4(x, off));
        if (lane - q == lead) acc[j] = add4(acc[j], x);
      }
    }
    if (base + kChunk < R) {  // the next round's bins
      __syncthreads();
      for (int i = tid; i < gn; i += kThreads) count[i] = 0;
    }
  }

#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int t = own(j);
    if (t < gn) store4<VEC>(out + static_cast<long long>(g0 + t) * d, c0 + 4 * q, d, acc[j]);
  }
}

template <int W, bool VEC>
cudaError_t launch(const float* rows, const int* tickets, float* out, long long R, int d,
                   int G, cudaStream_t stream) {
  constexpr int kSpan = kThreads * kOut / (W / 4);
  const int slices = (d + W - 1) / W;
  const int span = G < kSpan ? G : kSpan;
  const long long ctas = static_cast<long long>(slices) * ((G + span - 1) / span);
  if (ctas > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  segment_rows_kernel<W, VEC><<<static_cast<int>(ctas), kThreads, 0, stream>>>(
      rows, tickets, out, R, d, G, slices, span);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one row segment sum on `stream`: out[g] = the sum of rows[r] over
// tickets[r] == g, for every g in [0, G) (0 where no row names g); rows
// with tickets outside [0, G) are dropped.  Every element of `out` is
// written, so it needs no zeroing.  `vec` != 0 takes the 16-byte path (the
// caller guarantees d % 4 == 0 and 16-byte aligned rows and out).  Makes
// no runtime query.  Returns a cudaError_t as an int (0 = launched); the
// caller checks shapes, types and devices.
int segment_rows_launch(const void* rows, const void* tickets, void* out, long long R,
                        int d, int G, int vec, void* stream) {
  if (R < 0 || d < 0 || G < 0 || (vec && d % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0 || G == 0) return static_cast<int>(cudaSuccess);  // no element to write
  const float* r = static_cast<const float*>(rows);
  const int* t = static_cast<const int*>(tickets);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vec ? launch<8, true>(r, t, o, R, d, G, s)
                              : launch<8, false>(r, t, o, R, d, G, s);
  return static_cast<int>(err);
}

const char* segment_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
