// The key order and the merge-path pieces of the merges of sorted device
// runs (merge_kernel.cu, merge_kernel_tiled.cu).
//
// Run format (ops/merge.py): keys (rows, 3) uint32 [lo0, lo1, pad],
// compared as unsigned words with the last word most significant, so pad
// rows ([0, 0, 1]) sort after every real key, a lo of all ones included;
// payloads ride along. At equal keys every row of A comes before every
// row of B: callers pass the older run as A.
#pragma once

#include <cstdint>

namespace tb {
namespace merge_path {

// a <= b on keys given as their words, without branches: a caller that
// loads both keys' six words together waits on one round trip.
__device__ __forceinline__ bool key_le_words(uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t b0, uint32_t b1, uint32_t b2) {
  return (a2 < b2) | ((a2 == b2) & ((a1 < b1) | ((a1 == b1) & (a0 <= b0))));
}

// How many rows of A the first d outputs of the stable merge take: the
// least ai in [max(0, d - m), min(d, n)] with A[ai] > B[d - ai - 1], by one
// warp. A[ai] <= B[d - ai - 1] holds exactly below the answer, so the
// probes where it holds are a prefix, and their count places the answer.
// A round over more than 64 places probes 32 evenly spaced ones and keeps
// (probe c - 1, probe c]; at most 64 places are probed whole, two a lane,
// in the last round. Every lane returns the answer.
__device__ inline long long a_taken_warp(const uint32_t* __restrict__ ka, long long n,
                                         const uint32_t* __restrict__ kb, long long m,
                                         long long d, int lane) {
  long long lo = d - m > 0 ? d - m : 0;
  long long hi = d < n ? d : n;
  while (hi - lo > 64) {  // the same on every lane
    const long long len = hi - lo;
    const long long ai = lo + len * lane / 32;  // ai < n, d - ai - 1 >= 0
    uint32_t x[3], y[3];  // both keys' loads in flight together
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      x[w] = __ldg(ka + 3 * ai + w);
      y[w] = __ldg(kb + 3 * (d - ai - 1) + w);
    }
    const int c = __popc(__ballot_sync(
        0xFFFFFFFFu, key_le_words(x[0], x[1], x[2], y[0], y[1], y[2])));
    const long long nlo = c > 0 ? lo + len * (c - 1) / 32 + 1 : lo;
    if (c < 32) hi = lo + len * c / 32;
    lo = nlo;
  }
  if (lo == hi) return lo;
  uint32_t x[2][3], y[2][3];
  bool in[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const long long ai = lo + q * 32 + lane;
    in[q] = ai < hi;
    const long long at = in[q] ? ai : lo;
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      x[q][w] = __ldg(ka + 3 * at + w);
      y[q][w] = __ldg(kb + 3 * (d - at - 1) + w);
    }
  }
  int c = 0;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const bool le = key_le_words(x[q][0], x[q][1], x[q][2], y[q][0], y[q][1], y[q][2]);
    c += __popc(__ballot_sync(0xFFFFFFFFu, in[q] && le));
  }
  return lo + c;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The whole 16-byte chunks [i0, i1) of words [w0, w1): those a bulk copy
// takes (i0 >= i1: none).
__device__ __forceinline__ void interior(long long w0, long long w1, long long& i0,
                                         long long& i1) {
  i0 = (w0 + 3) & ~3ll;
  i1 = w1 & ~3ll;
}

// The bytes the bulk copies of words [w0, w1) bring (what the mbarrier
// they complete on expects of them).
__device__ __forceinline__ long long bulk_bytes(long long w0, long long w1) {
  long long i0, i1;
  interior(w0, w1, i0, i1);
  return i1 > i0 ? 4 * (i1 - i0) : 0;
}

// One thread: the bulk copy of words [w0, w1)'s whole chunks of g to s,
// word w at s[w - 4 floor(w0 / 4)], completing on the mbarrier at `bar`.
__device__ inline void bulk_span(uint32_t* s, const uint32_t* __restrict__ g, long long w0,
                                 long long w1, unsigned bar) {
  long long i0, i1;
  interior(w0, w1, i0, i1);
  if (i0 >= i1) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(s + (i0 - (w0 & ~3ll)))),
      "l"(g + i0), "r"((unsigned)(4 * (i1 - i0))), "r"(bar)
      : "memory");
}

// Slot k (0-5) of words [w0, w1): the words outside the whole chunks, up
// to three before them and three after, by a plain load.
__device__ inline void edge_word(uint32_t* s, const uint32_t* __restrict__ g, long long w0,
                                 long long w1, int k) {
  long long i0, i1;
  interior(w0, w1, i0, i1);
  const long long head_end = i0 < w1 ? i0 : w1;
  const long long w = k < 3 ? w0 + k : (i1 > head_end ? i1 : head_end) + (k - 3);
  if (k < 3 ? w < head_end : w < w1) s[w - (w0 & ~3ll)] = g[w];
}

// Words [0, words) of s to g, as 16-byte vectors and then the tail, by
// the block's `threads` threads (g and s 16-byte aligned).
__device__ inline void store_tile(uint32_t* __restrict__ g, const uint32_t* s, int words,
                                  int threads) {
  const int vecs = words >> 2;
  for (int c = threadIdx.x; c < vecs; c += threads) {
    reinterpret_cast<uint4*>(g)[c] = reinterpret_cast<const uint4*>(s)[c];
  }
  for (int w = 4 * vecs + threadIdx.x; w < words; w += threads) g[w] = s[w];
}

// The block's wait for the first phase of the mbarrier at `bar`.
__device__ __forceinline__ void wait_phase0(unsigned bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

}  // namespace merge_path
}  // namespace tb
