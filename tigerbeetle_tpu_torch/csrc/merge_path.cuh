// The merge path of two sorted device runs, for the tiled merge
// (merge_kernel_tiled.cu).
//
// Run format (ops/merge.py): keys (rows, 3) uint32 [lo0, lo1, pad],
// compared as unsigned words with the last word most significant, so pad
// rows ([0, 0, 1]) sort after every real key, a lo of all ones included;
// payloads (rows, 3) uint32 ride along. At equal keys every row of A comes
// before every row of B: callers pass the older run as A.
#pragma once

#include <cstdint>

namespace tb {
namespace merge_path {

// a < b and a <= b on three-word keys, the last word most significant.
__device__ __forceinline__ bool key_lt(const uint32_t* a, const uint32_t* b) {
  if (a[2] != b[2]) return a[2] < b[2];
  if (a[1] != b[1]) return a[1] < b[1];
  return a[0] < b[0];
}

__device__ __forceinline__ bool key_le(const uint32_t* a, const uint32_t* b) {
  return !key_lt(b, a);
}

// How many rows of A the first d outputs of the stable merge take: the
// least ai in [max(0, d - m), min(d, n)] with A[ai] > B[d - ai - 1].
__device__ inline long long a_taken(const uint32_t* ka, long long n,
                                    const uint32_t* kb, long long m,
                                    long long d) {
  long long lo = d - m > 0 ? d - m : 0;
  long long hi = d < n ? d : n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;  // mid < n and d - mid - 1 >= 0
    if (key_le(ka + 3 * mid, kb + 3 * (d - mid - 1))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One `tile`-row output tile [d0, d0 + tile) of the merge of A (n rows)
// and B (m rows), by one thread block of `tile` threads. `sk` is shared
// memory for tile * 3 words; d0 + tile <= n + m.
//
// Thread 0 finds by two diagonal searches how many rows of A the outputs
// before the tile's start and before its end take; the tile's A rows and B
// rows (tile in all) go to shared memory; each row's place in the tile is
// its index on its side plus a binary search on the other side (B < A for
// a row of A, A <= B for a row of B); each thread writes its key and its
// payload there.
__device__ inline void merge_tile(const uint32_t* __restrict__ ka,
                                  const uint32_t* __restrict__ pa, long long n,
                                  const uint32_t* __restrict__ kb,
                                  const uint32_t* __restrict__ pb, long long m,
                                  uint32_t* __restrict__ ok,
                                  uint32_t* __restrict__ op, long long d0,
                                  int tile, uint32_t* sk) {
  __shared__ long long s_a[2];
  if (threadIdx.x == 0) {
    s_a[0] = a_taken(ka, n, kb, m, d0);
    s_a[1] = a_taken(ka, n, kb, m, d0 + tile);
  }
  __syncthreads();
  long long a0 = s_a[0], b0 = d0 - a0;
  int na = (int)(s_a[1] - a0);
  int t = threadIdx.x;
  bool is_a = t < na;
  long long src = is_a ? a0 + t : b0 + (t - na);
  const uint32_t* k = (is_a ? ka : kb) + 3 * src;
#pragma unroll
  for (int w = 0; w < 3; ++w) sk[3 * t + w] = k[w];
  __syncthreads();
  const uint32_t* self = sk + 3 * t;
  int lo, hi;
  if (is_a) {
    // rows of B (sk[na..tile)) below this A row
    lo = na;
    hi = tile;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (key_lt(sk + 3 * mid, self)) lo = mid + 1; else hi = mid;
    }
    lo -= na;
  } else {
    // rows of A (sk[0..na)) at or below this B row
    lo = 0;
    hi = na;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (key_le(sk + 3 * mid, self)) lo = mid + 1; else hi = mid;
    }
  }
  long long dst = d0 + (is_a ? t : t - na) + lo;
  const uint32_t* p = (is_a ? pa : pb) + 3 * src;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    ok[3 * dst + w] = self[w];
    op[3 * dst + w] = p[w];
  }
}

}  // namespace merge_path
}  // namespace tb
