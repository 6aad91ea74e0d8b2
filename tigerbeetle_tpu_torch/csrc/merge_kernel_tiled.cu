// merge_kernel_tiled: the stable merge of two sorted device runs, on the
// card.
//
// Replaces the reference package's ops/merge.py merge_kernel_tiled (:104):
// keys (n, 3) and (m, 3) uint32 [lo0, lo1, pad], compared as unsigned
// words with the most significant word last, each run sorted; payloads
// (n, 3) and (m, 3) ride along. The output is the (n + m)-row merge, and at
// equal keys every row of A comes before every row of B (the flush passes
// the older run as A). ops/merge.py merge_kernel_tiled_plain is the same
// function in PyTorch.
//
// What bounds it on this card: bytes. Each input row is read once and each
// output row written once, 24 bytes a row; the diagonal searches and the
// per-row binary searches in shared memory add O(log) work a row, which at
// the flush's 40,960-163,840 rows stays far below the device's rate.
//
// Design: one thread block of `tile` threads per `tile`-row output tile.
// Thread 0 finds by a binary search on the merge-path diagonal how many
// rows of A the outputs before the tile's start and before its end take
// (A drains first on ties); the tile's A rows and B rows (tile in all) go
// to shared memory; each row's place in the tile is its index on its side
// plus a binary search on the other side (B < A for a row of A, A <= B for
// a row of B, so A comes first at equal keys); each thread writes its row
// and its payload there.
#include "common.cuh"

namespace {

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
__device__ long long a_taken(const uint32_t* ka, long long n,
                             const uint32_t* kb, long long m, long long d) {
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

__global__ void merge_tiles(const uint32_t* __restrict__ ka,
                            const uint32_t* __restrict__ pa,
                            const uint32_t* __restrict__ kb,
                            const uint32_t* __restrict__ pb,
                            uint32_t* __restrict__ ok,
                            uint32_t* __restrict__ op, long long n,
                            long long m, int tile) {
  extern __shared__ uint32_t sk[];  // [tile][3]: the tile's A rows, then B
  __shared__ long long s_a[2];
  long long d0 = (long long)blockIdx.x * tile;
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

}  // namespace

// ka, pa (n, 3), kb, pb (m, 3) -> ok, op (n + m, 3); all uint32,
// contiguous; 1 <= tile <= 1024 and tile divides n + m.
extern "C" int tb_merge_kernel_tiled(const void* ka, const void* pa,
                                     const void* kb, const void* pb, void* ok,
                                     void* op, long long n, long long m,
                                     long long tile, void* stream) {
  if (tile < 1 || tile > 1024 || n < 0 || m < 0 || (n + m) % tile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  long long tiles = (n + m) / tile;
  if (tiles == 0) return (int)cudaSuccess;
  if (tiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  merge_tiles<<<(unsigned)tiles, (unsigned)tile, (size_t)tile * 3 * 4,
                static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)ka, (const uint32_t*)pa, (const uint32_t*)kb,
      (const uint32_t*)pb, (uint32_t*)ok, (uint32_t*)op, n, m, (int)tile);
  return (int)cudaGetLastError();
}
