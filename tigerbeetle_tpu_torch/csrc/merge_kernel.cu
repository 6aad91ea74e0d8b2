// merge_kernel: the stable merge of two sorted runs by binary-search rank
// and scatter, on the card.
//
// Replaces the reference package's ops/merge.py merge_kernel (:73): keys
// (n, 3) and (m, 3) uint32 in the merge's run format (merge_path.cuh),
// each run sorted; payload rows of K uint32 words each ride along. Row i
// of A goes to i + |{j : B[j] < A[i]}| and row j of B to
// j + |{i : A[i] <= B[j]}|, so at equal keys A's rows come first. For
// sorted runs the positions are a permutation of [0, n + m). No tile
// alignment; either run may be empty. ops/merge.py merge_kernel_plain (the
// stable sort of the concatenation) is the same function in PyTorch.
//
// What bounds it on this card: bytes, (24 + 8 K) a row in and out; the
// binary search adds log2 of the other run's length dependent loads a row,
// which at the flush shapes (40,960-163,840 rows) keeps it latency-bound
// well above the byte bound.
//
// Design: one thread per row of A and of B (A's rows first in the grid);
// each thread searches the other run in device memory, then writes its key
// and payload to its position.
#include "common.cuh"
#include "merge_path.cuh"

namespace {

using tb::merge_path::key_le;
using tb::merge_path::key_lt;

__global__ void merge_rank(const uint32_t* __restrict__ ka,
                           const uint32_t* __restrict__ pa,
                           const uint32_t* __restrict__ kb,
                           const uint32_t* __restrict__ pb,
                           uint32_t* __restrict__ ok,
                           uint32_t* __restrict__ op, long long n,
                           long long m, int width) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n + m) return;
  bool is_a = i < n;
  long long row = is_a ? i : i - n;
  const uint32_t* self = (is_a ? ka : kb) + 3 * row;
  const uint32_t* other = is_a ? kb : ka;
  long long lo = 0, hi = is_a ? m : n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    // A: count of B strictly below; B: count of A at or below.
    bool before = is_a ? key_lt(other + 3 * mid, self)
                       : key_le(other + 3 * mid, self);
    if (before) lo = mid + 1; else hi = mid;
  }
  long long dst = row + lo;
#pragma unroll
  for (int w = 0; w < 3; ++w) ok[3 * dst + w] = self[w];
  const uint32_t* p = (is_a ? pa : pb) + (long long)width * row;
  for (int w = 0; w < width; ++w) op[(long long)width * dst + w] = p[w];
}

}  // namespace

// ka (n, 3), pa (n, width), kb (m, 3), pb (m, width) -> ok (n + m, 3),
// op (n + m, width); all uint32, contiguous; width >= 1.
extern "C" int tb_merge_kernel(const void* ka, const void* pa, const void* kb,
                               const void* pb, void* ok, void* op, long long n,
                               long long m, long long width, void* stream) {
  if (n < 0 || m < 0 || width < 1 || width > 0x7FFFFFFFll) {
    return (int)cudaErrorInvalidValue;
  }
  long long rows = n + m;
  if (rows == 0) return (int)cudaSuccess;
  long long blocks = (rows + tb::kThreads - 1) / tb::kThreads;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  merge_rank<<<(unsigned)blocks, tb::kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)ka, (const uint32_t*)pa, (const uint32_t*)kb,
      (const uint32_t*)pb, (uint32_t*)ok, (uint32_t*)op, n, m, (int)width);
  return (int)cudaGetLastError();
}
