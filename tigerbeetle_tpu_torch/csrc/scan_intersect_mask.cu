// scan_intersect_mask: membership of sorted candidate rows in a sorted row
// run, on the card.
//
// Replaces the reference package's ops/scanops.py scan_intersect_mask
// (:38): mask[i] = cand[i] is in run, for ascending uint32 cand and run,
// both padded with 0xFFFFFFFF (a pad of cand meets a pad of run; callers
// cut the mask to their length). ops/scanops.py scan_intersect_mask_plain
// is the same function in PyTorch.
//
// What bounds it on this card: latency of the dependent loads of each
// search. The bytes are the two arrays read once and one byte a candidate
// written; each candidate then reads log2(len(run)) words of the run,
// whose top levels every thread shares through the cache.
//
// Design: one thread per candidate; a lower-bound binary search over the
// run, compared as unsigned words, then one equality test.
#include "common.cuh"

namespace {

__global__ void intersect_mask(const uint32_t* __restrict__ cand,
                               const uint32_t* __restrict__ run,
                               uint8_t* __restrict__ mask, long long nc,
                               long long nr) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nc) return;
  uint32_t c = cand[i];
  long long lo = 0, hi = nr;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (run[mid] < c) lo = mid + 1; else hi = mid;
  }
  mask[i] = run[lo < nr ? lo : nr - 1] == c;
}

}  // namespace

// cand (nc,), run (nr,) uint32 -> mask (nc,) bool (one byte each);
// nr >= 1.
extern "C" int tb_scan_intersect_mask(const void* cand, const void* run,
                                      void* mask, long long nc, long long nr,
                                      void* stream) {
  if (nc < 1 || nr < 1 || nc > (1ll << 16) * tb::kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  intersect_mask<<<tb::blocks_for(nc), tb::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)cand, (const uint32_t*)run, (uint8_t*)mask, nc, nr);
  return (int)cudaGetLastError();
}
