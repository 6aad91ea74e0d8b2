// The key order of the merges' sorted device runs (merge_kernel.cu,
// merge_kernel_tiled.cu).
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

// a <= b on keys given as their words, without branches: a caller that
// loads both keys' six words together waits on one round trip.
__device__ __forceinline__ bool key_le_words(uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t b0, uint32_t b1, uint32_t b2) {
  return (a2 < b2) | ((a2 == b2) & ((a1 < b1) | ((a1 == b1) & (a0 <= b0))));
}

}  // namespace merge_path
}  // namespace tb
