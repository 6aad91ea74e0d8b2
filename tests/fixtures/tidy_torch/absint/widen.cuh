// absint fixture: a loop without a constant trip count runs to a fixed
// point with widening; its condition bounds what the widening took.
#pragma once

#include <cstdint>

namespace fx {

// i < n <= 1000 when the body runs: i ends at most 1002.
// tidy: range=n:0..1000
__device__ __forceinline__ uint32_t count_to(uint32_t n) {
  uint32_t i = 0;
  while (i < n) i += 3;
  return i;
}

// i != n bounds nothing: the widened i may wrap.
// tidy: range=n:0..1000
__device__ __forceinline__ uint32_t count_past(uint32_t n) {
  uint32_t i = 0;
  while (i != n) i += 3;
  return i;
}

}  // namespace fx
