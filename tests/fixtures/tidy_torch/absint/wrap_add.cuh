// absint fixture: a 32-bit add that can wrap (one limb-overflow), and the
// same add with its intent stated (no finding).
#pragma once

#include <cstdint>

namespace fx {

__device__ __forceinline__ uint32_t wraps(uint32_t a, uint32_t b) {
  uint32_t s = a + b;
  return s;
}

__device__ __forceinline__ uint32_t wraps_on_purpose(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // tidy: allow=limb-overflow — the caller reads the wrap
  return s;
}

// A narrower input contract makes the same add safe: no finding.
/* tidy: range=a:0..0x7FFFFFFF,b:0..0x7FFFFFFF */
__device__ __forceinline__ uint32_t fits(uint32_t a, uint32_t b) {
  return a + b;
}

// A loop with a constant trip count: unrolled, 4 * 0xFF stays in 32 bits.
__device__ __forceinline__ uint32_t loops(const uint32_t* v) {
  uint32_t s = 0;
  for (int i = 0; i < 4; ++i) s += v[i] & 0xFFu;
  return s;
}

// A range-based for is outside the subset: one c-parse finding, never a
// pass.
__device__ __forceinline__ uint32_t loops_unread(const uint32_t (&v)[4]) {
  uint32_t s = 0;
  for (uint32_t x : v) s += x & 0xFFu;
  return s;
}

}  // namespace fx
