// absint fixture: an aggregate initialiser converts each item to its
// member in order and zeroes the members it leaves out.
#pragma once

#include <cstdint>

namespace fx {

struct Pair {
  uint32_t a;
  uint32_t b;
  uint4 v;
};

// tidy: range=x:0..0xFF
__device__ __forceinline__ uint32_t pair_small(uint32_t x) {
  const Pair p = Pair{x, 7u, {}};
  return p.a + p.b + p.v.x;
}

// tidy: range=x:0..0xFF
__device__ __forceinline__ uint32_t pair_large(uint32_t x) {
  const Pair p = Pair{x, 0xFFFFFFFFu, {}};
  return p.a + p.b;
}

}  // namespace fx
