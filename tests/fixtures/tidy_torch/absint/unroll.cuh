// absint fixture: a #pragma unroll loop over a template constant, read one
// iteration at a time. 256 terms below 2^24 stay in 32 bits; 257 do not.
#pragma once

#include <cstdint>

namespace fx {

template <int Steps>
// tidy: range=x:0..0xFFFFFF
__device__ __forceinline__ uint32_t sum_steps(uint32_t x) {
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < Steps; ++j) s += x;
  return s;
}

// The halving loop of a warp reduction: five passes, a constant trip count.
// tidy: range=x:0..0x7FFFFFF
__device__ __forceinline__ uint32_t halving(uint32_t x) {
  for (int o = 16; o; o >>= 1) x += x;
  return x;
}

}  // namespace fx
