// absint fixture: a [&] lambda is read inline at each call, in its
// caller's frame: two adds of a 16-bit value fit, two of it shifted by 16
// do not.
#pragma once

#include <cstdint>

namespace fx {

// tidy: range=x:0..0xFFFF
__device__ __forceinline__ uint32_t twice(uint32_t x) {
  uint32_t acc = 0;
  auto add = [&](uint32_t v) { acc += v; };
  add(x);
  add(x);
  return acc;
}

// tidy: range=x:0..0xFFFF
__device__ __forceinline__ uint32_t twice_high(uint32_t x) {
  uint32_t acc = 0;
  auto add = [&](uint32_t v) { acc += v << 16; };
  add(x);
  add(x);
  return acc;
}

}  // namespace fx
