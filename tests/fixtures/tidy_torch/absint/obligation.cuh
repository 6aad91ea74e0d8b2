// absint fixture: a callee's range= violated by one caller (one
// range-obligation) and kept by another.
#pragma once

#include <cstdint>

namespace fx {

// tidy: range=tag:0..10 — a tag fits the key's top byte
__device__ __forceinline__ uint32_t top_byte(uint32_t tag) {
  return tag << 24;
}

__device__ __forceinline__ uint32_t bad_caller(uint32_t x) {
  return top_byte(x);
}

__device__ __forceinline__ uint32_t good_caller(uint32_t x) {
  return top_byte(x & 7u);
}

}  // namespace fx
