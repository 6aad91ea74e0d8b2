// absint fixture: an inline asm output holds the full range of its
// register's width: a 32-bit "=r" doubled fits 64 bits, a 64-bit "=l"
// does not.
#pragma once

#include <cstdint>

namespace fx {

__device__ __forceinline__ unsigned long long reg32(const uint32_t* p) {
  unsigned long long v;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v + v;
}

__device__ __forceinline__ unsigned long long reg64(const uint32_t* p) {
  unsigned long long v;
  asm volatile("ld.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v + v;
}

}  // namespace fx
