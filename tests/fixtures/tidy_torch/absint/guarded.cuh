// absint fixture: a subtraction its guard keeps non-negative, in the two
// forms the commit kernels use, and the same subtraction without a guard
// (or with one a store has made stale).
#pragma once

#include <cstdint>

namespace fx {

typedef unsigned __int128 u128;

__device__ __forceinline__ u128 sub_guarded(u128 x, u128 y) {
  return x >= y ? x - y : 0;
}

__device__ __forceinline__ u128 sub_flagged(u128 x, u128 y) {
  bool b = x < y;
  u128 r = b ? 0 : x - y;
  return r;
}

__device__ __forceinline__ u128 sub_unguarded(u128 x, u128 y) {
  return x - y;
}

__device__ __forceinline__ u128 sub_flag_stale(u128 x, u128 y) {
  bool b = x < y;
  y = y | 1;
  return b ? 0 : x - y;
}

}  // namespace fx
