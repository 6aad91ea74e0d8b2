// absint fixture: __all_sync narrows its predicate's value in the branch
// it guards. A warp's 32 terms below 2^58 stay below 2^63 (a signed 64-bit
// sum); below 2^59 they do not.
#pragma once

#include <cstdint>

namespace fx {

template <int Bit>
__device__ __forceinline__ long long warp_prefix(unsigned long long x) {
  const int lane = threadIdx.x & 31;
  if (__all_sync(0xFFFFFFFFu, (x >> Bit) == 0)) {
    long long y = (long long)x;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      long long t = __shfl_up_sync(0xFFFFFFFFu, y, 1 << j);
      if (lane >= (1 << j)) y += t;
    }
    return y;
  }
  return 0;
}

}  // namespace fx
