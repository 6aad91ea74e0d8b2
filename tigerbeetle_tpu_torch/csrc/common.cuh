// Shared device helpers for the commit kernels (ops/commit.py binds them).
//
// Layout: a u128 is four little-endian uint32 limbs, so one (A, 4) uint32
// table row is 16 bytes and, read as two little-endian u64 words, is
// (lo, hi). Rows are 16-byte aligned (the wrappers check).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tb {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n, long long cap = 1 << 16) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (unsigned int)(b < cap ? b : cap);
}

// True where a + b overflows 128 bits (upstream sum_overflows,
// src/state_machine.zig:1645).
__device__ __forceinline__ bool sum_overflows(uint4 a, uint4 b) {
  unsigned long long alo = ((unsigned long long)a.y << 32) | a.x;
  unsigned long long ahi = ((unsigned long long)a.w << 32) | a.z;
  unsigned long long blo = ((unsigned long long)b.y << 32) | b.x;
  unsigned long long bhi = ((unsigned long long)b.w << 32) | b.z;
  // The sums wrap by design: each wrap is the carry the next line reads.
  unsigned long long lo = alo + blo;  // tidy: allow=limb-overflow — mod 2^64
  unsigned long long c = lo < alo;
  unsigned long long s1 = ahi + bhi;  // tidy: allow=limb-overflow — mod 2^64
  unsigned long long s2 = s1 + c;  // tidy: allow=limb-overflow — mod 2^64
  return (s1 < ahi) || (s2 < s1);
}

// row (a 16-byte u128 in device memory) += v, exactly, with atomics.
// Returns true if this addition carried out of bit 127.
//
// The low word's atomicAdd returns the old value, so a wrap of the low
// word is seen by exactly the one thread that caused it, which then adds
// the carry into the high word with its own high part. The number of
// carries is therefore exactly floor((lo + sum of lo parts) / 2^64), the
// final row is (old + sum) mod 2^128 in any order, and the high word's
// running sum wraps past 2^64 (seen by one thread) iff the true total
// reached 2^128: the overflow flag is order-independent.
__device__ __forceinline__ bool atomic_add_u128(uint32_t* row, uint4 v) {
  unsigned long long* w = reinterpret_cast<unsigned long long*>(row);
  unsigned long long vlo = ((unsigned long long)v.y << 32) | v.x;
  unsigned long long vhi = ((unsigned long long)v.w << 32) | v.z;
  unsigned long long carry = 0;
  if (vlo) {
    unsigned long long old = atomicAdd(w, vlo);
    carry = (old + vlo) < old;  // tidy: allow=limb-overflow — the wrap test
  }
  if (carry && vhi == ~0ull) {
    return true;  // adds 2^128: the row is unchanged mod 2^128
  }
  // Cannot wrap: vhi == ~0 with a carry returned above (a relation the
  // interval proof cannot carry past the branch).
  unsigned long long add = vhi + carry;  // tidy: allow=limb-overflow
  if (!add) return false;
  unsigned long long old = atomicAdd(w + 1, add);
  return (old + add) < old;  // tidy: allow=limb-overflow — the wrap test
}

// row (a 16-byte u128 in device memory) -= v, exactly, with atomics.
// Returns true if this subtraction borrowed out of bit 127.
//
// The mirror of atomic_add_u128: the low word's atomicAdd of -v.lo borrows
// iff its old value was below v.lo, seen by exactly the thread that
// caused it, which then subtracts the borrow from the high word too. A
// row only ever decreases in this pass, so the high word's running value
// drops below zero (seen by one thread) iff the total subtracted exceeds
// the row's value: the underflow flag is order-independent, and the row
// ends as (old - sum) mod 2^128 in any order.
__device__ __forceinline__ bool atomic_sub_u128(uint32_t* row, uint4 v) {
  unsigned long long* w = reinterpret_cast<unsigned long long*>(row);
  unsigned long long vlo = ((unsigned long long)v.y << 32) | v.x;
  unsigned long long vhi = ((unsigned long long)v.w << 32) | v.z;
  unsigned long long borrow = 0;
  if (vlo) {
    unsigned long long old = atomicAdd(w, ~vlo + 1ull);
    borrow = old < vlo;
  }
  if (borrow && vhi == ~0ull) {
    return true;  // takes 2^128: the row is unchanged mod 2^128
  }
  // Cannot wrap: vhi == ~0 with a borrow returned above.
  unsigned long long sub = vhi + borrow;  // tidy: allow=limb-overflow
  if (!sub) return false;
  unsigned long long old = atomicAdd(w + 1, ~sub + 1ull);
  return old < sub;
}

// u128 values in registers (nvcc supports unsigned __int128 on the device).
typedef unsigned __int128 u128;

__device__ __forceinline__ u128 to_u128(uint4 v) {
  return ((u128)(((unsigned long long)v.w << 32) | v.z) << 64) |
         (((unsigned long long)v.y << 32) | v.x);
}

__device__ __forceinline__ uint4 from_u128(u128 x) {
  unsigned long long lo = (unsigned long long)x;
  unsigned long long hi = (unsigned long long)(x >> 64);
  return make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                    (uint32_t)(hi >> 32));
}

// An exact sum of up to three u128 values: a u128 and the carries above it
// (the reference's u160 `_add3_wide`).
struct Wide {
  u128 lo;
  uint32_t hi;
};

__device__ __forceinline__ Wide add3(u128 a, u128 b, u128 c) {
  Wide w;
  u128 s = a + b;  // tidy: allow=limb-overflow — mod 2^128, carry below
  w.hi = s < a;
  w.lo = s + c;  // tidy: allow=limb-overflow — mod 2^128, carry below
  w.hi += w.lo < s;
  return w;
}

// a > b for a wide sum and a u128.
__device__ __forceinline__ bool wide_gt(Wide a, u128 b) {
  return a.hi != 0 || a.lo > b;
}

// Four table pointers chosen by a select chain rather than an indexed
// array, which keeps the kernel argument in registers.
struct Four {
  const uint4* t0;
  const uint4* t1;
  const uint4* t2;
  const uint4* t3;
  __device__ const uint4* operator[](int i) const {
    return i == 0 ? t0 : i == 1 ? t1 : i == 2 ? t2 : t3;
  }
};

}  // namespace tb
