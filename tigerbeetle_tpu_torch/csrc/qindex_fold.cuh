// The secondary query index's composite key words, shared by the key build
// (query_index_keys.cu) and the sorted build (query_index_keys_sorted.cu).
//
// A staged record is one row of cols (n, 9) uint32: user_data_128 as four
// limbs (lo0, lo1, hi0, hi1), user_data_64 as two, then user_data_32,
// ledger and code (ops/qindex.py _STAGE). Tag block b's key of a record is
// lo = tag << 56 | fold56(field): (lo0, lo1) words, the fold in lo1's low
// 24 bits and the tag in its top byte. The limb arithmetic is the
// reference's, word for word (ops/qindex.py _fold56_u64, _fold56_u128):
// every shift stays inside 32 bits.
#pragma once

#include <cstdint>

namespace tb {

constexpr int kTagBlocks = 5;

// The five tag blocks in order (lsm/scan.py QUERY_TAG_FIELDS).
__device__ __forceinline__ uint32_t tag_of(int b) {  // tidy: range=b:0..4
  return b == 0 ? 5u : b == 1 ? 6u : b == 2 ? 7u : b == 3 ? 9u : 10u;
}

// fold56 of a u64 (lo0, lo1): the identity below 2^56, an xor-fold above.
__device__ __forceinline__ void fold56_u64(uint32_t lo0, uint32_t lo1, uint32_t& f0,
                                           uint32_t& f1) {
  f0 = lo0 ^ (lo1 >> 24);
  f1 = lo1 & 0xFFFFFFu;
}

// fold56 of a u128: the hi word folds in as ((hi & MASK56) << 1 & MASK56) ^
// (hi >> 55).
__device__ __forceinline__ void fold56_u128(uint32_t lo0, uint32_t lo1, uint32_t hi0,
                                            uint32_t hi1, uint32_t& f0, uint32_t& f1) {
  uint32_t a0, a1;
  fold56_u64(lo0, lo1, a0, a1);
  uint32_t b0 = (hi0 & 0x7FFFFFFFu) << 1;
  uint32_t b1 = (((hi1 & 0xFFFFFFu) << 1) | (hi0 >> 31)) & 0xFFFFFFu;
  f0 = a0 ^ b0 ^ (hi1 >> 23);
  f1 = a1 ^ b1;
}

// Tag block b's key words (lo0, lo1) of the record whose staged row is `c`
// (9 words). Reads only the words of that block's field.
// tidy: range=b:0..4 — b is a tag block, below kTagBlocks
__device__ __forceinline__ void block_key(const uint32_t* __restrict__ c, int b,
                                          uint32_t& lo0, uint32_t& lo1) {
  uint32_t f1 = 0;
  if (b == 0) {
    fold56_u128(c[0], c[1], c[2], c[3], lo0, f1);
  } else if (b == 1) {
    fold56_u64(c[4], c[5], lo0, f1);
  } else {
    lo0 = c[4 + b];  // the u32 fields sit below 2^56: fold56 is the identity
  }
  lo1 = f1 | (tag_of(b) << 24);
}

}  // namespace tb
