// query_index_keys: the secondary query index's composite keys of one
// staged batch, built on the card.
//
// Replaces the reference package's ops/qindex.py query_index_keys (the
// jit entry at :129, body `_build_blocks` at :97): for every record, the
// fold56 image of each queryable field (user_data_128, user_data_64,
// user_data_32, ledger, code) becomes key.lo = tag << 56 | fold56, in the
// merge kernel's run format: keys (5n, 3) = [lo0, lo1, pad] and payload
// (5n, 3) = [ts0, ts1, row], tag block b at rows [b n, (b + 1) n).
// ops/qindex.py query_index_keys_plain is the same function in PyTorch.
//
// What bounds it on this card: bytes. Each record reads 13 words and
// writes 30, with a few dozen integer operations between; at n = 8192 the
// whole call moves about 1.4 MB, so launch latency dominates.
//
// Design: one thread per record, which writes its five key rows and five
// payload rows. The limb arithmetic is the reference's, word for word
// (_fold56_u64, _fold56_u128): every shift stays inside 32 bits.
#include "common.cuh"

namespace {

// The five tag blocks in order (lsm/scan.py QUERY_TAG_FIELDS).
__device__ __forceinline__ uint32_t tag_of(int b) {
  return b == 0 ? 5u : b == 1 ? 6u : b == 2 ? 7u : b == 3 ? 9u : 10u;
}

__global__ void build_keys(const uint32_t* __restrict__ cols,
                           const uint32_t* __restrict__ ts,
                           const uint32_t* __restrict__ rows,
                           const uint32_t* __restrict__ pad,
                           uint32_t* __restrict__ keys,
                           uint32_t* __restrict__ pay, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* c = cols + i * 9;
  // fold56 of user_data_128 (limbs lo0, lo1, hi0, hi1).
  uint32_t lo0 = c[0], lo1 = c[1], hi0 = c[2], hi1 = c[3];
  uint32_t a0 = lo0 ^ (lo1 >> 24);
  uint32_t a1 = lo1 & 0xFFFFFFu;
  uint32_t b0 = (hi0 & 0x7FFFFFFFu) << 1;
  uint32_t b1 = (((hi1 & 0xFFFFFFu) << 1) | (hi0 >> 31)) & 0xFFFFFFu;
  uint32_t f0[5], f1[5];
  f0[0] = a0 ^ b0 ^ (hi1 >> 23);
  f1[0] = a1 ^ b1;
  // fold56 of user_data_64.
  f0[1] = c[4] ^ (c[5] >> 24);
  f1[1] = c[5] & 0xFFFFFFu;
  // u32 fields: fold56 is the identity, high limb 0.
  f0[2] = c[6];
  f0[3] = c[7];
  f0[4] = c[8];
  f1[2] = f1[3] = f1[4] = 0;
  uint32_t p = pad[i], t0 = ts[2 * i], t1 = ts[2 * i + 1], r = rows[i];
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    long long o = ((long long)b * n + i) * 3;
    keys[o] = f0[b];
    keys[o + 1] = f1[b] | (tag_of(b) << 24);
    keys[o + 2] = p;
    pay[o] = t0;
    pay[o + 1] = t1;
    pay[o + 2] = r;
  }
}

}  // namespace

// cols (n, 9), ts (n, 2), rows (n,), pad (n,) -> keys (5n, 3), pay (5n, 3);
// all uint32, contiguous.
extern "C" int tb_query_index_keys(const void* cols, const void* ts,
                                   const void* rows, const void* pad,
                                   void* keys, void* pay, long long n,
                                   void* stream) {
  if (n < 1 || n > (1ll << 16) * tb::kThreads) return (int)cudaErrorInvalidValue;
  build_keys<<<tb::blocks_for(n), tb::kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)cols, (const uint32_t*)ts, (const uint32_t*)rows,
      (const uint32_t*)pad, (uint32_t*)keys, (uint32_t*)pay, n);
  return (int)cudaGetLastError();
}
