// query_index_keys: the secondary query index's composite keys of one
// staged batch, built on the card.
//
// Replaces the reference package's ops/qindex.py query_index_keys (the
// jit entry at :129, body `_build_blocks` at :106): for every record, the
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
// Design: one thread per record (a grid-stride loop past 2^16 blocks),
// which writes its five key rows and five payload rows. The key words
// come from qindex_fold.cuh, whose limb arithmetic the sorted build
// (query_index_keys_sorted.cu) shares. The main path no longer launches
// this kernel: the sorted build computes the same keys inside its own
// launch.
#include "common.cuh"
#include "qindex_fold.cuh"

namespace {

__global__ void build_keys(const uint32_t* __restrict__ cols,
                           const uint32_t* __restrict__ ts,
                           const uint32_t* __restrict__ rows,
                           const uint32_t* __restrict__ pad,
                           uint32_t* __restrict__ keys,
                           uint32_t* __restrict__ pay, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t* c = cols + i * 9;
    uint32_t p = pad[i], t0 = ts[2 * i], t1 = ts[2 * i + 1], r = rows[i];
#pragma unroll
    for (int b = 0; b < tb::kTagBlocks; ++b) {
      long long o = ((long long)b * n + i) * 3;
      uint32_t lo0, lo1;
      tb::block_key(c, b, lo0, lo1);
      keys[o] = lo0;
      keys[o + 1] = lo1;
      keys[o + 2] = p;
      pay[o] = t0;
      pay[o + 1] = t1;
      pay[o + 2] = r;
    }
  }
}

}  // namespace

// cols (n, 9), ts (n, 2), rows (n,), pad (n,) -> keys (5n, 3), pay (5n, 3);
// all uint32, contiguous.
extern "C" int tb_query_index_keys(const void* cols, const void* ts,
                                   const void* rows, const void* pad,
                                   void* keys, void* pay, long long n,
                                   void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  build_keys<<<tb::blocks_for(n), tb::kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)cols, (const uint32_t*)ts, (const uint32_t*)rows,
      (const uint32_t*)pad, (uint32_t*)keys, (uint32_t*)pay, n);
  return (int)cudaGetLastError();
}
