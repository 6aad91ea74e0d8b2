// read_balances: gather the four balance tables at a batch of slots.
//
// Replaces the reference package's ops/commit.py read_balances (:353):
// slots are clipped to [0, A-1], and each of the four (A, 4) uint32 tables
// yields a (k, 4) block. The four blocks are written as one (4, k, 4)
// block, on the card or in pinned host memory: the state machine's reads
// (lookups, the serial route's preload) pass their pinned host block, so
// the rows cross to the host in the kernel's own stores, with no copy
// after it. k is the host's power-of-two bucket (>= 16) there, any k >= 0
// here.
//
// What bounds it on the card: bytes, and few of them. Each row moves 16
// bytes in and out a table plus its slot: 2.2 MB at k = 16,384, about
// 0.65 us at 3.35 TB/s. But every load is a random 16-byte row of a 16 MB
// table, so each costs a whole 32-byte sector, and at the lookup's sizes
// (k = 16 to 16,384) the kernel is bound by its launch and one dependent
// round trip (the slot, then the rows), not by its bytes. Into host memory
// the stores cross the host link: about 1 MB at k = 16,384.
//
// Design: one thread a row, over a grid-stride loop (no cap on k). The
// thread loads and clips its slot once, then issues the four tables'
// 16-byte loads back to back, so four independent loads are in flight a
// thread, and stores them into the four tables' rows of the output block:
// consecutive threads take consecutive rows, so each table's stores
// coalesce.
#include "common.cuh"

namespace {

// 128 threads a block, so that k = 8192-16,384 rows spread over 64-128
// SMs: in a sweep of the block size (64, 128, 256) 256 read slowest at
// those sizes (PERF.md §6). Past kMaxBlocks blocks the threads
// loop.
constexpr int kBlock = 128;
constexpr long long kMaxBlocks = 1 << 16;

__global__ void __launch_bounds__(kBlock)
gather_rows(tb::Four in, uint4* __restrict__ out, const int32_t* __restrict__ slots,
            long long k, long long a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += stride) {
    long long s = slots[i];
    s = s < 0 ? 0 : (s >= a ? a - 1 : s);
    const uint4 r0 = in.t0[s], r1 = in.t1[s], r2 = in.t2[s], r3 = in.t3[s];
    out[i] = r0;
    out[k + i] = r1;
    out[2 * k + i] = r2;
    out[3 * k + i] = r3;
  }
}

}  // namespace

// dp, dpo, cp, cpo: (a, 4) uint32 each; slots (k,) int32; out (4, k, 4)
// uint32: the rows of dp, dpo, cp and cpo at the clipped slots, in that
// order. a >= 1, k >= 0.
extern "C" int tb_read_balances(const void* dp, const void* dpo,
                                const void* cp, const void* cpo,
                                const void* slots, void* out, long long a,
                                long long k, void* stream) {
  if (a < 1 || k < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaGetLastError();
  tb::Four in{(const uint4*)dp, (const uint4*)dpo, (const uint4*)cp,
              (const uint4*)cpo};
  const long long blocks = (k + kBlock - 1) / kBlock;
  gather_rows<<<(unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      in, (uint4*)out, (const int32_t*)slots, k, a);
  return (int)cudaGetLastError();
}
