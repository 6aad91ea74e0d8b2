// write_balances: scatter exact balances into the four balance tables.
//
// Replaces the reference package's ops/commit.py write_balances (:334), the
// serial route's writeback: four (k, 4) uint32 blocks land at their slots,
// and a row whose slot lies outside [-A, A) is dropped (mode="drop"; the
// host pads with slot = A; a negative slot counts from the end). Slots of
// the rows that land are distinct (one row per account the serial route
// touched).
//
// What bounds it on the card: bytes, and at the serial route's k (at most
// 16384 rows) the launch itself. The update is in place: the state machine
// writes back only into its current tables, which no dispatched batch
// holds as its base (ops/commit.py), so the kernel moves the rows and
// nothing else — k * (4 + 64 + 64) bytes, 2.2 MB at k = 16384.
//
// Design: one thread per (table, row) reads its slot and stores its
// 16-byte row; the four tables share one launch.
#include "common.cuh"

namespace {

__global__ void scatter_rows(tb::Four rows, tb::FourOut out,
                             const int32_t* __restrict__ slots, long long k,
                             long long a) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4 * k) return;
  int table = (int)(i / k);
  long long row = i - (long long)table * k;
  long long s = slots[row];
  if (s < 0) s += a;  // counts from the end, as the reference's indexing
  if (s < 0 || s >= a) return;
  out[table][s] = rows[table][row];
}

}  // namespace

extern "C" int tb_write_balances(void* dp, void* dpo, void* cp, void* cpo,
                                 const void* slots, const void* row_dp,
                                 const void* row_dpo, const void* row_cp,
                                 const void* row_cpo, long long a, long long k,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > 0) {
    tb::Four rows{(const uint4*)row_dp, (const uint4*)row_dpo,
                  (const uint4*)row_cp, (const uint4*)row_cpo};
    tb::FourOut out{(uint4*)dp, (uint4*)dpo, (uint4*)cp, (uint4*)cpo};
    scatter_rows<<<tb::blocks_for(4 * k, 1ll << 30), tb::kThreads, 0, s>>>(
        rows, out, (const int32_t*)slots, k, a);
  }
  return (int)cudaGetLastError();
}
