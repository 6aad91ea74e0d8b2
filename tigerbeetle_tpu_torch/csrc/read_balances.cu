// read_balances: gather the four balance tables at a batch of slots.
//
// Replaces the reference package's ops/commit.py read_balances (:353):
// slots are clipped to [0, A-1], and each of the four (A, 4) uint32 tables
// yields a (k, 4) block. k is the host's power-of-two bucket (>= 16).
//
// What bounds it on the card: bytes, and few of them — 16 bytes read and
// written per (table, row) plus the slots: under 1 MiB at k = 8192, so at
// the main path's sizes the launch itself dominates.
//
// Design: one thread per (table, row), one 16-byte load and one 16-byte
// store; consecutive threads take consecutive rows of one table, so the
// stores coalesce.
#include "common.cuh"

namespace {

__global__ void gather_rows(tb::Four in, tb::FourOut out,
                            const int32_t* __restrict__ slots, long long k,
                            long long a) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4 * k) return;
  int table = (int)(i / k);
  long long row = i - (long long)table * k;
  long long s = slots[row];
  s = s < 0 ? 0 : (s >= a ? a - 1 : s);
  out[table][row] = in[table][s];
}

}  // namespace

extern "C" int tb_read_balances(const void* dp, const void* dpo,
                                const void* cp, const void* cpo,
                                const void* slots, void* out_dp,
                                void* out_dpo, void* out_cp, void* out_cpo,
                                long long a, long long k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tb::Four in{(const uint4*)dp, (const uint4*)dpo, (const uint4*)cp,
              (const uint4*)cpo};
  tb::FourOut out{(uint4*)out_dp, (uint4*)out_dpo, (uint4*)out_cp,
                  (uint4*)out_cpo};
  if (k > 0) {
    gather_rows<<<tb::blocks_for(4 * k, 1ll << 30), tb::kThreads, 0, s>>>(
        in, out, (const int32_t*)slots, k, a);
  }
  return (int)cudaGetLastError();
}
