// sharded_read: one shard's part of a gather of the four balance tables at
// global slots, for balance tables slot-sharded over a device mesh.
//
// Replaces the reference package's parallel/sharding.py
// make_sharded_commit_exact balance_read (:215-231, the exact route's base
// read) and the gather of read_balances on sharded state (sharded_ops.py
// read_balances). A slot is clipped to [0, A-1] first, as the reference's
// single-device gather does (so -1 reads row 0, which shard 0 owns); the
// shard that owns the clipped row returns its 16-byte row, every other
// shard zeros. One shard owns each row, so the OR of the shards' blocks (the
// host's combine) equals the reference's psum over the shard axis.
//
// What bounds it on the card: the launch. It moves 16 bytes a table and
// slot plus the slots: about 2 MB at 2n = 16384 slots.
//
// Design: one thread per (table, slot).
#include "common.cuh"

namespace {

__global__ void read_owned(tb::Four t, const int32_t* __restrict__ slots,
                           tb::FourOut out, long long k, long long base,
                           long long rows, long long a) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4 * k) return;
  int table = (int)(i / k);
  long long j = i - (long long)table * k;
  long long s = slots[j];
  s = s < 0 ? 0 : s >= a ? a - 1 : s;
  long long l = s - base;
  out[table][j] = (l >= 0 && l < rows) ? t[table][l] : make_uint4(0, 0, 0, 0);
}

}  // namespace

// dp, dpo, cp, cpo: the shard's (rows, 4) tables; slots (k,) int32 global;
// out_*: (k, 4) uint32 each. base: the shard's first global row; a: the
// global table length.
extern "C" int tb_sharded_read(const void* dp, const void* dpo,
                               const void* cp, const void* cpo,
                               const void* slots, void* out_dp,
                               void* out_dpo, void* out_cp, void* out_cpo,
                               long long base, long long rows, long long a,
                               long long k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > 0) {
    tb::Four t{(const uint4*)dp, (const uint4*)dpo, (const uint4*)cp,
               (const uint4*)cpo};
    tb::FourOut out{(uint4*)out_dp, (uint4*)out_dpo, (uint4*)out_cp,
                    (uint4*)out_cpo};
    read_owned<<<tb::blocks_for(4 * k, 1ll << 30), tb::kThreads, 0, s>>>(
        t, (const int32_t*)slots, out, k, base, rows, a);
  }
  return (int)cudaGetLastError();
}
