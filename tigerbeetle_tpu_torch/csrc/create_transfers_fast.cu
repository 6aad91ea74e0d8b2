// create_transfers_fast: the validation ladder and the exact u128 posting
// of one simple-transfer batch.
//
// Replaces the reference package's ops/commit.py create_transfers_fast
// (impl create_transfers_fast_impl, :191; ladder validate_simple, :127;
// merge_codes, :104; posting apply_posting_streamed, :218, through
// u128.scatter_add, ops/u128.py:214).
//
// What bounds it on the card: bytes. The update is out of place (a bail
// keeps the old state, and the split-phase window keeps each batch's base
// state alive), so the four (A, 4) balance tables are read once and
// written once: 128 MiB at A = 2^20, against well under 1 MiB of batch.
// The reference's whole-table check (pending + posted must not overflow,
// commit.py:234-239) rides the same pass. Everything else is touched rows.
//
// Design:
//   1. copy_check: one thread per account row, 16-byte loads and stores of
//      the four tables into the new ones, and the pending + posted overflow
//      check on the OLD rows. (A touched row that overflowed before the
//      batch still overflows after it unless its own add overflowed, which
//      bails anyway; touched rows are checked again after posting in 3.)
//   2. ladder_post: one thread per event runs the ladder (ladder.cuh, shared
//      with sharded_validate.cu) in the reference's precedence order,
//      merges with host_code by nonzero minimum, writes
//      its code, and posts an OK event's amount into the new tables with
//      two exact u128 atomic adds (common.cuh atomic_add_u128). Integer
//      atomics commute, so the tables and the bail flag do not depend on
//      the order the threads run in.
//   3. touched_check: one thread per event re-checks pending + posted of
//      the rows an OK event touched, after every add of step 2 landed.
// bail = any per-row add overflow | any pending + posted overflow | any
// unsupported flag, exactly the reference's flag. It stays on the device.
#include "common.cuh"
#include "ladder.cuh"

namespace {

using tb::fast::Batch;
using tb::fast::F_PENDING;
using tb::fast::F_UNSUPPORTED;
using tb::fast::ladder;
using tb::fast::posts;

struct Tables {
  uint4* dp;
  uint4* dpo;
  uint4* cp;
  uint4* cpo;
};

// tidy: range=a:1..0x7FFFFFFF — the entry refuses A outside [1, 2^31 - 1] (int32 slots)
__global__ void copy_check(Tables old_t, Tables new_t, long long a,
                           bool* bail) {
  long long stride = (long long)gridDim.x * blockDim.x;
  bool over = false;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < a;
       r += stride) {
    uint4 dp = old_t.dp[r], dpo = old_t.dpo[r];
    uint4 cp = old_t.cp[r], cpo = old_t.cpo[r];
    new_t.dp[r] = dp;
    new_t.dpo[r] = dpo;
    new_t.cp[r] = cp;
    new_t.cpo[r] = cpo;
    over |= tb::sum_overflows(dp, dpo) | tb::sum_overflows(cp, cpo);
  }
  if (over) *bail = true;  // every writer stores the same value
}

// tidy: range=a:1..0x7FFFFFFF,n:0..0x7FFFFFFF — the entry refuses A outside [1, 2^31 - 1] (int32 slots) and n outside [0, 2^31 - 1]
__global__ void ladder_post(Batch b, long long n, const uint32_t* acc_ledger,
                            long long a, Tables t, uint32_t* codes,
                            bool* bail) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t code = ladder(b, i, acc_ledger, a);
  codes[i] = code;
  bool over = (b.flags[i] & F_UNSUPPORTED) != 0;
  if (posts(b, i, code)) {
    bool pend = (b.flags[i] & F_PENDING) != 0;
    uint4 amount = b.amount[i];
    int32_t dr = b.dr_slot[i], cr = b.cr_slot[i];
    if (dr < a)
      over |= tb::atomic_add_u128(
          reinterpret_cast<uint32_t*>((pend ? t.dp : t.dpo) + dr), amount);
    if (cr < a)
      over |= tb::atomic_add_u128(
          reinterpret_cast<uint32_t*>((pend ? t.cp : t.cpo) + cr), amount);
  }
  if (over) *bail = true;
}

// tidy: range=a:1..0x7FFFFFFF,n:0..0x7FFFFFFF — as ladder_post's
__global__ void touched_check(Batch b, long long n, long long a, Tables t,
                              const uint32_t* codes, bool* bail) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !posts(b, i, codes[i])) return;
  bool over = false;
  int32_t slots[2] = {b.dr_slot[i], b.cr_slot[i]};
  for (int s = 0; s < 2; ++s) {
    int32_t r = slots[s];
    if (r < a) {
      over |= tb::sum_overflows(t.dp[r], t.dpo[r]) |
              tb::sum_overflows(t.cp[r], t.cpo[r]);
    }
  }
  if (over) *bail = true;
}

}  // namespace

extern "C" int tb_create_transfers_fast(
    const void* dp, const void* dpo, const void* cp, const void* cpo,
    const void* acc_ledger, void* new_dp, void* new_dpo, void* new_cp,
    void* new_cpo, const void* id, const void* dr_slot, const void* cr_slot,
    const void* amount, const void* pending_id, const void* timeout,
    const void* ledger, const void* code, const void* flags,
    const void* timestamp, const void* host_code, void* codes, void* bail,
    long long a, long long n, void* stream) {
  // A rows addressed by int32 slots, a batch below 2^31 events: the
  // kernels' contract (ladder.cuh).
  if (a < 1 || a > 0x7FFFFFFF || n < 0 || n > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tables old_t{(uint4*)dp, (uint4*)dpo, (uint4*)cp, (uint4*)cpo};
  Tables new_t{(uint4*)new_dp, (uint4*)new_dpo, (uint4*)new_cp,
               (uint4*)new_cpo};
  Batch b{(const uint4*)id,        (const int32_t*)dr_slot,
          (const int32_t*)cr_slot, (const uint4*)amount,
          (const uint4*)pending_id, (const uint32_t*)timeout,
          (const uint32_t*)ledger, (const uint32_t*)code,
          (const uint32_t*)flags,  (const uint2*)timestamp,
          (const uint32_t*)host_code};
  bool* bail_p = static_cast<bool*>(bail);
  cudaError_t err = cudaMemsetAsync(bail_p, 0, sizeof(bool), s);
  if (err != cudaSuccess) return (int)err;
  copy_check<<<tb::blocks_for(a), tb::kThreads, 0, s>>>(old_t, new_t, a,
                                                         bail_p);
  if (n > 0) {
    ladder_post<<<tb::blocks_for(n, 1ll << 30), tb::kThreads, 0, s>>>(
        b, n, (const uint32_t*)acc_ledger, a, new_t, (uint32_t*)codes,
        bail_p);
    touched_check<<<tb::blocks_for(n, 1ll << 30), tb::kThreads, 0, s>>>(
        b, n, a, new_t, (const uint32_t*)codes, bail_p);
  }
  return (int)cudaGetLastError();
}
