// sharded_apply: exact u128 posting of a whole batch into one shard of the
// balance tables, the shard owning rows [base, base + rows) of the global
// slots.
//
// Replaces the posting half of the reference package's
// parallel/sharding.py make_sharded_commit (apply_posting_streamed over the
// shard's owned sides, :141-162) and make_sharded_commit_exact's
// balance_apply (:233-268): adds into pending or posted, then the pending
// removals of post/void, then the pending + posted check.
//
// What bounds it on the card: bytes. The update is out of place, as the
// single-device kernels' (a bail keeps the old state), so the shard's four
// (rows, 4) tables are read once and written once: 32 MiB at 2^18 rows a
// shard, against about 0.3 MB of gathered events.
//
// Design, four launches on one stream:
//   1. copy_check: one thread per row copies the four tables (16-byte loads
//      and stores) and notes whether any old row's pending + posted already
//      overflows (ctrl word).
//   2. adds: one thread per event; for each side whose global slot the
//      shard owns, an exact atomic u128 add at local row slot - base into
//      pending (mask M_ADD_PEND) or posted (M_ADD_POST) (common.cuh
//      atomic_add_u128: order-independent sums and overflow flags).
//   3. subs: after every add landed, the pending removals (M_SUB_PEND) of
//      p_amount on both owned sides (atomic_sub_u128; a borrow is the
//      reference's scatter_sub underflow).
//   4. check: pending + posted of every row of the shard if an old row
//      overflowed, else of the rows this shard touched (untouched rows are
//      unchanged; a removal can cure a touched row's old overflow).
// bail = any add overflow, removal underflow or pending + posted overflow
// on this shard; the host ORs every shard's word (the reference's psum).
#include "common.cuh"

namespace {

constexpr uint8_t M_ADD_PEND = 1;
constexpr uint8_t M_ADD_POST = 2;
constexpr uint8_t M_SUB_PEND = 4;

struct Tables {
  uint4* dp;
  uint4* dpo;
  uint4* cp;
  uint4* cpo;
};

struct Events {
  const int32_t* dr;
  const int32_t* cr;
  const uint4* amount;
  const uint4* p_amount;
  const uint8_t* mask;
};

// The local row of a global slot, or -1 where this shard does not own it
// (a negative slot is never owned).
__device__ __forceinline__ long long local_row(int32_t slot, long long base,
                                               long long rows) {
  long long l = (long long)slot - base;
  return (slot >= 0 && l >= 0 && l < rows) ? l : -1;
}

__device__ __forceinline__ bool row_overflows(const Tables& t, long long r) {
  return tb::sum_overflows(t.dp[r], t.dpo[r]) |
         tb::sum_overflows(t.cp[r], t.cpo[r]);
}

__global__ void copy_check(Tables old_t, Tables new_t, long long rows,
                           uint32_t* old_over) {
  long long stride = (long long)gridDim.x * blockDim.x;
  bool over = false;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += stride) {
    uint4 dp = old_t.dp[r], dpo = old_t.dpo[r];
    uint4 cp = old_t.cp[r], cpo = old_t.cpo[r];
    new_t.dp[r] = dp;
    new_t.dpo[r] = dpo;
    new_t.cp[r] = cp;
    new_t.cpo[r] = cpo;
    over |= tb::sum_overflows(dp, dpo) | tb::sum_overflows(cp, cpo);
  }
  if (over) *old_over = 1u;  // every writer stores the same value
}

__device__ __forceinline__ void post(uint4* table, long long r, uint4 v,
                                     bool sub, bool& over) {
  if (r < 0) return;
  uint32_t* row = reinterpret_cast<uint32_t*>(table + r);
  over |= sub ? tb::atomic_sub_u128(row, v) : tb::atomic_add_u128(row, v);
}

__global__ void adds(Events e, long long n, long long base, long long rows,
                     Tables t, bool* bail) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t m = e.mask[i];
  if (!(m & (M_ADD_PEND | M_ADD_POST))) return;
  long long dl = local_row(e.dr[i], base, rows);
  long long cl = local_row(e.cr[i], base, rows);
  uint4 v = e.amount[i];
  bool over = false;
  if (m & M_ADD_PEND) {
    post(t.dp, dl, v, false, over);
    post(t.cp, cl, v, false, over);
  }
  if (m & M_ADD_POST) {
    post(t.dpo, dl, v, false, over);
    post(t.cpo, cl, v, false, over);
  }
  if (over) *bail = true;
}

__global__ void subs(Events e, long long n, long long base, long long rows,
                     Tables t, bool* bail) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !(e.mask[i] & M_SUB_PEND)) return;
  uint4 v = e.p_amount[i];
  bool over = false;
  post(t.dp, local_row(e.dr[i], base, rows), v, true, over);
  post(t.cp, local_row(e.cr[i], base, rows), v, true, over);
  if (over) *bail = true;
}

__global__ void check(Events e, long long n, long long base, long long rows,
                      Tables t, const uint32_t* old_over, bool* bail) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  bool over = false;
  if (*old_over) {
    for (long long r = tid; r < rows; r += stride) over |= row_overflows(t, r);
  } else {
    for (long long i = tid; i < n; i += stride) {
      if (!e.mask[i]) continue;
      long long side[2] = {local_row(e.dr[i], base, rows),
                           local_row(e.cr[i], base, rows)};
      for (int s = 0; s < 2; ++s) {
        if (side[s] >= 0) over |= row_overflows(t, side[s]);
      }
    }
  }
  if (over) *bail = true;
}

}  // namespace

// old/new: the shard's four (rows, 4) tables; dr, cr (n,) int32 global
// slots; amount, p_amount (n, 4) uint32 (p_amount is read only for
// M_SUB_PEND events and may be null without them); mask (n,) uint8; ctrl
// one uint32 of scratch; bail one bool.
extern "C" int tb_sharded_apply(
    const void* dp, const void* dpo, const void* cp, const void* cpo,
    void* new_dp, void* new_dpo, void* new_cp, void* new_cpo,
    const void* dr, const void* cr, const void* amount, const void* p_amount,
    const void* mask, void* ctrl, void* bail, long long base, long long rows,
    long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tables old_t{(uint4*)dp, (uint4*)dpo, (uint4*)cp, (uint4*)cpo};
  Tables new_t{(uint4*)new_dp, (uint4*)new_dpo, (uint4*)new_cp,
               (uint4*)new_cpo};
  Events e{(const int32_t*)dr, (const int32_t*)cr, (const uint4*)amount,
           (const uint4*)p_amount, (const uint8_t*)mask};
  uint32_t* old_over = static_cast<uint32_t*>(ctrl);
  bool* bail_p = static_cast<bool*>(bail);
  cudaError_t err = cudaMemsetAsync(bail_p, 0, sizeof(bool), s);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(old_over, 0, sizeof(uint32_t), s)) != cudaSuccess)
    return (int)err;
  copy_check<<<tb::blocks_for(rows), tb::kThreads, 0, s>>>(old_t, new_t, rows,
                                                            old_over);
  if (n > 0) {
    unsigned int blocks = tb::blocks_for(n, 1ll << 30);
    adds<<<blocks, tb::kThreads, 0, s>>>(e, n, base, rows, new_t, bail_p);
    subs<<<blocks, tb::kThreads, 0, s>>>(e, n, base, rows, new_t, bail_p);
  }
  check<<<tb::blocks_for(n > rows ? n : rows, 1 << 10), tb::kThreads, 0, s>>>(
      e, n, base, rows, new_t, old_over, bail_p);
  return (int)cudaGetLastError();
}
