// register_accounts: install the ledger and flags of newly created accounts.
//
// Replaces the reference package's ops/commit.py register_accounts (:316):
// a masked scatter of ledger and flags at host-assigned slots; a row with
// mask false or a slot outside [-A, A) is dropped (mode="drop"; a negative
// slot counts from the end, as NumPy indexing does). Slots of the rows
// that install are distinct (the host assigns fresh ones).
//
// What bounds it on the card: bytes, and at a create_accounts batch's k
// (at most 8192 rows) the launch itself. The update is in place: the
// ledger and flags tables only ever gain accounts, so every state may
// share them (ops/commit.py). The kernel moves 13 bytes read and 8 bytes
// written per row, 172 KB at k = 8192.
//
// Design: one thread per row stores ledger and flags at its slot.
#include "common.cuh"

namespace {

__global__ void scatter_rows(const int32_t* __restrict__ slots,
                             const uint32_t* __restrict__ ledger,
                             const uint32_t* __restrict__ flags,
                             const bool* __restrict__ mask, long long k,
                             long long a, uint32_t* __restrict__ out_ledger,
                             uint32_t* __restrict__ out_flags) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k || !mask[i]) return;
  long long s = slots[i];
  if (s < 0) s += a;  // counts from the end, as the reference's indexing
  if (s < 0 || s >= a) return;
  out_ledger[s] = ledger[i];
  out_flags[s] = flags[i];
}

}  // namespace

extern "C" int tb_register_accounts(void* acc_ledger, void* acc_flags,
                                    const void* slots, const void* ledger,
                                    const void* flags, const void* mask,
                                    long long a, long long k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > 0) {
    scatter_rows<<<tb::blocks_for(k, 1ll << 30), tb::kThreads, 0, s>>>(
        (const int32_t*)slots, (const uint32_t*)ledger,
        (const uint32_t*)flags, (const bool*)mask, k, a, (uint32_t*)acc_ledger,
        (uint32_t*)acc_flags);
  }
  return (int)cudaGetLastError();
}
