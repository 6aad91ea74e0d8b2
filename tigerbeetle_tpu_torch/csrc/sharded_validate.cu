// sharded_validate: the fast route's validation ladder for one dp slice of
// a batch on a device mesh, without posting.
//
// Replaces the validation half of the reference package's
// parallel/sharding.py make_sharded_commit (the shard_map step, :113-176:
// validate_simple and merge_codes on the dp-sharded batch, :135-139). The
// rungs are ladder.cuh's, the same copy the single-device fast kernel runs.
//
// What bounds it on the card: neither rate. It reads the slice's events
// (about 70 bytes each) and one replicated ledger word per side, and writes
// a code and a routing byte per event: under 1 MB at n = 8192, so the
// launch dominates.
//
// Design: one thread per event of the slice [lo, lo + m) writes its code
// and a routing byte, the reference's gathered masks ok & ~pending
// (R_POST) and ok & pending (R_PEND), which sharded_apply.cu posts on every
// shard after the host gathers the dp slices. An unsupported flag on any
// event of the slice sets the slice's bail word (the reference's
// any(unsupported), psummed over the mesh by the host).
#include "common.cuh"
#include "ladder.cuh"

namespace {

using tb::fast::Batch;
using tb::fast::F_PENDING;
using tb::fast::F_UNSUPPORTED;

// Routing bits, as sharded_apply.cu reads them.
constexpr uint8_t R_PEND = 1;  // add to pending
constexpr uint8_t R_POST = 2;  // add to posted

__global__ void validate(Batch b, long long lo, long long m,
                         const uint32_t* acc_ledger, long long a,
                         uint32_t* codes, uint8_t* route, bool* bail) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  long long i = lo + j;
  uint32_t code = tb::fast::ladder(b, i, acc_ledger, a);
  codes[j] = code;
  uint32_t flags = b.flags[i];
  uint8_t r = 0;
  if (tb::fast::posts(b, i, code)) r = (flags & F_PENDING) ? R_PEND : R_POST;
  route[j] = r;
  if (flags & F_UNSUPPORTED) *bail = true;  // every writer stores the same
}

}  // namespace

// The ten TransferBatch fields and host_code are the whole batch's; the
// slice is events [lo, lo + m). codes (m,) uint32 and route (m,) uint8 are
// the slice's. a is the ledger's length.
extern "C" int tb_sharded_validate(
    const void* id, const void* dr_slot, const void* cr_slot,
    const void* amount, const void* pending_id, const void* timeout,
    const void* ledger, const void* code, const void* flags,
    const void* timestamp, const void* host_code, const void* acc_ledger,
    void* codes, void* route, void* bail, long long lo, long long m,
    long long a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Batch b{(const uint4*)id,        (const int32_t*)dr_slot,
          (const int32_t*)cr_slot, (const uint4*)amount,
          (const uint4*)pending_id, (const uint32_t*)timeout,
          (const uint32_t*)ledger, (const uint32_t*)code,
          (const uint32_t*)flags,  (const uint2*)timestamp,
          (const uint32_t*)host_code};
  bool* bail_p = static_cast<bool*>(bail);
  cudaError_t err = cudaMemsetAsync(bail_p, 0, sizeof(bool), s);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    validate<<<tb::blocks_for(m, 1ll << 30), tb::kThreads, 0, s>>>(
        b, lo, m, (const uint32_t*)acc_ledger, a, (uint32_t*)codes,
        (uint8_t*)route, bail_p);
  }
  return (int)cudaGetLastError();
}
