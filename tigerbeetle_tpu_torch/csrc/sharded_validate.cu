// sharded_validate: the fast route's validation ladder for the dp slices of
// a batch that one card validates on a device mesh, without posting.
//
// Replaces the validation half of the reference package's
// parallel/sharding.py make_sharded_commit (the shard_map step, :113-176:
// validate_simple and merge_codes on the dp-sharded batch, :135-139, and
// the all_gather over dp of its masks, :141-143). The rungs are
// ladder.cuh's, the same copy the single-device fast kernel runs.
//
// What bounds it on the card: neither rate. It reads the slices' events
// (84 bytes each) and one replicated ledger word per side, and writes a
// code and a routing byte per event: under 1 MB at n = 8192, so the
// launch dominates.
//
// Design: one launch over the events [lo, lo + k) of the batch: the dp
// slices one card validates, which follow each other in the batch
// (parallel/sharding.py sharded_validate_grouped; sharded_validate runs
// one slice), so the codes and routing bytes land in the card's gathered
// layout and the host gathers nothing on one card. One event a thread,
// kBlock threads a block, chosen with tools/torch_kernel_breakdown.py's
// launch-shape sweep (recorded in PERF.md): 64 blocks at n = 8192. The
// routing byte holds the reference's gathered masks ok & pending (R_PEND)
// and ok & ~pending (R_POST), and R_UNSUPPORTED where the event carries
// an unsupported flag: the posting (csrc/sharded_apply.cu), which reads
// every routing byte, ORs that bit into its bail (the reference's
// any(unsupported), psummed over the mesh), so there is no bail word and
// no memset before the launch.
#include "common.cuh"
#include "ladder.cuh"

namespace {

using tb::fast::Batch;
using tb::fast::F_PENDING;
using tb::fast::F_UNSUPPORTED;

// Routing bits, as sharded_apply.cu reads them.
constexpr uint8_t R_PEND = 1;         // add to pending
constexpr uint8_t R_POST = 2;         // add to posted
constexpr uint8_t R_UNSUPPORTED = 8;  // bail
constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    validate(Batch b, long long lo, int k, const uint32_t* acc_ledger, long long a,
             uint32_t* codes, uint8_t* route) {
  const int j = blockIdx.x * kBlock + threadIdx.x;
  if (j >= k) return;
  const long long i = lo + j;
  const uint32_t code = tb::fast::ladder(b, i, acc_ledger, a);
  const uint32_t flags = b.flags[i];
  uint8_t r = (flags & F_UNSUPPORTED) ? R_UNSUPPORTED : 0;
  if (tb::fast::posts(b, i, code)) r = (flags & F_PENDING) ? R_PEND : R_POST;
  codes[j] = code;
  route[j] = r;
}

}  // namespace

// The ten TransferBatch fields and host_code are the whole batch's; the
// events validated are [lo, lo + k). codes (k,) uint32 and route (k,)
// uint8 are theirs, in order. a is the ledger's length.
extern "C" int tb_sharded_validate(
    const void* id, const void* dr_slot, const void* cr_slot,
    const void* amount, const void* pending_id, const void* timeout,
    const void* ledger, const void* code, const void* flags,
    const void* timestamp, const void* host_code, const void* acc_ledger,
    void* codes, void* route, long long lo, long long k, long long a,
    void* stream) {
  if (lo < 0 || k < 0 || k > (1ll << 30)) return (int)cudaErrorInvalidValue;
  const Batch b{(const uint4*)id,         (const int32_t*)dr_slot,
                (const int32_t*)cr_slot,  (const uint4*)amount,
                (const uint4*)pending_id, (const uint32_t*)timeout,
                (const uint32_t*)ledger,  (const uint32_t*)code,
                (const uint32_t*)flags,   (const uint2*)timestamp,
                (const uint32_t*)host_code};
  if (k > 0) {
    validate<<<(unsigned)((k + kBlock - 1) / kBlock), kBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(b, lo, (int)k, (const uint32_t*)acc_ledger,
                                                    a, (uint32_t*)codes, (uint8_t*)route);
  }
  return (int)cudaGetLastError();
}
