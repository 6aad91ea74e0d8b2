// sharded_read: a gather of the four balance tables at global slots from
// the shards of one dp row that one card holds, for balance tables
// slot-sharded over a device mesh.
//
// Replaces the reference package's parallel/sharding.py
// make_sharded_commit_exact balance_read (:215-231, the exact route's base
// read, the psum over "shard" included) and the gather of read_balances on
// sharded state (sharded_ops.py read_balances). A slot is clipped to
// [0, A-1] first, as the reference's single-device gather does (so -1
// reads row 0, which shard 0 owns); the shard that owns the clipped row
// gives its 16-byte row. One shard owns each row, so reading each slot
// from its owner is the psum.
//
// What bounds it on the card: the launch. It moves 16 bytes a table and
// slot plus the slots: about 2 MB at 2n = 16384 slots.
//
// Design: one entry, tb_sharded_read, over a list of shards held by one
// card. parallel/sharding.py sharded_read_grouped launches it once for
// each card of the dp row, over every shard of the row that card holds
// (all of them on a virtual mesh, whose one launch gives the combined
// rows); sharded_read launches it over one shard. A thread takes one slot
// and two of its four tables, 128 threads a block (chosen with
// tools/torch_kernel_breakdown.py's launch-shape sweep, recorded in
// PERF.md): it finds the launch's shard whose rows [base, base + rows)
// hold the clipped slot (its owner, clipped / rows where the bases are
// multiples of rows, found by compares and no division) and stores that
// row, or zeros where the launch holds no owner. A launch with `overlay`
// set (a later chunk of more than kMaxShards shards, over the blocks an
// earlier chunk wrote) stores only owned rows. Shard pointers travel in
// the kernel's parameters (__grid_constant__).
#include "common.cuh"

namespace {

constexpr int kMaxShards = 32;  // parallel/sharding.py GROUP_SHARDS
constexpr int kBlock = 128;

struct Args {
  const uint4* table[kMaxShards][4];  // shard j's dp, dpo, cp, cpo
  long long base[kMaxShards];         // shard j's first global row
  int count;
  const int32_t* slots;
  uint4* out[4];
  long long rows;
  long long a;
  int k;
  bool overlay;
};

__global__ void __launch_bounds__(kBlock) read_owned(const __grid_constant__ Args g) {
  const int q = blockIdx.x * kBlock + threadIdx.x;
  if (q >= 2 * g.k) return;
  const int half = q >= g.k;  // tables 2 half and 2 half + 1
  const int i = q - half * g.k;
  long long s = g.slots[i];
  s = s < 0 ? 0 : s >= g.a ? g.a - 1 : s;
  int owner = -1;
  long long l = 0;
#pragma unroll
  for (int j = 0; j < kMaxShards; ++j) {
    if (j >= g.count) break;
    const long long lj = s - g.base[j];
    if (lj >= 0 && lj < g.rows) {
      owner = j;
      l = lj;
    }
  }
  if (owner < 0 && g.overlay) return;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = 2 * half + u;
    g.out[t][i] = owner >= 0 ? g.table[owner][t][l] : make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

// tables: a host array of 4 * count device pointers, shard j's
// (debits_pending, debits_posted, credits_pending, credits_posted) at
// [4 j, 4 j + 4), each (rows, 4) uint32 on the launch's device; bases:
// count int64, shard j's first global row; 1 <= count <= kMaxShards;
// slots (k,) int32 global; out_*: (k, 4) uint32 each; a: the global table
// length; overlay nonzero: store only the rows these shards own.
extern "C" int tb_sharded_read(void* const* tables, const long long* bases, long long count,
                               const void* slots, void* out_dp, void* out_dpo, void* out_cp,
                               void* out_cpo, long long rows, long long a, long long k,
                               long long overlay, void* stream) {
  if (count < 1 || count > kMaxShards || rows < 1 || a < 1 || k < 0 || 4 * k > (1ll << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (k == 0) return (int)cudaGetLastError();
  void* const out[4] = {out_dp, out_dpo, out_cp, out_cpo};
  Args g = {};
  for (int j = 0; j < count; ++j) {
    for (int t = 0; t < 4; ++t) g.table[j][t] = (const uint4*)tables[4 * j + t];
    g.base[j] = bases[j];
  }
  g.count = (int)count;
  g.slots = (const int32_t*)slots;
  for (int t = 0; t < 4; ++t) g.out[t] = (uint4*)out[t];
  g.rows = rows;
  g.a = a;
  g.k = (int)k;
  g.overlay = overlay != 0;
  read_owned<<<(unsigned)((2 * k + kBlock - 1) / kBlock), kBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
