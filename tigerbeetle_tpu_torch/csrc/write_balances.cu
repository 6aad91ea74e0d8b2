// write_balances: scatter exact balances into the four balance tables of
// one table, or of every shard of one card.
//
// Replaces the reference package's ops/commit.py write_balances (:334), the
// serial route's writeback: four (k, 4) uint32 blocks land at their slots,
// and a row whose slot lies outside [-A, A) is dropped (mode="drop"; the
// host pads with slot = A; a negative slot counts from the end). Slots of
// the rows that land are distinct (one row per account the serial route
// touched). And the writeback of its parallel/sharded_ops.py
// write_balances on slot-sharded state: each shard takes the rows whose
// normalized slot lies in its rows [base, base + rows); the dp replicas
// of a shard each take them. The mesh's wrapper (parallel/sharding.py
// write_balances_grouped) launches tb_write_balances_sharded once for
// each distinct device, over the tables that device holds; a virtual mesh
// puts all of them on one card.
//
// What bounds it on the card: bytes, and at the serial route's k (at most
// 16384 rows) the launch itself; a launch a table paid that floor once per
// table. The update is in place: the state machine writes back only into
// its current tables, which no dispatched batch holds as its base
// (ops/commit.py), so the kernel moves the rows and nothing else: k * (4
// + 64) bytes read and 64 written a landed row and table (2.2 MB at k =
// 16384 into one table).
//
// Design: one thread per row reads its slot and its four 16-byte rows
// once, normalizes the slot against the global length A, and stores the
// rows into every table of the launch whose rows hold it. The tables'
// pointers and bases travel in the kernel's parameters (__grid_constant__),
// at most kMaxTables a launch (the wrapper launches a longer list in
// chunks); the loop over them is unrolled. No memset; the ledger and flags
// are not read.
#include "common.cuh"

namespace {

constexpr int kMaxTables = 32;  // parallel/sharding.py GROUP_TABLES
constexpr int kBlock = 64;

template <int N>
struct Tables {
  uint4* t[N][4];  // table j's debits_pending, debits_posted, credits_pending, credits_posted
  long long base[N];
};

template <int N>
__global__ void __launch_bounds__(kBlock)
scatter_rows(const __grid_constant__ Tables<N> tables, int count, tb::Four rows,
             const int32_t* __restrict__ slots, long long k, long long rows_per, long long a) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= k) return;
  long long s = slots[i];
  if (s < 0) s += a;  // counts from the end, as the reference's indexing
  if (s < 0 || s >= a) return;
  const uint4 r0 = rows[0][i], r1 = rows[1][i], r2 = rows[2][i], r3 = rows[3][i];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < count) {
      const long long l = s - tables.base[j];
      if (l >= 0 && l < rows_per) {
        tables.t[j][0][l] = r0;
        tables.t[j][1][l] = r1;
        tables.t[j][2][l] = r2;
        tables.t[j][3][l] = r3;
      }
    }
  }
}

template <int N>
int scatter(const Tables<N>& t, int count, const void* slots, const void* row_dp,
            const void* row_dpo, const void* row_cp, const void* row_cpo, long long rows_per,
            long long a, long long k, void* stream) {
  if (rows_per < 1 || a < 1 || k < 0 || k > (1ll << 36)) return (int)cudaErrorInvalidValue;
  if (k > 0) {
    const tb::Four rows{(const uint4*)row_dp, (const uint4*)row_dpo, (const uint4*)row_cp,
                        (const uint4*)row_cpo};
    scatter_rows<N><<<(unsigned)((k + kBlock - 1) / kBlock), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(t, count, rows, (const int32_t*)slots,
                                                           k, rows_per, a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dp, dpo, cp, cpo: (a, 4) uint32 tables; slots (k,) int32; row_*: (k, 4)
// uint32 each.
extern "C" int tb_write_balances(void* dp, void* dpo, void* cp, void* cpo, const void* slots,
                                 const void* row_dp, const void* row_dpo, const void* row_cp,
                                 const void* row_cpo, long long a, long long k, void* stream) {
  const Tables<1> t = {{{(uint4*)dp, (uint4*)dpo, (uint4*)cp, (uint4*)cpo}}, {0}};
  return scatter(t, 1, slots, row_dp, row_dpo, row_cp, row_cpo, a, a, k, stream);
}

// tables: a host array of 4 * count device pointers, table j's
// (debits_pending, debits_posted, credits_pending, credits_posted) at
// [4 j, 4 j + 4), each (rows, 4) uint32 on the launch's device; bases:
// count int64, table j's first global row; 1 <= count <= kMaxTables; a:
// the global table length; the rest as tb_write_balances.
extern "C" int tb_write_balances_sharded(void* const* tables, const long long* bases,
                                         long long count, const void* slots,
                                         const void* row_dp, const void* row_dpo,
                                         const void* row_cp, const void* row_cpo,
                                         long long rows, long long a, long long k,
                                         void* stream) {
  if (count < 1 || count > kMaxTables) return (int)cudaErrorInvalidValue;
  Tables<kMaxTables> t = {};
  for (int j = 0; j < count; ++j) {
    for (int f = 0; f < 4; ++f) t.t[j][f] = static_cast<uint4*>(tables[4 * j + f]);
    t.base[j] = bases[j];
  }
  return scatter(t, (int)count, slots, row_dp, row_dpo, row_cp, row_cpo, rows, a, k, stream);
}
