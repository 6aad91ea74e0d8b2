// register_accounts: install the ledger and flags of newly created accounts,
// into one table or into every replicated table of one card.
//
// Replaces the reference package's ops/commit.py register_accounts (:316):
// a masked scatter of ledger and flags at host-assigned slots; a row with
// mask false or a slot outside [-A, A) is dropped (mode="drop"; a negative
// slot counts from the end, as NumPy indexing does). Slots of the rows
// that install are distinct (the host assigns fresh ones). And its
// parallel/sharding.py register_accounts_sharded (:295): on a mesh, every
// device holds its own copy of the accounts' ledger and flags (A,), and
// registration is the same scatter into each. The mesh's wrapper
// (parallel/sharding.py register_accounts_grouped) launches
// tb_register_accounts_sharded once for each distinct device, over the
// tables that device holds; a virtual mesh puts all of them on one card.
//
// What bounds it on the card: bytes, 13 a row read and 8 a row and table
// written (172 KB at k = 8192 into one table, 0.63 MB into 8), and at a
// create_accounts batch's k (at most 8192 rows) the launch itself; a
// launch a table paid that floor once per table. The update is in place:
// the ledger and flags tables only ever gain accounts, so every state may
// share them (ops/commit.py).
//
// Design: one thread per row reads its slot, ledger, flags and mask once
// and stores ledger and flags into every table of the launch. The tables'
// pointers travel in the kernel's parameters, at most kMaxTables a launch
// (the wrapper launches a longer list in chunks); the loop over them is
// unrolled, so each pointer is a constant-bank operand. Blocks of kBlock
// threads spread a batch's rows over many SMs, since each thread stores 2
// words a table to scattered sectors.
#include "common.cuh"

namespace {

constexpr int kMaxTables = 32;  // parallel/sharding.py GROUP_TABLES
constexpr int kBlock = 64;

template <int N>
struct Tables {
  uint32_t* ledger[N];
  uint32_t* flags[N];
};

template <int N>
__global__ void scatter_tables(const __grid_constant__ Tables<N> tables, int count,
                               const int32_t* __restrict__ slots,
                               const uint32_t* __restrict__ ledger,
                               const uint32_t* __restrict__ flags,
                               const bool* __restrict__ mask, long long k,
                               long long a) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k || !mask[i]) return;
  long long s = slots[i];
  if (s < 0) s += a;  // counts from the end, as the reference's indexing
  if (s < 0 || s >= a) return;
  const uint32_t l = ledger[i], f = flags[i];
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (t < count) {
      tables.ledger[t][s] = l;
      tables.flags[t][s] = f;
    }
  }
}

template <int N>
int scatter(const Tables<N>& t, int count, const void* slots, const void* ledger,
            const void* flags, const void* mask, long long a, long long k, void* stream) {
  if (a < 0 || k < 0 || k > (1ll << 36)) return (int)cudaErrorInvalidValue;
  if (k > 0) {
    scatter_tables<N><<<(unsigned)((k + kBlock - 1) / kBlock), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        t, count, (const int32_t*)slots, (const uint32_t*)ledger,
        (const uint32_t*)flags, (const bool*)mask, k, a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// acc_ledger, acc_flags (a,) uint32; slots (k,) int32, ledger and flags
// (k,) uint32, mask (k,) bool.
extern "C" int tb_register_accounts(void* acc_ledger, void* acc_flags,
                                    const void* slots, const void* ledger,
                                    const void* flags, const void* mask,
                                    long long a, long long k, void* stream) {
  const Tables<1> t = {{static_cast<uint32_t*>(acc_ledger)},
                       {static_cast<uint32_t*>(acc_flags)}};
  return scatter(t, 1, slots, ledger, flags, mask, a, k, stream);
}

// ledgers, flags_out: host arrays of `count` device pointers, each an (a,)
// uint32 table on the launch's device, 1 <= count <= kMaxTables; the rest
// as tb_register_accounts.
extern "C" int tb_register_accounts_sharded(void* const* ledgers,
                                            void* const* flags_out,
                                            long long count, const void* slots,
                                            const void* ledger,
                                            const void* flags, const void* mask,
                                            long long a, long long k,
                                            void* stream) {
  if (count < 1 || count > kMaxTables) return (int)cudaErrorInvalidValue;
  Tables<kMaxTables> t = {};
  for (int i = 0; i < count; ++i) {
    t.ledger[i] = static_cast<uint32_t*>(ledgers[i]);
    t.flags[i] = static_cast<uint32_t*>(flags_out[i]);
  }
  return scatter(t, (int)count, slots, ledger, flags, mask, a, k, stream);
}
