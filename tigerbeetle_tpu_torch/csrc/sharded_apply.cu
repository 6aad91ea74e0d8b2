// sharded_apply: exact u128 posting of a whole batch into the shards of the
// balance tables that one card holds, each shard owning rows [base, base +
// rows) of the global slots.
//
// Replaces the posting half of the reference package's
// parallel/sharding.py make_sharded_commit (apply_posting_streamed over the
// shard's owned sides, :141-162) and make_sharded_commit_exact's
// balance_apply (:233-268): adds into pending or posted, then the pending
// removals of post/void, then the pending + posted check. On a mesh every
// device runs that step for its shard; parallel/sharding.py
// sharded_apply_grouped launches tb_sharded_apply_grouped once for each
// distinct device, over every shard that device holds (a virtual mesh puts
// all of them on one card), and tb_sharded_apply is the one-shard case of
// the same kernel.
//
// What bounds it on the card: bytes. The update is out of place, as the
// single-device kernels' (a bail keeps the old state), so each shard's four
// (rows, 4) tables are read once and written once: 32 MiB at 2^18 rows a
// shard, against about 0.3 MB of gathered events, which every shard of a
// launch reads from one copy. A launch a shard paid the launch floor and
// three barriers once for each shard.
//
// Design: one cooperative launch (every block resident) in four phases,
// separated by grid barriers:
//   1. copy: a grid-stride loop over each shard's rows copies the four
//      tables (16-byte loads and stores, four rows a thread in flight:
//      sixteen loads before the stores) and notes whether any old
//      row's pending + posted already overflows: one bit a shard, OR-ed
//      over the block in shared memory and stored as the block's word of
//      scratch (every block stores its word, so no word needs clearing).
//      Block 0 clears the bail word; nothing else writes it before the
//      barrier.
//   2. adds: one thread per (event, shard) pair, events fastest, so a warp
//      reads consecutive events of one shard; a thread reads its first
//      pair before the copy, so phases 2-4 start from registers. For each
//      side whose global slot the shard owns, an exact atomic u128 add at
//      local row slot - base into pending (mask M_ADD_PEND) or posted
//      (M_ADD_POST) (common.cuh atomic_add_u128: order-independent sums
//      and overflow flags).
//   3. subs: after every add landed, the pending removals (M_SUB_PEND) of
//      p_amount on both owned sides (atomic_sub_u128; a borrow is the
//      reference's scatter_sub underflow). None, and no barrier, without
//      p_amount.
//   4. check: each block ORs the blocks' words into the shards' old-overflow
//      bits; pending + posted of every row of each shard whose bit is set,
//      and of the rows each other shard touched (untouched rows are
//      unchanged; a removal can cure a touched row's old overflow).
// bail = any add overflow, removal underflow or pending + posted overflow
// on any shard of the launch (the reference's psum over its shards), or an
// event whose mask carries M_UNSUPPORTED (the fast route's validation marks
// an unsupported flag so; read in phase 2 with the adds' masks).
// Shard pointers travel in the kernel's parameters (__grid_constant__), at
// most kMaxShards a launch; the wrapper launches a longer list in chunks.
// Two blocks of 256 threads an SM: a grid barrier's cost grows with the
// blocks it waits for, and the copy's four rows a thread keep 128 KB of
// loads in flight an SM.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint8_t M_ADD_PEND = 1;
constexpr uint8_t M_ADD_POST = 2;
constexpr uint8_t M_SUB_PEND = 4;
constexpr uint8_t M_UNSUPPORTED = 8;  // csrc/sharded_validate.cu R_UNSUPPORTED: bail
constexpr int kMaxShards = 32;   // parallel/sharding.py GROUP_SHARDS
constexpr int kBlock = 256;
constexpr int kBlocksPerSm = 2;  // fewer blocks, cheaper grid barriers
constexpr int kInFlight = 4;     // rows a thread copies at once
constexpr int kMaxGrid = 2048;   // words of scratch (parallel/sharding.py APPLY_SCRATCH_WORDS)

struct Tables {
  uint4* dp;
  uint4* dpo;
  uint4* cp;
  uint4* cpo;
};

struct Shard {
  Tables old_t;
  Tables new_t;
  long long base;
};

template <int N>
struct Args {
  Shard shard[N];
  int count;
  const int32_t* dr;
  const int32_t* cr;
  const uint4* amount;
  const uint4* p_amount;  // null: no removals
  const uint8_t* mask;
  uint32_t* block_over;  // one word a block: bit j, an old row of shard j overflows
  bool* bail;
  long long rows;
  long long n;
};

// The local row of a global slot, or -1 where the shard at `base` does not
// own it (a negative slot is never owned).
__device__ __forceinline__ int local_row(int32_t slot, long long base, int rows) {
  long long l = (long long)slot - base;
  return (slot >= 0 && l >= 0 && l < rows) ? (int)l : -1;
}

__device__ __forceinline__ bool row_overflows(const Tables& t, int r) {
  return tb::sum_overflows(t.dp[r], t.dpo[r]) |
         tb::sum_overflows(t.cp[r], t.cpo[r]);
}

__device__ __forceinline__ void post(uint4* table, int r, uint4 v,
                                     bool sub, bool& over) {
  if (r < 0) return;
  uint32_t* row = reinterpret_cast<uint32_t*>(table + r);
  over |= sub ? tb::atomic_sub_u128(row, v) : tb::atomic_add_u128(row, v);
}

// One (event, shard) pair: the shard j, the event's mask (M_UNSUPPORTED
// alone where the shard owns neither side), both sides' local rows (-1: not the shard's)
// and the amounts (p_amount's zero without removals).
struct Pair {
  int j;
  uint32_t m;
  int dl, cl;
  uint4 v, pv;
};

template <int N>
__device__ __forceinline__ Pair load_pair(const Args<N>& a, int e, int n, int rows) {
  Pair p;
  p.j = e / n;
  const int i = e - p.j * n;
  const long long base = a.shard[p.j].base;
  // every load issued at once: none waits for the mask
  p.m = a.mask[i];
  p.dl = local_row(a.dr[i], base, rows);
  p.cl = local_row(a.cr[i], base, rows);
  p.v = a.amount[i];
  p.pv = a.p_amount != nullptr ? a.p_amount[i] : make_uint4(0, 0, 0, 0);
  if (p.dl < 0 && p.cl < 0) p.m &= M_UNSUPPORTED;
  return p;
}

template <int N>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
    apply(const __grid_constant__ Args<N> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ uint32_t s_over, s_old;
  const int count = N == 1 ? 1 : a.count;
  // 32-bit indices: the launch holds rows and n * count below 2^30.
  const int tid = blockIdx.x * kBlock + threadIdx.x;
  const int stride = gridDim.x * kBlock;
  const int rows = (int)a.rows, n = (int)a.n;
  const int pairs = n * count;
  if (threadIdx.x == 0) {
    s_over = 0;
    s_old = 0;
  }
  if (tid == 0) *a.bail = false;
  // A thread's first pair, read before the copy so that its loads land
  // during it (phases 2-4 take it from registers).
  const Pair first = tid < pairs ? load_pair(a, tid, n, rows) : Pair{0, 0, -1, -1, {}, {}};
  auto pair_at = [&](int e) { return e == tid ? first : load_pair(a, e, n, rows); };
  __syncthreads();

  // 1. copy, and the old rows' overflow bits: kInFlight rows a thread,
  // their loads issued before any store.
  uint32_t over = 0;
  for (int j = 0; j < count; ++j) {
    const Tables& o = a.shard[j].old_t;
    const Tables& w = a.shard[j].new_t;
    bool any = false;
    for (int r0 = tid; r0 < rows; r0 += kInFlight * stride) {
      uint4 v[kInFlight][4];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int r = r0 + u * stride;
        if (r < rows) {
          v[u][0] = o.dp[r];
          v[u][1] = o.dpo[r];
          v[u][2] = o.cp[r];
          v[u][3] = o.cpo[r];
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int r = r0 + u * stride;
        if (r < rows) {
          w.dp[r] = v[u][0];
          w.dpo[r] = v[u][1];
          w.cp[r] = v[u][2];
          w.cpo[r] = v[u][3];
          any |= tb::sum_overflows(v[u][0], v[u][1]) | tb::sum_overflows(v[u][2], v[u][3]);
        }
      }
    }
    if (any) over |= 1u << j;
  }
  over = __reduce_or_sync(0xFFFFFFFFu, over);
  if ((threadIdx.x & 31) == 0 && over) atomicOr(&s_over, over);
  __syncthreads();
  if (threadIdx.x == 0) a.block_over[blockIdx.x] = s_over;
  grid.sync();

  // 2. adds, one (event, shard) pair a thread.
  bool bad = false;
  for (int e = tid; e < pairs; e += stride) {
    const Pair p = pair_at(e);
    bad |= (p.m & M_UNSUPPORTED) != 0;
    if (!(p.m & (M_ADD_PEND | M_ADD_POST))) continue;
    const Tables& t = a.shard[p.j].new_t;
    if (p.m & M_ADD_PEND) {
      post(t.dp, p.dl, p.v, false, bad);
      post(t.cp, p.cl, p.v, false, bad);
    }
    if (p.m & M_ADD_POST) {
      post(t.dpo, p.dl, p.v, false, bad);
      post(t.cpo, p.cl, p.v, false, bad);
    }
  }
  grid.sync();

  // 3. removals, once every add has landed (none, and no barrier, without
  // p_amount: a launch-wide choice).
  if (a.p_amount != nullptr) {
    for (int e = tid; e < pairs; e += stride) {
      const Pair p = pair_at(e);
      if (!(p.m & M_SUB_PEND)) continue;
      const Tables& t = a.shard[p.j].new_t;
      post(t.dp, p.dl, p.pv, true, bad);
      post(t.cp, p.cl, p.pv, true, bad);
    }
    grid.sync();
  }

  // 4. the pending + posted check: every row of a shard with an old
  // overflow, the touched rows of the others.
  uint32_t old = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kBlock) old |= a.block_over[b];
  old = __reduce_or_sync(0xFFFFFFFFu, old);
  if ((threadIdx.x & 31) == 0 && old) atomicOr(&s_old, old);
  __syncthreads();
  old = s_old;
  for (int j = 0; j < count; ++j) {
    if (!((old >> j) & 1)) continue;
    const Tables& w = a.shard[j].new_t;
    for (int r = tid; r < rows; r += stride) bad |= row_overflows(w, r);
  }
  if (old != (count == 32 ? 0xFFFFFFFFu : (1u << count) - 1)) {
    for (int e = tid; e < pairs; e += stride) {
      const Pair p = pair_at(e);
      if (((old >> p.j) & 1) || !(p.m & ~M_UNSUPPORTED)) continue;
      const Tables& t = a.shard[p.j].new_t;
      if (p.dl >= 0) bad |= row_overflows(t, p.dl);
      if (p.cl >= 0) bad |= row_overflows(t, p.cl);
    }
  }
  if (bad) *a.bail = true;  // every writer stores the same value
}

struct Residency {
  bool ready = false;
  int blocks = 0;  // co-resident blocks of the kernel on the device
};
Residency g_resident[64][2];  // [device][one shard, a group]

template <int N>
int launch(Args<N>& args, void* stream) {
  if (args.rows < 1 || args.n < 0 || args.rows > (1ll << 30) ||
      args.n * args.count > (1ll << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  Residency& r = g_resident[dev][N == 1 ? 0 : 1];
  if (!r.ready) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, apply<N>, kBlock, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    long long blocks = (long long)sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
    r.blocks = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
    r.ready = true;
  }
  // Enough blocks for a row or a pair a thread, at most every resident one.
  long long work = args.rows > args.n * args.count ? args.rows : args.n * args.count;
  long long want = (work + kBlock - 1) / kBlock;
  int grid = (int)(want < r.blocks ? want : r.blocks);
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)apply<N>, dim3(grid), dim3(kBlock), kargs, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// old/new: the shard's four (rows, 4) tables; dr, cr (n,) int32 global
// slots; amount, p_amount (n, 4) uint32 (p_amount null: no removals); mask
// (n,) uint8; scratch: kMaxGrid uint32 words; bail one bool.
extern "C" int tb_sharded_apply(
    const void* dp, const void* dpo, const void* cp, const void* cpo,
    void* new_dp, void* new_dpo, void* new_cp, void* new_cpo,
    const void* dr, const void* cr, const void* amount, const void* p_amount,
    const void* mask, void* scratch, void* bail, long long base, long long rows,
    long long n, void* stream) {
  Args<1> a = {};
  a.shard[0] = {{(uint4*)dp, (uint4*)dpo, (uint4*)cp, (uint4*)cpo},
                {(uint4*)new_dp, (uint4*)new_dpo, (uint4*)new_cp, (uint4*)new_cpo},
                base};
  a.count = 1;
  a.dr = (const int32_t*)dr;
  a.cr = (const int32_t*)cr;
  a.amount = (const uint4*)amount;
  a.p_amount = (const uint4*)p_amount;
  a.mask = (const uint8_t*)mask;
  a.block_over = (uint32_t*)scratch;
  a.bail = (bool*)bail;
  a.rows = rows;
  a.n = n;
  return launch(a, stream);
}

// old_tables, new_tables: host arrays of 4 * count device pointers, shard
// j's (debits_pending, debits_posted, credits_pending, credits_posted) at
// [4 j, 4 j + 4), each a (rows, 4) uint32 table on the launch's device;
// bases: count int64; 1 <= count <= kMaxShards; the rest as
// tb_sharded_apply.
extern "C" int tb_sharded_apply_grouped(
    void* const* old_tables, void* const* new_tables, const long long* bases,
    long long count, const void* dr, const void* cr, const void* amount,
    const void* p_amount, const void* mask, void* scratch, void* bail,
    long long rows, long long n, void* stream) {
  if (count < 1 || count > kMaxShards) return (int)cudaErrorInvalidValue;
  Args<kMaxShards> a = {};
  for (int j = 0; j < count; ++j) {
    uint4* const* o = reinterpret_cast<uint4* const*>(old_tables + 4 * j);
    uint4* const* w = reinterpret_cast<uint4* const*>(new_tables + 4 * j);
    a.shard[j] = {{o[0], o[1], o[2], o[3]}, {w[0], w[1], w[2], w[3]}, bases[j]};
  }
  a.count = (int)count;
  a.dr = (const int32_t*)dr;
  a.cr = (const int32_t*)cr;
  a.amount = (const uint4*)amount;
  a.p_amount = (const uint4*)p_amount;
  a.mask = (const uint8_t*)mask;
  a.block_over = (uint32_t*)scratch;
  a.bail = (bool*)bail;
  a.rows = rows;
  a.n = n;
  return launch(a, stream);
}
