// exact_sort_plan: the SortPlan of one exact-route batch, built on the card.
//
// Replaces the `plan is None` branch of the reference package's
// ops/commit_exact.py create_transfers_exact (the entry at :902; the
// branch at :474-519): a stable sort of the 2n posting records by
// (slot, chain, event index) and of the n events by fulfillment group,
// with their inverse permutations and segment-head positions.
// ops/commit_exact.py build_sort_plan is the same function on the host.
//
// What bounds it on this card: latency. The inputs are a few hundred KB
// (slots, chains, groups of n <= 8192 events) and the work is O(n) per
// radix digit, so no device-memory rate matters; what costs is the chain
// of dependent passes inside one block.
//
// Design: one launch of two blocks of 1024 threads, one per sort (block 0
// the 2n records, block 1 the n events).
//   - Each element's whole sort key is built once, from one coalesced read
//     of its event's columns, and packed into one uint64 with the
//     element's identity in its low bits:
//       records: slot or A | chain | event index | side (debit 0, credit 1),
//       events:  group or n (signed order) | chain | event index.
//     Records start in (index, side) order and events in index order, so
//     a stable sort by the bits above the index is the reference's stable
//     order; where chain_id never decreases, as on the state machine's
//     batches, the records' slot bits alone give the same order.
//   - A stable LSD radix sort with 8-bit digits over only the bits the
//     batch spans (a min/max reduction): on monotone chains A = 2^20 slots
//     take at most three passes (a batch over 10,000 accounts two), else
//     slots and chains five; the events' groups two.
//     The keys stay in registers, 16 a thread, warp-striped. A pass ranks
//     each key within its warp among the lanes of equal digit (eight
//     ballots for the records, whose digits are nearly all distinct;
//     __match_any_sync for the events, whose are nearly all equal) and a
//     per-warp histogram in shared memory; one block scan over the
//     (digit, warp) counts places the warps; the keys are exchanged
//     through shared memory (16384 x 8 bytes).
//   - The sorted keys alone give perm (their low bits) and the heads
//     (ballots over neighbouring keys: the slot or group bits change, or
//     the chain bits too, then a running maximum across warps): no second
//     read of device memory. inv_perm is gathered in shared memory and
//     written in order.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                     // keys a thread holds
constexpr int kWarpElems = 32 * kItems;        // 512 positions a warp
constexpr int kMaxElems = kThreads * kItems;   // 16384 = 2n at n = 8192
constexpr int kBins = 256;                     // 8-bit digits
constexpr int kHistStride = kBins + 1;         // a warp's histogram row
constexpr size_t kSmem = kMaxElems * sizeof(unsigned long long)  // keys
                         + kWarps * kHistStride * sizeof(int)      // histograms
                         + kMaxElems * sizeof(uint16_t);           // ranks, inv_perm

constexpr uint32_t F_POST = 1u << 2;
constexpr uint32_t F_VOID = 1u << 3;

struct In {
  const uint32_t* flags;
  const int32_t* dr_slot;
  const int32_t* cr_slot;
  const int32_t* p_dr_slot;
  const int32_t* p_cr_slot;
  const int32_t* chain_id;
  const int32_t* group;
  long long a;
  int n;
};

struct Out {
  int32_t* perm;
  int32_t* inv_perm;
  int32_t* head_pos;
  int32_t* sub_head_pos;
  int32_t* f_perm;
  int32_t* f_inv_perm;
  int32_t* f_head_pos;
  int32_t* f_sub_head_pos;
};

__shared__ int s_warp[kWarps];
__shared__ unsigned long long s_min[kWarps], s_max[kWarps];
__shared__ int s_last_head[kWarps], s_last_sub[kWarps];

__device__ __forceinline__ int nbits(unsigned x) { return x ? 32 - __clz(x) : 0; }

// Block-wide exclusive sum; every thread passes one value.
__device__ int block_excl_sum(int v) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;  // inclusive warp prefix
  }
  __syncthreads();
  int before = warp ? s_warp[warp - 1] : 0;
  __syncthreads();
  return before + x - v;
}

// The packed key of element p (ib index bits, cb chain bits).
__device__ __forceinline__ unsigned long long record_key(const In& in, int p, int ib,
                                                         int cb) {
  int e = p >> 1, side = p & 1;
  // Every column at once (no load waits on another).
  uint32_t f = __ldg(in.flags + e);
  int32_t own = __ldg((side ? in.cr_slot : in.dr_slot) + e);
  int32_t pending = __ldg((side ? in.p_cr_slot : in.p_dr_slot) + e);
  uint32_t c = (uint32_t)__ldg(in.chain_id + e);
  int32_t s = (f & (F_POST | F_VOID)) ? pending : own;
  unsigned long long slot = s >= 0 ? (unsigned long long)s : (unsigned long long)in.a;
  unsigned long long chain = c & ((1u << cb) - 1);
  return (slot << (cb + ib + 1)) | (chain << (ib + 1)) | ((unsigned long long)e << 1) |
         (unsigned long long)side;
}

__device__ __forceinline__ unsigned long long event_key(const In& in, int e, int ib,
                                                        int cb) {
  uint32_t f = __ldg(in.flags + e);
  int32_t group = __ldg(in.group + e);
  uint32_t c = (uint32_t)__ldg(in.chain_id + e);
  uint32_t g = (uint32_t)((f & (F_POST | F_VOID)) ? group : in.n) ^ 0x80000000u;  // signed order
  unsigned long long chain = c & ((1u << cb) - 1);
  return ((unsigned long long)g << (cb + ib)) | (chain << ib) | (unsigned long long)e;
}

// The lanes whose digit equals this lane's, from eight ballots: a cost
// that does not grow with the number of distinct digits, as
// __match_any_sync's does (the records' slot digits are nearly all
// distinct, the events' groups nearly all equal).
__device__ __forceinline__ unsigned match_by_ballots(unsigned d) {
  unsigned peers = 0xFFFFFFFFu;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    unsigned on = __ballot_sync(0xFFFFFFFFu, (d >> bit) & 1);
    peers &= ((d >> bit) & 1) ? on : ~on;
  }
  return peers;
}

// A key's digit at `shift` above the block's least key `kmin` (of the bits
// from `lo` up); positions past the elements take the largest digit, so
// they stay last.
__device__ __forceinline__ unsigned digit(unsigned long long k, bool valid, int lo,
                                          unsigned long long kmin, int shift) {
  return valid ? (unsigned)(((k >> lo) - kmin) >> shift) & (kBins - 1) : kBins - 1;
}

// Whether sorted position p starts a segment (the bits from seg_shift up
// change) and a sub-segment (those from sub_shift up change).
__device__ __forceinline__ void heads_at(const unsigned long long* keys, int p, int seg_shift,
                                         int sub_shift, bool& head, bool& sub) {
  unsigned long long k = keys[p], kp = p ? keys[p - 1] : 0;
  head = p == 0 || (k >> seg_shift) != (kp >> seg_shift);
  sub = head || (k >> sub_shift) != (kp >> sub_shift);
}

__global__ void __launch_bounds__(kThreads, 1) sort_plan(In in, Out out) {
  extern __shared__ unsigned long long s_keys[];  // [kMaxElems]
  int* hist = reinterpret_cast<int*>(s_keys + kMaxElems);  // [kWarps][kHistStride]
  // Each key's rank within its warp in a pass (at its position), then
  // inv_perm (by element): 16-bit, in shared memory, so that the keys
  // alone fill the registers.
  uint16_t* s_rank = reinterpret_cast<uint16_t*>(hist + kWarps * kHistStride);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool records = blockIdx.x == 0;
  const int n = in.n, m = records ? 2 * n : n;
  const int ib = nbits((unsigned)(n - 1)), cb = ib;  // index and chain < n
  // Bits below `lo` ride along; the sort orders the bits above: the group
  // of an event, (slot, chain) of a record, or its slot alone where
  // chain_id never decreases (the state machine's chains are runs of
  // consecutive events), since (slot, chain, index) then orders as
  // (slot, index). A segment starts where the bits from seg_shift up (the
  // slot, the group) change, a sub-segment also where those from
  // sub_shift up (and the chain) do.
  bool monotone = true;
  for (int e = t + 1; e < n; e += kThreads) {
    monotone &= __ldg(in.chain_id + e) >= __ldg(in.chain_id + e - 1);
  }
  monotone = __syncthreads_and(monotone);
  const int lo = records ? (monotone ? cb + ib + 1 : ib + 1) : cb + ib;
  const int seg_shift = records ? cb + ib + 1 : lo;
  const int sub_shift = records ? ib + 1 : ib;
  const unsigned imask = (1u << ib) - 1;
  int32_t* perm = records ? out.perm : out.f_perm;
  int32_t* inv_perm = records ? out.inv_perm : out.f_inv_perm;
  int32_t* head_pos = records ? out.head_pos : out.f_head_pos;
  int32_t* sub_head_pos = records ? out.sub_head_pos : out.f_sub_head_pos;

  // Warp-striped layout: item i of lane l of warp w is position
  // w * 512 + i * 32 + l, so a warp's items in order are its positions in
  // order. Positions >= m hold no element; they sort last in every pass.
  const int wbase = warp * kWarpElems;
  unsigned long long key[kItems];
  unsigned long long kmin = ~0ull, kmax = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int p = wbase + i * 32 + lane;
    key[i] = ~0ull;
    if (p < m) {
      key[i] = records ? record_key(in, p, ib, cb) : event_key(in, p, ib, cb);
      unsigned long long h = key[i] >> lo;
      kmin = min(kmin, h);
      kmax = max(kmax, h);
    }
  }
  for (int o = 16; o; o >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xFFFFFFFFu, kmin, o));
    kmax = max(kmax, __shfl_xor_sync(0xFFFFFFFFu, kmax, o));
  }
  if (lane == 0) {
    s_min[warp] = kmin;
    s_max[warp] = kmax;
  }
  __syncthreads();
  kmin = ~0ull;
  kmax = 0;
  for (int w = 0; w < kWarps; ++w) {
    kmin = min(kmin, s_min[w]);
    kmax = max(kmax, s_max[w]);
  }
  const unsigned long long span = kmax - kmin;
  const int bits = span ? 64 - __clzll((long long)span) : 0;
  const unsigned lt = (1u << lane) - 1;

  int* whist = hist + warp * kHistStride;
  for (int shift = 0; shift < bits; shift += 8) {
    for (int b = lane; b < kBins; b += 32) whist[b] = 0;
    __syncwarp();
    // Rank each key among its warp's keys of the same digit, in position
    // order.
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      unsigned d = digit(key[i], wbase + i * 32 + lane < m, lo, kmin, shift);
      unsigned peers = records ? match_by_ballots(d) : __match_any_sync(0xFFFFFFFFu, d);
      int before = __popc(peers & lt);
      int count = whist[d];
      s_rank[wbase + i * 32 + lane] = (uint16_t)(count + before);
      __syncwarp();
      if (before == 0) whist[d] = count + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // Exclusive scan of the counts in (digit, warp) order: thread t owns
    // digit t / 4 of warps 8 (t % 4) .. 8 (t % 4) + 7.
    {
      int d = t >> 2, q = (t & 3) * 8;
      int local[8];
      int run = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        local[j] = run;
        run += hist[(q + j) * kHistStride + d];
      }
      int off = block_excl_sum(run);
#pragma unroll
      for (int j = 0; j < 8; ++j) hist[(q + j) * kHistStride + d] = off + local[j];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      unsigned d = digit(key[i], wbase + i * 32 + lane < m, lo, kmin, shift);
      s_keys[whist[d] + s_rank[wbase + i * 32 + lane]] = key[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) key[i] = s_keys[wbase + i * 32 + lane];
  }
  if (bits == 0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) s_keys[wbase + i * 32 + lane] = key[i];
  }
  __syncthreads();

  // perm and inv_perm from the sorted keys' low bits (inv_perm gathered in
  // shared memory, then written in order); the head flags of position p
  // compare its key with the one before, in shared memory.
  int last_head = -1, last_sub = -1;  // the warp's last heads
#pragma unroll 4
  for (int i = 0; i < kItems; ++i) {
    int p = wbase + i * 32 + lane;
    bool head = false, sub = false;
    if (p < m) {
      unsigned long long k = s_keys[p];
      int id = records ? (int)((k >> 1) & imask) + (int)(k & 1) * n : (int)(k & imask);
      perm[p] = id;
      s_rank[id] = (uint16_t)p;
      heads_at(s_keys, p, seg_shift, sub_shift, head, sub);
    }
    unsigned hb = __ballot_sync(0xFFFFFFFFu, head), sb = __ballot_sync(0xFFFFFFFFu, sub);
    if (hb) last_head = wbase + i * 32 + 31 - __clz(hb);
    if (sb) last_sub = wbase + i * 32 + 31 - __clz(sb);
  }
  if (lane == 0) {
    s_last_head[warp] = last_head;
    s_last_sub[warp] = last_sub;
  }
  __syncthreads();
  for (int x = t; x < m; x += kThreads) inv_perm[x] = s_rank[x];
  // A running maximum: the last head of the warps before, then of the
  // rows of this warp so far.
  int carry_head = lane < warp ? s_last_head[lane] : -1;
  int carry_sub = lane < warp ? s_last_sub[lane] : -1;
  for (int o = 16; o; o >>= 1) {
    carry_head = max(carry_head, __shfl_xor_sync(0xFFFFFFFFu, carry_head, o));
    carry_sub = max(carry_sub, __shfl_xor_sync(0xFFFFFFFFu, carry_sub, o));
  }
  const unsigned le = (2u << lane) - 1;
#pragma unroll 4
  for (int i = 0; i < kItems; ++i) {
    int p = wbase + i * 32 + lane;
    bool head = false, sub = false;
    if (p < m) heads_at(s_keys, p, seg_shift, sub_shift, head, sub);
    unsigned hb = __ballot_sync(0xFFFFFFFFu, head), sb = __ballot_sync(0xFFFFFFFFu, sub);
    unsigned h = hb & le, s = sb & le;
    if (p < m) {
      head_pos[p] = h ? wbase + i * 32 + 31 - __clz(h) : carry_head;
      sub_head_pos[p] = s ? wbase + i * 32 + 31 - __clz(s) : carry_sub;
    }
    if (hb) carry_head = wbase + i * 32 + 31 - __clz(hb);
    if (sb) carry_sub = wbase + i * 32 + 31 - __clz(sb);
  }
}

bool g_smem_set[64];  // per device: the shared-memory attribute is set

}  // namespace

// ptrs: flags, dr_slot, cr_slot, p_dr_slot, p_cr_slot, chain_id, group,
// then the eight outputs in SortPlan order. dims: a, n. chain_id in
// [0, n); a < 2^32.
extern "C" int tb_exact_sort_plan(void* const* ptrs, const long long* dims,
                                  void* stream) {
  long long a = dims[0], n = dims[1];
  if (n < 1 || 2 * n > kMaxElems || a < 0 || a >= (1ll << 32)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set[dev]) {
    err = cudaFuncSetAttribute(sort_plan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    g_smem_set[dev] = true;
  }
  In in{(const uint32_t*)ptrs[0], (const int32_t*)ptrs[1],
        (const int32_t*)ptrs[2], (const int32_t*)ptrs[3],
        (const int32_t*)ptrs[4], (const int32_t*)ptrs[5],
        (const int32_t*)ptrs[6], a, (int)n};
  Out out{(int32_t*)ptrs[7],  (int32_t*)ptrs[8],  (int32_t*)ptrs[9],
          (int32_t*)ptrs[10], (int32_t*)ptrs[11], (int32_t*)ptrs[12],
          (int32_t*)ptrs[13], (int32_t*)ptrs[14]};
  sort_plan<<<2, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(in, out);
  return (int)cudaGetLastError();
}
