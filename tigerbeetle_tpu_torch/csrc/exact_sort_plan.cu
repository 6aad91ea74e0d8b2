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
// Design: two blocks of 1024 threads, one per sort (block 0 the 2n records,
// block 1 the n events), each a stable LSD radix sort in shared memory
// with 4-bit digits. Each key is an int32, mapped to unsigned order and
// offset by its minimum (a block reduction), so a pass runs only for the
// digits the batch's keys actually use: slots below A = 2^20 take six,
// chains and indices below 8192 four each. A pass: each thread counts the
// digits of its contiguous chunk, one block scan over the (digit, thread)
// counts gives every element its place, and each thread writes its chunk
// in order, so equal digits keep their order (stable). Segment heads are
// then a block-wide running maximum, as build_sort_plan's
// np.maximum.accumulate.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kBins = 16;
constexpr int kMaxElems = 16384;  // 2n at n = 8192, the largest bucket

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

// Keys of record r (records 0..n-1 are debit sides, n..2n-1 credit sides).
__device__ __forceinline__ int32_t rec_slot_key(const In& in, int r) {
  int e = r < in.n ? r : r - in.n;
  bool pv = (in.flags[e] & (F_POST | F_VOID)) != 0;
  int32_t s = r < in.n ? (pv ? in.p_dr_slot[e] : in.dr_slot[e])
                       : (pv ? in.p_cr_slot[e] : in.cr_slot[e]);
  return s >= 0 ? s : (int32_t)in.a;
}

__device__ __forceinline__ int32_t f_group_key(const In& in, int e) {
  bool pv = (in.flags[e] & (F_POST | F_VOID)) != 0;
  return pv ? in.group[e] : in.n;
}

// key kind: 0 slot (records), 1 chain, 2 index, 3 fulfillment group.
__device__ __forceinline__ uint32_t key_of(const In& in, int kind, int x) {
  int32_t k;
  if (kind == 0) k = rec_slot_key(in, x);
  else if (kind == 1) k = in.chain_id[x < in.n ? x : x - in.n];
  else if (kind == 2) k = x < in.n ? x : x - in.n;
  else k = f_group_key(in, x);
  return (uint32_t)k ^ 0x80000000u;  // signed order as unsigned order
}

struct Smem {
  int* cur;
  int* nxt;
  int* hist;  // [kBins][kThreads]
};

__shared__ int s_warp[32];
__shared__ unsigned s_red[2];

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
    int w = lane < (kThreads >> 5) ? s_warp[lane] : 0;
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

// Block-wide exclusive running maximum (identity 0).
__device__ int block_excl_max(int v) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (kThreads >> 5) ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w = max(w, y);
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int before = warp ? s_warp[warp - 1] : 0;
  // Exclusive within the warp: the inclusive value of the lane before.
  int prev = __shfl_up_sync(0xFFFFFFFFu, x, 1);
  if (lane == 0) prev = 0;
  __syncthreads();
  return max(before, prev);
}

// One stable sort of sm.cur[0..m) (element ids) by key `kind`, all digits
// the keys use, least significant first.
__device__ void radix_by(const In& in, Smem& sm, int m, int kind) {
  int t = threadIdx.x;
  int chunk = (m + kThreads - 1) / kThreads;
  int lo = min(t * chunk, m), hi = min(lo + chunk, m);
  // Key range over the block: min and max of the unsigned keys.
  unsigned kmin = 0xFFFFFFFFu, kmax = 0;
  for (int i = lo; i < hi; ++i) {
    unsigned k = key_of(in, kind, sm.cur[i]);
    kmin = min(kmin, k);
    kmax = max(kmax, k);
  }
  if (t == 0) {
    s_red[0] = 0xFFFFFFFFu;
    s_red[1] = 0;
  }
  __syncthreads();
  atomicMin(&s_red[0], kmin);
  atomicMax(&s_red[1], kmax);
  __syncthreads();
  unsigned base = s_red[0];
  unsigned span = s_red[1] - base;
  __syncthreads();
  int bits = m ? 32 - __clz(span) : 0;
  for (int shift = 0; shift < bits; shift += 4) {
    int cnt[kBins];
#pragma unroll
    for (int b = 0; b < kBins; ++b) cnt[b] = 0;
    for (int i = lo; i < hi; ++i) {
      unsigned d = ((key_of(in, kind, sm.cur[i]) - base) >> shift) & (kBins - 1);
#pragma unroll
      for (int b = 0; b < kBins; ++b) cnt[b] += (d == (unsigned)b);
    }
#pragma unroll
    for (int b = 0; b < kBins; ++b) sm.hist[b * kThreads + t] = cnt[b];
    __syncthreads();
    // Exclusive scan of hist in (digit, thread) order: thread t owns the
    // kBins consecutive entries [t * kBins, (t + 1) * kBins).
    int local[kBins];
    int run = 0;
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      local[j] = run;
      run += sm.hist[t * kBins + j];
    }
    int off = block_excl_sum(run);
#pragma unroll
    for (int j = 0; j < kBins; ++j) sm.hist[t * kBins + j] = off + local[j];
    __syncthreads();
    int pos[kBins];
#pragma unroll
    for (int b = 0; b < kBins; ++b) pos[b] = sm.hist[b * kThreads + t];
    for (int i = lo; i < hi; ++i) {
      int x = sm.cur[i];
      unsigned d = ((key_of(in, kind, x) - base) >> shift) & (kBins - 1);
      int p = 0;
#pragma unroll
      for (int b = 0; b < kBins; ++b) {
        if (d == (unsigned)b) p = pos[b]++;
      }
      sm.nxt[p] = x;
    }
    __syncthreads();
    int* tmp = sm.cur;
    sm.cur = sm.nxt;
    sm.nxt = tmp;
  }
}

// perm/inv_perm and the head positions of the sorted order in sm.cur:
// a segment starts where key `seg_kind` changes, a sub-segment also where
// the chain of the element changes.
__device__ void heads(const In& in, const Smem& sm, int m, int seg_kind,
                      int32_t* perm, int32_t* inv_perm, int32_t* head_pos,
                      int32_t* sub_head_pos) {
  int t = threadIdx.x;
  int chunk = (m + kThreads - 1) / kThreads;
  int lo = min(t * chunk, m), hi = min(lo + chunk, m);
  int last_head = 0, last_sub = 0;
  for (int i = lo; i < hi; ++i) {
    int x = sm.cur[i];
    perm[i] = x;
    inv_perm[x] = i;
    if (i == 0) continue;
    int y = sm.cur[i - 1];
    bool seg = key_of(in, seg_kind, x) != key_of(in, seg_kind, y);
    bool sub = seg || key_of(in, 1, x) != key_of(in, 1, y);
    if (seg) last_head = i;
    if (sub) last_sub = i;
  }
  int head_in = block_excl_max(last_head);
  int sub_in = block_excl_max(last_sub);
  int h = head_in, s = sub_in;
  for (int i = lo; i < hi; ++i) {
    if (i > 0) {
      int x = sm.cur[i], y = sm.cur[i - 1];
      bool seg = key_of(in, seg_kind, x) != key_of(in, seg_kind, y);
      bool sub = seg || key_of(in, 1, x) != key_of(in, 1, y);
      if (seg) h = i;
      if (sub) s = i;
    }
    head_pos[i] = h;
    sub_head_pos[i] = s;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    sort_plan(In in, Out out) {
  extern __shared__ int smem[];
  int m = blockIdx.x == 0 ? 2 * in.n : in.n;
  Smem sm{smem, smem + kMaxElems, smem + 2 * kMaxElems};
  for (int i = threadIdx.x; i < m; i += kThreads) sm.cur[i] = i;
  __syncthreads();
  if (blockIdx.x == 0) {
    // (slot, chain, idx), stable on the record order: least significant
    // key first.
    radix_by(in, sm, m, 2);
    radix_by(in, sm, m, 1);
    radix_by(in, sm, m, 0);
    heads(in, sm, m, 0, out.perm, out.inv_perm, out.head_pos,
          out.sub_head_pos);
  } else {
    // (group, idx): the events start in index order.
    radix_by(in, sm, m, 3);
    heads(in, sm, m, 3, out.f_perm, out.f_inv_perm, out.f_head_pos,
          out.f_sub_head_pos);
  }
}

}  // namespace

// ptrs: flags, dr_slot, cr_slot, p_dr_slot, p_cr_slot, chain_id, group,
// then the eight outputs in SortPlan order. dims: a, n.
extern "C" int tb_exact_sort_plan(void* const* ptrs, const long long* dims,
                                  void* stream) {
  long long a = dims[0], n = dims[1];
  if (n < 1 || 2 * n > kMaxElems) return (int)cudaErrorInvalidValue;
  In in{(const uint32_t*)ptrs[0], (const int32_t*)ptrs[1],
        (const int32_t*)ptrs[2], (const int32_t*)ptrs[3],
        (const int32_t*)ptrs[4], (const int32_t*)ptrs[5],
        (const int32_t*)ptrs[6], a, (int)n};
  Out out{(int32_t*)ptrs[7],  (int32_t*)ptrs[8],  (int32_t*)ptrs[9],
          (int32_t*)ptrs[10], (int32_t*)ptrs[11], (int32_t*)ptrs[12],
          (int32_t*)ptrs[13], (int32_t*)ptrs[14]};
  size_t smem = (size_t)(2 * kMaxElems + kBins * kThreads) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sort_plan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sort_plan<<<2, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(in,
                                                                        out);
  return (int)cudaGetLastError();
}
