// query_index_keys_sorted: one batch's composite-key block, built and
// stably sorted on the card in one launch.
//
// Replaces the reference package's ops/qindex.py query_index_keys_sorted
// (the entry at :136: `_build_blocks` at :106, then `jax.lax.sort` at
// :143): the five-tag key build of query_index_keys.cu, then a stable sort
// of the 5n key rows by (pad, lo1, lo0), carrying the payload. ops/qindex.py
// query_index_keys_sorted_plain is the same function in PyTorch.
//
// What bounds it on this card: latency. The staged columns are 52 bytes a
// record in, the sorted block 5n rows of 24 bytes out (about 1.4 MB in all
// at n = 8192); what costs is the chain of dependent radix passes inside
// each tag block.
//
// Design. The build is fused into the sort's load: each CTA computes its
// tag block's (lo0, lo1) of its 1024 records in registers from the staged
// columns (qindex_fold.cuh, the key build's own arithmetic), one record a
// lane, consecutive records in consecutive lanes, and the final store
// takes the payload (ts0, ts1, row) from ts and rows at the record's
// index. No key or payload block is written between. Tag block b stands
// at rows [b n, (b + 1) n) of the natural order, and a real
// row's lo1 carries its block's tag (5, 6, 7, 9, 10: ascending) in its top
// byte, since the fold leaves lo1 below 2^24. So among the rows of any one
// pad word, block b sorts wholly before block b + 1, and the global stable
// sort is a stable sort of each tag block by (pad, lo1, lo0), then, for
// each pad word in order, its rows of blocks 0..4. A pad word is the same
// for a record in every block, so every block has the same count c of rows
// of pad word v and the same count l of rows below it: block b's row at
// sorted place p (of pad word v) goes to p + 4 l + b c.
//   - One cluster of eight CTAs sorts one tag block (40 SMs in all), 1024
//     rows a CTA, four a thread, warp-striped, in registers.
//   - One 64-bit key a row, its row index (16 bits) beside it. The tag byte
//     is constant in a block, so (lo1, lo0) minus the block's least key
//     spans at most 56 bits; when the block's pad words span fewer than 256
//     values (always, on the 0/1 staging), the pad word's rank above the
//     least sits just above those bits, and one LSD radix sort of 8-bit
//     digits over the bits the composite spans (a min/max reduction over
//     the cluster) orders by (pad, key): at most eight passes (seven key
//     bytes and the pad bit), none on a constant column. A wider pad span
//     sorts the key bits, then the pad word's (any 32-bit word).
//   - A pass: each warp ranks its keys among the lanes of equal digit by
//     eight ballots (the wide blocks' digits are nearly all distinct) into
//     a per-warp histogram; the CTA's per-digit counts go to shared memory;
//     one cluster barrier; each CTA reads the eight CTAs' counts through
//     distributed shared memory, scans them (one block scan over the 256
//     digits) and stores each key and row index straight into the shared
//     memory of the CTA that owns its new place; a second cluster barrier.
//   - Placement: the count and the rows below of each pad rank come from
//     one histogram of the pad words (256 ranks), not a search a row; the
//     key words are rebuilt from the composite, so a row reads only its
//     payload. The wide path finds its pad word's bounds by binary search
//     over the sorted pad words in the cluster's shared memory.
//
// The wrapper refuses n > 8192 (the largest bucket of a batch of at most
// 8190 events).
#include <cooperative_groups.h>

#include "common.cuh"
#include "qindex_fold.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                  // CTAs a tag block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                    // rows a thread
constexpr int kSlice = kThreads * kItems;    // 1024 rows a CTA
constexpr int kMaxRows = kCluster * kSlice;  // 8192
constexpr int kBins = 256;                   // 8-bit digits
static_assert(kThreads == kBins, "one digit a thread in the scans");

struct Shared {
  unsigned long long key[kSlice];  // the exchange: composite keys
  uint16_t row[kSlice];            // and their row indices
  uint32_t padw[kSlice];           // wide pads: the sorted pad words
  int whist[kWarps][kBins];        // per-warp digit counts, then offsets
  int cnt[kBins];                  // this CTA's digit counts (the cluster reads them)
  int off[kBins];
  int padcnt[kBins];               // pad-rank counts of this CTA's records (likewise)
  int below[kBins], pcnt[kBins];   // rows below each pad rank, rows of it
  unsigned long long range[4];     // key min, max, pad min, max (likewise)
  unsigned long long wred[kWarps][4];
  int wsum[kWarps];
};

// Cluster barrier halves (not .aligned: a warp may arrive diverged).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Block-wide exclusive sum; every thread passes one value.
__device__ int block_excl_sum(Shared& sm, int v) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sm.wsum[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += sm.wsum[w];
  __syncthreads();
  return before + x - v;
}

// The lanes whose digit equals this lane's, from eight ballots.
__device__ __forceinline__ unsigned match_by_ballots(unsigned d) {
  unsigned peers = 0xFFFFFFFFu;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    unsigned on = __ballot_sync(0xFFFFFFFFu, (d >> bit) & 1);
    peers &= ((d >> bit) & 1) ? on : ~on;
  }
  return peers;
}

// One stable pass of the cluster's rows by their digits d (rows past n
// carry digit 255 and stay last).
__device__ void radix_pass(Shared& sm, const cg::cluster_group& cluster, int rank,
                           unsigned long long (&key)[kItems], int (&row)[kItems],
                           const unsigned (&d)[kItems]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1;
  int* wh = sm.whist[warp];
  for (int b = lane; b < kBins; b += 32) wh[b] = 0;
  __syncwarp();
  int rk[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    unsigned peers = match_by_ballots(d[i]);
    int before = __popc(peers & lt);
    int c = wh[d[i]];
    rk[i] = c + before;
    __syncwarp();
    if (before == 0) wh[d[i]] = c + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int run = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    int c = sm.whist[w][t];
    sm.whist[w][t] = run;
    run += c;
  }
  sm.cnt[t] = run;
  // Every CTA's counts are in place, and every CTA has taken its rows out
  // of the last exchange.
  cluster_sync();
  int tot = 0, mine = 0;
#pragma unroll
  for (int c = 0; c < kCluster; ++c) {
    int v = cluster.map_shared_rank(sm.cnt, c)[t];
    tot += v;
    mine += c < rank ? v : 0;
  }
  sm.off[t] = block_excl_sum(sm, tot) + mine;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int pos = sm.off[d[i]] + wh[d[i]] + rk[i];
    unsigned owner = (unsigned)pos / kSlice;
    int at = pos % kSlice;
    cluster.map_shared_rank(sm.key, owner)[at] = key[i];
    cluster.map_shared_rank(sm.row, owner)[at] = (uint16_t)row[i];
  }
  cluster_sync();
  const int q0 = warp * 32 * kItems + lane;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    key[i] = sm.key[q0 + i * 32];
    row[i] = sm.row[q0 + i * 32];
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    sort_blocks(const uint32_t* __restrict__ cols, const uint32_t* __restrict__ ts,
                const uint32_t* __restrict__ rows, const uint32_t* __restrict__ pad,
                uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_pay, int n) {
  __shared__ Shared sm;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blk = blockIdx.x / kCluster;  // the tag block
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // Item i of lane l of warp w holds the row at place
  // rank * 1024 + w * 128 + i * 32 + l of the block (its sorted place
  // after the passes; its row index before them).
  const int p0 = rank * kSlice + warp * 32 * kItems + lane;

  sm.padcnt[t] = 0;
  unsigned long long key[kItems];
  int row[kItems];
  uint32_t pw[kItems];
  unsigned long long kmin = ~0ull, kmax = 0, pmin = ~0ull, pmax = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int p = p0 + i * 32;
    row[i] = p;
    key[i] = 0;
    pw[i] = 0;
    if (p < n) {
      uint32_t lo0, lo1;
      tb::block_key(cols + 9ll * p, blk, lo0, lo1);
      key[i] = ((unsigned long long)lo1 << 32) | lo0;
      pw[i] = pad[p];
      kmin = min(kmin, key[i]);
      kmax = max(kmax, key[i]);
      pmin = min(pmin, (unsigned long long)pw[i]);
      pmax = max(pmax, (unsigned long long)pw[i]);
    }
  }
  for (int o = 16; o; o >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xFFFFFFFFu, kmin, o));
    kmax = max(kmax, __shfl_xor_sync(0xFFFFFFFFu, kmax, o));
    pmin = min(pmin, __shfl_xor_sync(0xFFFFFFFFu, pmin, o));
    pmax = max(pmax, __shfl_xor_sync(0xFFFFFFFFu, pmax, o));
  }
  if (lane == 0) {
    sm.wred[warp][0] = kmin;
    sm.wred[warp][1] = kmax;
    sm.wred[warp][2] = pmin;
    sm.wred[warp][3] = pmax;
  }
  __syncthreads();
  if (t < 4) {
    unsigned long long v = sm.wred[0][t];
    for (int w = 1; w < kWarps; ++w) v = (t & 1) ? max(v, sm.wred[w][t]) : min(v, sm.wred[w][t]);
    sm.range[t] = v;
  }
  cluster_sync();
  // The block's ranges: lane c of each warp reads CTA c's.
  {
    const unsigned long long* r = cluster.map_shared_rank(sm.range, lane % kCluster);
    kmin = r[0];
    kmax = r[1];
    pmin = r[2];
    pmax = r[3];
    for (int o = kCluster / 2; o; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xFFFFFFFFu, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(0xFFFFFFFFu, kmax, o));
      pmin = min(pmin, __shfl_xor_sync(0xFFFFFFFFu, pmin, o));
      pmax = max(pmax, __shfl_xor_sync(0xFFFFFFFFu, pmax, o));
    }
  }
  const unsigned long long kspan = kmax - kmin;
  const int kbits = kspan ? 64 - __clzll((long long)kspan) : 0;
  const unsigned pspan = (unsigned)(pmax - pmin);
  const int pbits = pspan ? 32 - __clz(pspan) : 0;
  // Narrow pads: the pad rank rides above the key bits of one composite.
  const bool narrow = pspan < kBins && kbits + pbits <= 64;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    key[i] -= kmin;
    if (narrow && pbits) key[i] |= (unsigned long long)(pw[i] - (uint32_t)pmin) << kbits;
  }
  if (narrow && pbits) {
    // The pad-rank histogram of this CTA's records (the cluster sums it
    // after the first pass's barrier).
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      bool valid = p0 + i * 32 < n;
      unsigned r = valid ? pw[i] - (uint32_t)pmin : ~0u;
      unsigned peers = __match_any_sync(0xFFFFFFFFu, r);
      if (valid && __popc(peers & ((1u << lane) - 1)) == 0) atomicAdd(&sm.padcnt[r], __popc(peers));
    }
  }

  const int kbits_total = narrow ? kbits + pbits : kbits;
  for (int shift = 0; shift < kbits_total; shift += 8) {
    unsigned d[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      d[i] = p0 + i * 32 < n ? (unsigned)(key[i] >> shift) & (kBins - 1) : kBins - 1;
    }
    radix_pass(sm, cluster, rank, key, row, d);
  }
  if (!narrow) {
    for (int shift = 0; shift < pbits; shift += 8) {
      unsigned d[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        d[i] = p0 + i * 32 < n ? ((__ldg(pad + row[i]) - (uint32_t)pmin) >> shift) & (kBins - 1)
                               : kBins - 1;
      }
      radix_pass(sm, cluster, rank, key, row, d);
    }
  }

  // The bounds of each row's pad word among the block's sorted rows.
  int below[kItems], count[kItems];
  uint32_t word[kItems];
  if (narrow) {
    if (pbits) {
      // Every CTA's pad counts were in place at the first pass's barrier
      // (pbits > 0 makes at least one pass).
      int tot = 0;
#pragma unroll
      for (int c = 0; c < kCluster; ++c) tot += cluster.map_shared_rank(sm.padcnt, c)[t];
      sm.below[t] = block_excl_sum(sm, tot);
      sm.pcnt[t] = tot;
      __syncthreads();
    }
    const unsigned long long kmask = kbits >= 64 ? ~0ull : (1ull << kbits) - 1;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      // (a row past n holds no composite: rank 0)
      unsigned r = pbits && p0 + i * 32 < n ? (unsigned)(key[i] >> kbits) : 0;
      below[i] = pbits ? sm.below[r] : 0;
      count[i] = pbits ? sm.pcnt[r] : n;
      word[i] = (uint32_t)pmin + r;
      key[i] = (key[i] & kmask) + kmin;
    }
  } else {
    const int q0 = warp * 32 * kItems + lane;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      word[i] = p0 + i * 32 < n ? __ldg(pad + row[i]) : ~0u;
      sm.padw[q0 + i * 32] = word[i];
    }
    cluster_sync();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      int p = p0 + i * 32;
      int lo = 0, hi = p < n ? p : 0;  // first place of the word
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        uint32_t w = cluster.map_shared_rank(sm.padw, mid / kSlice)[mid % kSlice];
        if (w < word[i]) lo = mid + 1; else hi = mid;
      }
      below[i] = lo;
      lo = p < n ? p + 1 : 0;  // one past its last
      hi = p < n ? n : 0;
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        uint32_t w = cluster.map_shared_rank(sm.padw, mid / kSlice)[mid % kSlice];
        if (w <= word[i]) lo = mid + 1; else hi = mid;
      }
      count[i] = lo - below[i];
      key[i] += kmin;
    }
  }
  // No CTA leaves while another may still read its shared memory.
  cluster_arrive();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int p = p0 + i * 32;
    if (p >= n) continue;
    long long dst = p + 4ll * below[i] + blk * count[i];
    int x = row[i];
    out_keys[dst * 3] = (uint32_t)key[i];
    out_keys[dst * 3 + 1] = (uint32_t)(key[i] >> 32);
    out_keys[dst * 3 + 2] = word[i];
    out_pay[dst * 3] = ts[2 * x];
    out_pay[dst * 3 + 1] = ts[2 * x + 1];
    out_pay[dst * 3 + 2] = rows[x];
  }
  cluster_wait();
}

}  // namespace

// cols (n, 9), ts (n, 2), rows (n,), pad (n,) as ops/qindex.py stages them
// -> out_keys, out_pay (5n, 3); all uint32, contiguous; 1 <= n <= 8192.
extern "C" int tb_query_index_keys_sorted(const void* cols, const void* ts,
                                          const void* rows, const void* pad,
                                          void* out_keys, void* out_pay, long long n,
                                          void* stream) {
  if (n < 1 || n > kMaxRows) return (int)cudaErrorInvalidValue;
  sort_blocks<<<tb::kTagBlocks * kCluster, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)cols, (const uint32_t*)ts, (const uint32_t*)rows, (const uint32_t*)pad,
      (uint32_t*)out_keys, (uint32_t*)out_pay, (int)n);
  return (int)cudaGetLastError();
}
