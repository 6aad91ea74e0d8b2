// query_index_keys_sorted: the stable sort of one batch's composite-key
// block, on the card.
//
// Replaces the sort of the reference package's ops/qindex.py
// query_index_keys_sorted (the entry at :136; `jax.lax.sort` at :143): a
// stable sort of the 5n key rows by (pad, lo1, lo0), carrying the payload.
// ops/qindex.py launches query_index_keys.cu first (the build), then this
// kernel on its output. ops/qindex.py query_index_keys_sorted_plain is the
// same function in PyTorch.
//
// What bounds it on this card: latency. The block is 5n rows of 24 bytes
// (about 1 MB at n = 8192), moved once in and once out; what costs is the
// chain of dependent radix passes inside each block.
//
// Design. The build puts tag block b at rows [b n, (b + 1) n), and a real
// row's lo1 carries its block's tag (5, 6, 7, 9, 10: ascending) in its top
// byte, since the fold leaves lo1 below 2^24. So among real rows (pad 0)
// block b sorts wholly before block b + 1, and likewise among pad rows
// (pad 1), and so among the rows of any one pad word; the global stable
// sort is therefore
//   1. a stable sort of each tag block by (lo1, lo0), then
//   2. a stable sort of each block by its whole pad word, and
//   3. for each pad word in order, its rows of blocks 0..4.
// One thread block of 1024 threads sorts one tag block (n <= 8192 rows) in
// shared memory: the 64-bit keys in their original order, and the row
// order, double-buffered. The sort is a stable LSD radix sort with 4-bit
// digits over the bits the block's keys actually span (a min/max
// reduction; a constant column takes no pass), then the passes over the
// bits the pad words span (one for the staged 0/1 flag). A pass: each
// thread counts the digits of its contiguous chunk, one block scan over
// the (digit, thread) counts gives each row its place, and each thread
// writes its chunk in order, so equal digits keep their order. A pad word
// is the same for a record in every block, so every block has the same
// count c of rows of pad word v and the same count l of rows below it:
// block b writes its rows of pad word v from 5 l + b c.
//
// The contract is the build's: lo1's top byte is the block's tag. The
// wrapper refuses n > 8192 (the largest bucket of a batch of at most 8190
// events).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kBins = 16;
constexpr int kMaxRows = 8192;
constexpr int kBlocks = 5;

__shared__ int s_warp[32];
__shared__ unsigned long long s_range[2];
__shared__ unsigned s_pad_range[2];

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

struct Smem {
  const unsigned long long* key;  // [n], original row order
  int* cur;                       // [n], the order so far
  int* nxt;
  int* hist;  // [kBins][kThreads]
};

// The digit of row x in one pass: bits [shift, shift + 4) of its key, or
// (on_pad) of its pad word, above the block's minimum `base`.
__device__ __forceinline__ unsigned digit_of(const Smem& sm,
                                             const uint32_t* pad, bool on_pad,
                                             unsigned long long base, int x,
                                             int shift) {
  unsigned long long v = on_pad ? pad[x] : sm.key[x];
  return (unsigned)((v - base) >> shift) & (kBins - 1);
}

// One stable pass over sm.cur[0..n) by the digit at `shift`.
__device__ void radix_pass(Smem& sm, const uint32_t* pad, bool on_pad,
                           unsigned long long base, int n, int shift) {
  int t = threadIdx.x;
  int chunk = (n + kThreads - 1) / kThreads;
  int lo = min(t * chunk, n), hi = min(lo + chunk, n);
  int cnt[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) cnt[b] = 0;
  for (int i = lo; i < hi; ++i) {
    unsigned d = digit_of(sm, pad, on_pad, base, sm.cur[i], shift);
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
    unsigned d = digit_of(sm, pad, on_pad, base, x, shift);
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

__global__ void __launch_bounds__(kThreads, 1)
    sort_blocks(const uint32_t* __restrict__ keys,
                const uint32_t* __restrict__ pay,
                const uint32_t* __restrict__ pad,
                uint32_t* __restrict__ out_keys,
                uint32_t* __restrict__ out_pay, int n) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;
  int* rows = reinterpret_cast<int*>(smem + kMaxRows);
  Smem sm{key, rows, rows + kMaxRows, rows + 2 * kMaxRows};
  int t = threadIdx.x;
  long long blk = blockIdx.x;
  const uint32_t* kb = keys + blk * n * 3;
  const uint32_t* pb = pay + blk * n * 3;
  if (t == 0) {
    s_range[0] = ~0ull;
    s_range[1] = 0;
    s_pad_range[0] = ~0u;
    s_pad_range[1] = 0;
  }
  __syncthreads();
  unsigned long long kmin = ~0ull, kmax = 0;
  unsigned pmin = ~0u, pmax = 0;
  for (int i = t; i < n; i += kThreads) {
    unsigned long long k = ((unsigned long long)kb[3 * i + 1] << 32) | kb[3 * i];
    key[i] = k;
    sm.cur[i] = i;
    kmin = min(kmin, k);
    kmax = max(kmax, k);
    pmin = min(pmin, pad[i]);
    pmax = max(pmax, pad[i]);
  }
  atomicMin(&s_range[0], kmin);
  atomicMax(&s_range[1], kmax);
  atomicMin(&s_pad_range[0], pmin);
  atomicMax(&s_pad_range[1], pmax);
  __syncthreads();
  unsigned long long base = s_range[0];
  unsigned long long span = s_range[1] - base;
  int bits = span ? 64 - __clzll((long long)span) : 0;
  for (int shift = 0; shift < bits; shift += 4) {
    radix_pass(sm, pad, false, base, n, shift);
  }
  unsigned pbase = s_pad_range[0];
  unsigned pspan = s_pad_range[1] - pbase;
  int pbits = pspan ? 32 - __clz(pspan) : 0;
  for (int shift = 0; shift < pbits; shift += 4) {
    radix_pass(sm, pad, true, pbase, n, shift);
  }
  // The pad words in sorted order (in the histogram's space): in every
  // block, `below` rows have a smaller pad word than v, a row's, and
  // end - below rows have v.
  uint32_t* sorted_pad = reinterpret_cast<uint32_t*>(sm.hist);
  for (int p = t; p < n; p += kThreads) sorted_pad[p] = pad[sm.cur[p]];
  __syncthreads();
  for (int p = t; p < n; p += kThreads) {
    int x = sm.cur[p];
    uint32_t v = sorted_pad[p];
    int below = p, end = p + 1;
    for (int lo = 0; lo < below;) {  // first place of v
      int mid = (lo + below) >> 1;
      if (sorted_pad[mid] < v) lo = mid + 1; else below = mid;
    }
    for (int hi = n; end < hi;) {  // one past its last
      int mid = (end + hi) >> 1;
      if (sorted_pad[mid] <= v) end = mid + 1; else hi = mid;
    }
    long long dst = (long long)kBlocks * below + blk * (end - below) + (p - below);
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      out_keys[dst * 3 + w] = kb[3 * x + w];
      out_pay[dst * 3 + w] = pb[3 * x + w];
    }
  }
}

}  // namespace

// keys, pay (5n, 3) as query_index_keys.cu writes them, pad (n,) ->
// out_keys, out_pay (5n, 3); all uint32, contiguous; 1 <= n <= 8192.
extern "C" int tb_query_index_keys_sorted(const void* keys, const void* pay,
                                          const void* pad, void* out_keys,
                                          void* out_pay, long long n,
                                          void* stream) {
  if (n < 1 || n > kMaxRows) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)kMaxRows * sizeof(unsigned long long) +
                (size_t)(2 * kMaxRows + kBins * kThreads) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sort_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sort_blocks<<<kBlocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const uint32_t*)keys, (const uint32_t*)pay, (const uint32_t*)pad,
      (uint32_t*)out_keys, (uint32_t*)out_pay, (int)n);
  return (int)cudaGetLastError();
}
