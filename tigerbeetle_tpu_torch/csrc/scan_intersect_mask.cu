// scan_intersect_mask: membership of sorted candidate rows in a sorted row
// run, on the card.
//
// Replaces the reference package's ops/scanops.py scan_intersect_mask
// (:38): mask[i] = cand[i] is in run, for ascending uint32 cand and run,
// both padded with 0xFFFFFFFF (a pad of cand meets a pad of run; callers
// cut the mask to their length). The reference tests run[min(lo, nr-1)]
// for the lower bound lo of each candidate, which is membership for any
// ascending run; this kernel tests membership. ops/scanops.py
// scan_intersect_mask_plain is the same function in PyTorch.
//
// What bounds it on this card: at the table's shape (2^17 candidates in a
// 2^20-row run) bytes, the two arrays read once and a byte a candidate
// written (4.85 MB); at the query path's shapes (256 to 8192 candidates
// in runs of 2^12 to 2^18 rows; the candidates an account's rows over all
// time, the run one time window's rows) the dependent loads of each
// search: a binary search takes log2(nr) of them, 12 to 20 round trips.
//
// Design: a block of T threads takes T consecutive candidates at a time
// (grid-stride, so any nc fits; T from nc so that a short list spreads
// over the SMs), in one of two kernels the entry picks from the shapes.
//   - Sparse (the query path's launches): the block stages a splitter
//     sample of the run in shared memory (every g-th row, 4 a thread, at
//     most kSample), in one round of loads; a candidate below run[0] is
//     out, one equal to its splitter is in, and the rest search the g - 1
//     rows after their splitter alone, by rounds of 3 independent probes
//     (4-way, half the round trips of a binary search), then one load.
//   - Dense (lists of full 512-candidate tiles with nc * kDense >= nr,
//     such as 2^17 in 2^20): a sample in every block would cost more than
//     it saves, each of hundreds of blocks loading the same lines. Both
//     arrays are sorted, so a tile meets the run only between the lower
//     bounds of its first and last candidate: two warps find those by
//     32-way rounds (31 probes a round trip, 4 round trips at 2^20); the
//     block stages that span with 16-byte loads issued together, each
//     run word read once, and every candidate searches it in shared
//     memory. A tile whose span does not fit searches it in global memory.
// Words compare as unsigned 32-bit values, so rows >= 2^31 order as rows.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;      // a tile's candidates, at most
constexpr int kSamplesPerThread = 4;  // splitters a thread stages (sparse)
constexpr int kSample = 1024;         // splitters a block holds, at most
constexpr int kQuads = 4;             // 16-byte run loads a thread stages (dense)
constexpr int kDense = 8;             // dense: nc * kDense >= nr, and full tiles
constexpr int kWays = 4;              // a candidate's search: kWays - 1 probes a round
constexpr int kSMs = 132;             // H100 SXM

// The lower bound of `c` in the ascending run[a, end): rounds of kWays - 1
// independent probes (clamped into the interval; a probe past it counts
// as not below c), each cutting the interval kWays-fold.
__device__ __forceinline__ long long lower_bound(const uint32_t* __restrict__ run, long long a,
                                                 long long end, uint32_t c) {
  long long b = end;
  while (a < b) {
    const long long w = (b - a + kWays - 1) / kWays;
    int k = 0;
#pragma unroll
    for (int q = 1; q < kWays; ++q) {
      const long long p = a + q * w - 1;
      const uint32_t v = __ldg(run + (p < b ? p : b - 1));
      k += (p < b) & (v < c);
    }
    a += k * w;
    b = a + w < b ? a + w : b;
    if (w == 1) break;
  }
  return a;
}

// The sparse kernel: the block stages every g-th row (the splitters, g a
// power of two) in shared memory; each candidate finds the last splitter
// <= it there, and searches the rows up to the next splitter alone.
__global__ void __launch_bounds__(kMaxThreads)
intersect_sparse(const uint32_t* __restrict__ cand, const uint32_t* __restrict__ run,
                 uint8_t* __restrict__ mask, long long nc, long long nr, long long g,
                 int splitters) {
  __shared__ uint32_t sample[kSample];
  const int t = threadIdx.x, T = blockDim.x;
#pragma unroll
  for (int u = 0; u < kSamplesPerThread; ++u) {
    const int q = t + u * T;
    if (q < splitters) sample[q] = __ldg(run + q * g);
  }
  __syncthreads();
  const uint32_t first = sample[0];
  for (long long i = (long long)blockIdx.x * T + t; i < nc; i += (long long)gridDim.x * T) {
    const uint32_t c = __ldg(cand + i);
    bool hit = false;
    if (c >= first) {
      int lo = 0, hi = splitters;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (sample[mid] <= c) lo = mid; else hi = mid;
      }
      hit = sample[lo] == c;
      if (!hit) {  // the rows after the splitter, up to the next one
        const long long end = (lo + 1) * g < nr ? (lo + 1) * g : nr;
        const long long a = lower_bound(run, lo * g + 1, end, c);
        hit = a < end && __ldg(run + a) == c;
      }
    }
    mask[i] = hit;
  }
}

// The dense kernel (blocks of kMaxThreads): tiles of T consecutive
// candidates; the rows a tile can meet lie between the lower bounds of
// its first and last candidate, which warps 0 and 1 find by rounds of 31
// probes. Where that span fits in 4 kQuads words a thread, the block
// stages it and every candidate searches it in shared memory; else each
// searches it in global memory.
__global__ void __launch_bounds__(kMaxThreads)
intersect_dense(const uint32_t* __restrict__ cand, const uint32_t* __restrict__ run,
                uint8_t* __restrict__ mask, long long nc, long long nr) {
  extern __shared__ __align__(16) uint32_t span[];  // 4 kQuads T words
  __shared__ long long bounds[2];
  const int t = threadIdx.x, T = blockDim.x;
  const long long tiles = (nc + T - 1) / T;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long i = tile * T + t;
    const bool valid = i < nc;
    const uint32_t c = valid ? __ldg(cand + i) : 0;
    if (t < 64) {
      // Warp 0: the lower bound of the tile's first candidate; warp 1: of
      // its last. It lies in [a, a + 32^r); a round keeps the chunk of
      // 32^(r - 1) rows that holds it.
      const int warp = t >> 5, q = t & 31;
      const long long at = warp ? (tile * T + T < nc ? tile * T + T : nc) - 1 : tile * T;
      const uint32_t e = __ldg(cand + at);
      int shift = 0;
      while ((1ll << shift) < nr) shift += 5;
      long long a = 0;
      while (shift > 0) {
        shift -= 5;
        const long long w = 1ll << shift;
        const long long p = a + q * w - 1;
        const bool below = q > 0 && p < nr && __ldg(run + p) < e;
        a += __popc(__ballot_sync(0xffffffffu, below)) * w;
      }
      if (q == 0) bounds[warp] = a;  // exact, or nr - 1 past the last row
    }
    __syncthreads();
    const long long lo = bounds[0];
    const long long hi = bounds[1] + 1 < nr ? bounds[1] + 1 : nr;
    const long long from = lo & ~3ll;  // 16-byte aligned
    bool hit = false;
    if (hi - from <= 4 * kQuads * T) {
      // Stage run[from, hi), kQuads 16-byte loads a thread issued together.
      const int n = (int)(hi - from);
      uint4 v[kQuads];
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const int q = 4 * (t + u * T);
        if (q + 4 <= n) v[u] = __ldg(reinterpret_cast<const uint4*>(run + from + q));
      }
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const int q = 4 * (t + u * T);
        if (q + 4 <= n) {
          *reinterpret_cast<uint4*>(span + q) = v[u];
        } else {
          for (int r = q; r < n; ++r) span[r] = __ldg(run + from + r);
        }
      }
      __syncthreads();
      if (valid) {
        int a = (int)(lo - from), b = n;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (span[mid] < c) a = mid + 1; else b = mid;
        }
        hit = a < n && span[a] == c;
      }
    } else if (valid) {
      const long long a = lower_bound(run, lo, hi, c);
      hit = a < hi && __ldg(run + a) == c;
    }
    if (valid) mask[i] = hit;
    __syncthreads();  // span and bounds are free for the next tile
  }
}

}  // namespace

// cand (nc,), run (nr,) uint32, 16-byte aligned -> mask (nc,) bool (one
// byte each); nc, nr >= 1.
extern "C" int tb_scan_intersect_mask(const void* cand, const void* run, void* mask,
                                      long long nc, long long nr, void* stream) {
  if (nc < 1 || nr < 1) return (int)cudaErrorInvalidValue;
  int threads = 32;
  while (threads < kMaxThreads && (long long)threads * kSMs < nc) threads *= 2;
  const long long tiles = (nc + threads - 1) / threads;
  const unsigned grid = (unsigned)(tiles < 2 * kSMs ? tiles : 2 * kSMs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Dense tiles stage their span; elsewhere a sample in every block is
  // cheaper, but not once hundreds of full blocks load the same splitters.
  if (threads == kMaxThreads && nc * kDense >= nr) {
    const size_t smem = sizeof(uint32_t) * 4 * kQuads * threads;
    intersect_dense<<<grid, threads, smem, s>>>((const uint32_t*)cand, (const uint32_t*)run,
                                                (uint8_t*)mask, nc, nr);
  } else {
    const int sample = threads * kSamplesPerThread < kSample ? threads * kSamplesPerThread : kSample;
    long long g = 1;
    while (g * sample < nr) g *= 2;
    intersect_sparse<<<grid, threads, 0, s>>>((const uint32_t*)cand, (const uint32_t*)run,
                                              (uint8_t*)mask, nc, nr, g, (int)((nr + g - 1) / g));
  }
  return (int)cudaGetLastError();
}
