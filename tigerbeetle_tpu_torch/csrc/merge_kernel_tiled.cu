// merge_kernel_tiled: the stable merge of two sorted device runs, on the
// card.
//
// Replaces the reference package's ops/merge.py merge_kernel_tiled (:104):
// keys (n, 3) and (m, 3) uint32 [lo0, lo1, pad], compared as unsigned
// words with the most significant word last, each run sorted; payloads
// (n, 3) and (m, 3) ride along. The output is the (n + m)-row merge, and at
// equal keys every row of A comes before every row of B (the flush passes
// the older run as A). ops/merge.py merge_kernel_tiled_plain is the same
// function in PyTorch.
//
// What bounds it on this card: bytes. Each input row is read once and each
// output row written once, 24 bytes a row: at the flush's 81,920-163,840
// rows 3.9-7.9 MB, about 2 µs. At that size every block runs its phases
// at once with every other, so each phase's round trips to L2 (four
// co-rank rounds, the span copies, the stores) add up in its time more
// than the bytes do (PERF.md §6, slice 8).
//
// Design: one block of kThreads threads per kTile-row output tile (the
// merge is unique, so the tile is the kernel's own; the wrapper's `tile`
// argument only states the callers' padding).
//   1. Co-ranks: warp 0 finds how many rows of A the outputs before the
//      tile take, warp 1 how many the outputs before its end take, each by
//      a warp-wide search of 32 probes a round (ballots, no block barrier)
//      whose last round probes up to 64 places whole: 3 rounds of global
//      loads for the flush's 40,961 places.
//   2. The tile's A span and B span are contiguous word ranges of the
//      keys and of the payloads. Their whole 16-byte chunks go to shared
//      memory by four TMA bulk copies, issued by one thread and completing
//      on one mbarrier; the words of the partial chunks at each end (a span
//      starts at 12 a0 bytes) by plain loads beside them. Each span keeps
//      its offset in its 16-byte chunk, so row j of a span is at word
//      shift + 3 j.
//   3. Each thread merges kRows consecutive outputs: a merge-path search
//      in shared memory for its start (a fixed number of steps, each one
//      load of two keys and a branch-free compare), then kRows serial
//      steps with both heads in registers, each loading the taken row's
//      payload and the next key of its side. kRows is odd, so the 3 kRows
//      word strides of a warp's rows fall in distinct banks.
//   4. The output tile is staged in the same shared memory and stored as
//      flat 16-byte vectors (a tile starts at 12 kTile d0 bytes, a
//      multiple of 16); payloads are never gathered from global memory.
// The kernel is launched as a programmatic dependent of the kernel before
// it on the stream (the flush folds its runs by merges back to back): its
// blocks are scheduled while that kernel finishes and wait for it
// (griddepcontrol.wait) before they touch memory.
// The last tile may be partial; either run may be empty.
#include "common.cuh"
#include "merge_path.cuh"

namespace {

using tb::merge_path::a_taken_warp;
using tb::merge_path::bulk_bytes;
using tb::merge_path::bulk_span;
using tb::merge_path::edge_word;
using tb::merge_path::key_le_words;
using tb::merge_path::smem_addr;
using tb::merge_path::store_tile;
using tb::merge_path::wait_phase0;

constexpr int kThreads = 128;
constexpr int kRows = 3;  // outputs a thread: odd (see 3. above)
constexpr int kTile = kThreads * kRows;
// Words of one staging buffer: both spans (kTile rows), each shifted by
// up to 3 words in its chunk, B's start rounded up to a chunk.
constexpr int kSpanWords = 3 * kTile + 12;
static_assert(kRows % 2 == 1, "kRows must be odd");
static_assert(kTile % 4 == 0, "a tile must start on a 16-byte boundary");

// The largest power of two <= kTile: the first step of a search.
constexpr int top_step(int n) { return n < 2 ? 1 : 2 * top_step(n / 2); }
constexpr int kTopStep = top_step(kTile);

__global__ void __launch_bounds__(kThreads)
merge_tiles(const uint32_t* __restrict__ ka, const uint32_t* __restrict__ pa,
            const uint32_t* __restrict__ kb, const uint32_t* __restrict__ pb,
            uint32_t* __restrict__ ok, uint32_t* __restrict__ op, long long n,
            long long m) {
  __shared__ __align__(16) uint32_t s_key[kSpanWords];
  __shared__ __align__(16) uint32_t s_pay[kSpanWords];
  __shared__ long long s_split[2];
  __shared__ uint64_t s_bar;  // the spans' bulk copies
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const unsigned bar = smem_addr(&s_bar);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const long long d0 = (long long)blockIdx.x * kTile;
  const long long d1 = d0 + kTile < n + m ? d0 + kTile : n + m;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // 1. The tile's co-ranks, one warp each.
  if (warp < 2) {
    long long a = a_taken_warp(ka, n, kb, m, warp ? d1 : d0, lane);
    if (lane == 0) s_split[warp] = a;
  }
  __syncthreads();
  const long long a0 = s_split[0], b0 = d0 - a0;
  const int rows = (int)(d1 - d0);
  const int na = (int)(s_split[1] - a0), nb = rows - na;

  // 2. Both spans, keys and payloads, to shared memory.
  const int sa = (int)((3 * a0) & 3), sb = (int)((3 * b0) & 3);
  const int bbase = (sa + 3 * na + 3) & ~3;
  // Thread 0 issues the bulk copies, threads 0-23 copy the edge words,
  // and every thread waits for the mbarrier's first phase.
  const long long wa0 = 3 * a0, wa1 = 3 * (a0 + na), wb0 = 3 * b0, wb1 = 3 * (b0 + nb);
  if (t == 0) {
    const long long bytes = 2 * (bulk_bytes(wa0, wa1) + bulk_bytes(wb0, wb1));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"((unsigned)bytes)
                 : "memory");
    bulk_span(s_key, ka, wa0, wa1, bar);
    bulk_span(s_pay, pa, wa0, wa1, bar);
    bulk_span(s_key + bbase, kb, wb0, wb1, bar);
    bulk_span(s_pay + bbase, pb, wb0, wb1, bar);
  }
  if (t < 24) {  // six edge slots a span
    const int k = t % 6;
    switch (t / 6) {
      case 0: edge_word(s_key, ka, wa0, wa1, k); break;
      case 1: edge_word(s_pay, pa, wa0, wa1, k); break;
      case 2: edge_word(s_key + bbase, kb, wb0, wb1, k); break;
      default: edge_word(s_pay + bbase, pb, wb0, wb1, k); break;
    }
  }
  wait_phase0(bar);
  __syncthreads();  // the spans are in shared memory

  // 3. This thread's kRows outputs, from output row `diag` of the tile:
  // how many of A's rows the outputs before it take (the least c in
  // [lo, hi] with A[c] > B[diag - c - 1]), then the merge.
  const uint32_t* A = s_key + sa;
  const uint32_t* B = s_key + bbase + sb;
  const int diag = t * kRows < rows ? t * kRows : rows;
  const int lo = diag - nb > 0 ? diag - nb : 0;
  const int hi = diag < na ? diag : na;
  int c = lo;
#pragma unroll
  for (int step = kTopStep; step > 0; step >>= 1) {
    if (c + step <= hi) {
      const uint32_t* x = A + 3 * (c + step - 1);
      const uint32_t* y = B + 3 * (diag - c - step);
      if (key_le_words(x[0], x[1], x[2], y[0], y[1], y[2])) c += step;
    }
  }
  int i = c, j = diag - c;
  // Both heads in registers (a side's last row stands in past its end).
  const int ia = sa + 3 * (i < na ? i : na - 1), jb = bbase + sb + 3 * (j < nb ? j : nb - 1);
  uint32_t ha[3], hb[3], rk[kRows][3], rp[kRows][3];
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    ha[w] = na ? s_key[ia + w] : 0u;
    hb[w] = nb ? s_key[jb + w] : 0u;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (diag + r < rows) {
      const bool take_a =
          j >= nb || (i < na && key_le_words(ha[0], ha[1], ha[2], hb[0], hb[1], hb[2]));
      const int at = take_a ? sa + 3 * i : bbase + sb + 3 * j;
      if (take_a) ++i; else ++j;
      const int next = take_a ? sa + 3 * (i < na ? i : na - 1)
                              : bbase + sb + 3 * (j < nb ? j : nb - 1);
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        rk[r][w] = take_a ? ha[w] : hb[w];
        rp[r][w] = s_pay[at + w];
        const uint32_t nk = s_key[next + w];
        ha[w] = take_a ? nk : ha[w];
        hb[w] = take_a ? hb[w] : nk;
      }
    }
  }
  __syncthreads();  // every span row read: the buffers take the output

  // 4. Stage the tile and store it.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (diag + r < rows) {
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        s_key[3 * (diag + r) + w] = rk[r][w];
        s_pay[3 * (diag + r) + w] = rp[r][w];
      }
    }
  }
  __syncthreads();
  store_tile(ok + 3 * d0, s_key, 3 * rows, kThreads);
  store_tile(op + 3 * d0, s_pay, 3 * rows, kThreads);
}

}  // namespace

// ka, pa (n, 3), kb, pb (m, 3) -> ok, op (n + m, 3); all uint32,
// contiguous, 16-byte aligned; 1 <= tile <= 1024 and tile divides n + m
// (the callers' padding; the kernel's own tile is kTile rows).
extern "C" int tb_merge_kernel_tiled(const void* ka, const void* pa,
                                     const void* kb, const void* pb, void* ok,
                                     void* op, long long n, long long m,
                                     long long tile, void* stream) {
  if (tile < 1 || tile > 1024 || n < 0 || m < 0 || (n + m) % tile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  long long tiles = (n + m + kTile - 1) / kTile;
  if (tiles == 0) return (int)cudaSuccess;
  if (tiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute chained[1];
  chained[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  chained[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = chained;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, merge_tiles, (const uint32_t*)ka, (const uint32_t*)pa, (const uint32_t*)kb,
      (const uint32_t*)pb, (uint32_t*)ok, (uint32_t*)op, n, m);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
